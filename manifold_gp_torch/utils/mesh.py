"""Mesh loading / decimation (port of ``manifold_gp_tpu.utils.mesh``;
reference ``utils/mesh_helper.py:5-26``).

``load_mesh`` reads .msh (2.2) and .stl (binary or ASCII) with the
package's own parsers (``utils.datasets``), and other formats through
trimesh when it is installed; ``reduce_mesh`` (quadric decimation) needs
trimesh and raises a clear error without it. trimesh is imported only
where it is needed.
"""

from __future__ import annotations

import os

import numpy as np


def load_mesh(mesh_file: str):
    """Returns (vertices [V, 3], faces [F, k]) for .msh / .stl meshes."""
    ext = os.path.splitext(mesh_file)[1].lower()
    if ext == ".msh":
        from .datasets import parse_msh

        nodes, elements = parse_msh(mesh_file)
        return np.asarray(nodes), np.asarray(elements)
    if ext == ".stl":
        from .datasets import parse_stl

        return parse_stl(mesh_file)
    try:
        import trimesh
    except ImportError as e:
        raise ImportError(
            f"loading {ext} meshes requires trimesh (not installed); "
            ".msh and .stl are supported natively"
        ) from e
    mesh = trimesh.load(mesh_file)
    return np.asarray(mesh.vertices), np.asarray(mesh.faces)


def reduce_mesh(mesh_file: str, target_faces: int = 10000, out_file: str = None):
    """Quadric decimation to ~target_faces (reference reduce_mesh)."""
    try:
        import trimesh
    except ImportError as e:
        raise ImportError("reduce_mesh requires trimesh (not installed)") from e
    mesh = trimesh.load(mesh_file)
    mesh = mesh.simplify_quadric_decimation(target_faces)
    if out_file:
        mesh.export(out_file)
    return np.asarray(mesh.vertices), np.asarray(mesh.faces)
