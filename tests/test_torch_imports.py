"""The port stands alone: it imports neither JAX nor the JAX package (nor
scikit-learn, which the card's machine lacks), it exports the JAX package's
public names, its CUDA wrapper reaches the plain version only for CPU
tensors, and asking for CUDA without a card raises instead of running on
the CPU."""

import ast
import dataclasses
import importlib
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import manifold_gp_tpu.config as jconfig
import manifold_gp_torch as tmgp
from manifold_gp_torch.config import InferenceConfig, resolve_device
from manifold_gp_torch.ops import cuda_spmv

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "manifold_gp_tpu", "sklearn")
EXAMPLES = ("run_large", "run_spiral", "run_rmnist", "run_1d", "run_2d", "eval_pretrained",
            "reference_protocol", "profile_gradient")


def test_import_leaves_no_jax_in_sys_modules():
    """Every module of the port (and the example) imports with no JAX, no
    JAX package and no triton behind it, and importing builds or loads no
    kernel."""
    code = (
        "import importlib, pathlib, pkgutil, sys, manifold_gp_torch\n"
        "build = pathlib.Path(manifold_gp_torch.__file__).parent / 'build'\n"
        "before = sorted(build.glob('*')) if build.exists() else None\n"
        "names = [m.name for m in pkgutil.walk_packages(manifold_gp_torch.__path__, "
        "'manifold_gp_torch.')]\n"
        "for name in names + ['examples_torch.' + e for e in %r]: importlib.import_module(name)\n"
        "need = {'manifold_gp_torch.ops.' + m for m in ('matern', 'cg', 'slq', 'engine', "
        "'pivchol', 'operator', 'dia', 'sparse_formats')} | {'manifold_gp_torch.priors', "
        "'manifold_gp_torch.utils.train', 'manifold_gp_torch.utils.checkpoint'}\n"
        "assert need <= set(names), need - set(names)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "from manifold_gp_torch.ops import cuda_spmv, dia\n"
        "assert cuda_spmv._lib is None and cuda_spmv.build_log == ''\n"
        "assert dia.dia_launch_count == 0\n"
        "after = sorted(build.glob('*')) if build.exists() else None\n"
        "assert before == after, (before, after)\n"
        "print(bad); sys.exit(1 if bad else 0)" % (EXAMPLES, FORBIDDEN + ("triton",))
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


PORT_FILES = sorted(
    [ROOT / "chip_smoke.py", ROOT / "tests" / "_torch_mesh_worker.py"]
    + list((ROOT / "examples_torch").glob("*.py"))
    + list((ROOT / "manifold_gp_torch").rglob("*.py"))
)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_files_do_not_import_jax(path):
    assert path.exists()
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# JAX public names the port replaced by its own: name -> the port's names
REPLACED = {".utils": {"phase_timer": ("span", "count")}}


@pytest.mark.parametrize("module", ["", ".ops", ".kernels", ".models", ".utils", ".parallel"])
def test_port_exports_the_jax_public_names(module):
    """Every name of the JAX package's ``__all__`` (top level, ops, kernels,
    models, utils) is an attribute of the port's module, or was replaced by
    names the port exports (``REPLACED``: the host-clock ``phase_timer`` by
    the profiler-clock ``span`` and ``count``)."""
    jax_mod = importlib.import_module("manifold_gp_tpu" + module)
    port_mod = importlib.import_module("manifold_gp_torch" + module)
    replaced = REPLACED.get(module, {})
    missing = [n for n in jax_mod.__all__ if not hasattr(port_mod, n) and n not in replaced]
    assert not missing, missing
    for old, new in replaced.items():
        assert old in jax_mod.__all__ and not hasattr(port_mod, old)
        assert all(n in port_mod.__all__ and hasattr(port_mod, n) for n in new)
    assert not [n for n in port_mod.__all__ if not hasattr(port_mod, n)]


def test_parallel_sharded_searches_are_ported():
    """The JAX ``parallel.__all__``'s sharded kNN names are the port's own
    functions (``parallel.knn``), which run on a one-process mesh; every
    other name is the port's ``parallel.mesh`` / ``.spmv``."""
    import manifold_gp_tpu.parallel as jpar
    import manifold_gp_torch.parallel as tpar

    searches = ("build_graph_sharded", "sharded_ivf_search", "sharded_knn_search")
    mesh = tpar.make_mesh(device="cpu")
    x = np.random.default_rng(0).standard_normal((40, 2)).astype(np.float32)
    for name in searches:
        assert getattr(tpar, name).__module__ == "manifold_gp_torch.parallel.knn", name
    d, i = tpar.sharded_knn_search(x, x, 3, mesh, self_query=True)
    np.testing.assert_array_equal(i[:, 0].numpy(), np.arange(40))
    assert tpar.build_graph_sharded(x, 3, mesh).num_nodes == 40
    from manifold_gp_torch.ops.knn import ivf_build

    d2, i2 = tpar.sharded_ivf_search(ivf_build(torch.from_numpy(x), nlist=4), x, 3, mesh,
                                     nprobe=4, self_query=True)
    np.testing.assert_array_equal(i2.numpy(), i.numpy())
    for name in set(jpar.__all__) - set(searches):
        assert getattr(tpar, name).__module__ in ("manifold_gp_torch.parallel.mesh",
                                                  "manifold_gp_torch.parallel.spmv"), name


def test_cpu_wrapper_runs_plain_version_without_launching():
    rng = np.random.default_rng(0)
    blocks = torch.from_numpy(rng.standard_normal((2, 128, 256)).astype(np.float32))
    bc = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    pv = torch.from_numpy(rng.standard_normal((256, 3)).astype(np.float32))
    cuda_spmv.launch_count = 0
    out = cuda_spmv.resident_matvec_call(bc, blocks, pv, s_max=2)
    assert cuda_spmv.launch_count == 0
    cb = pv.reshape(2, 128, 3)[bc.long()].reshape(2, 256, 3)
    np.testing.assert_allclose(out.numpy(), torch.bmm(blocks, cb).reshape(256, 3).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_cpu_bwd_wrapper_runs_plain_version_without_launching():
    rng = np.random.default_rng(1)
    bc = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    g = torch.from_numpy(rng.standard_normal((256, 3)).astype(np.float32))
    pv = torch.from_numpy(rng.standard_normal((256, 3)).astype(np.float32))
    cuda_spmv.bwd_launch_count = 0
    out = cuda_spmv.bwd_blocks_call(bc, g, pv, s_max=2)
    assert cuda_spmv.bwd_launch_count == 0
    cb = pv.reshape(2, 128, 3)[bc.long()].reshape(2, 256, 3)
    want = torch.bmm(g.reshape(2, 128, 3), cb.transpose(1, 2))
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_loaders_default_to_the_card(monkeypatch, tmp_path):
    """Every entry point that makes tensors defaults to CUDA and raises
    without a card; the CPU must be asked for."""
    from manifold_gp_torch.utils import load_params, load_training_state, params_from_jax

    np.savez(tmp_path / "p.npz", raw_noise=np.float32(0.1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: load_params(tmp_path / "p.npz"),
                 lambda: load_training_state(tmp_path / "p.npz"),
                 lambda: params_from_jax({"raw_noise": np.float32(0.1)})):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert load_params(tmp_path / "p.npz", device="cpu")["raw_noise"].device.type == "cpu"


def test_graph_assembly_defaults_to_the_card(monkeypatch):
    """graph_from_edges and symmetrize_knn_edges, like every port entry
    point, default to CUDA and raise without a card (after their own
    edge-list checks); the CPU must be asked for."""
    from manifold_gp_torch.ops.graph import graph_from_edges, symmetrize_knn_edges

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sqd = np.array([[0.0, 1.0], [0.0, 1.0], [0.0, 4.0]], np.float32)
    idx = np.array([[0, 1], [1, 0], [2, 1]])
    for call in (lambda: graph_from_edges([0, 1], [1, 2], [1.0, 4.0], 3),
                 lambda: symmetrize_knn_edges(sqd, idx, 3)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="self-loop"):
        graph_from_edges([0, 1], [1, 1], [1.0, 1.0], 3)
    g = symmetrize_knn_edges(sqd, idx, 3, device="cpu")
    assert g.rows.device.type == "cpu" and g.rows.tolist() == [0, 1]


def test_kernel_library_hash_covers_every_source():
    names = sorted(p.name for p in cuda_spmv._SOURCES)
    assert names == sorted(p.name for p in (ROOT / "manifold_gp_torch" / "csrc").glob("*.cu"))
    assert all(p.exists() for p in cuda_spmv._SOURCES)


def test_kernel_library_hash_covers_headers(monkeypatch, tmp_path):
    """The library's name hashes every file of csrc/ (the .cu sources and
    the .cuh headers they include), so an edit to a header rebuilds."""
    csrc = ROOT / "manifold_gp_torch" / "csrc"
    want = sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")])
    assert cuda_spmv._hashed_sources() == want
    assert any(p.suffix == ".cuh" for p in want)
    for p in want:
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(cuda_spmv, "_CSRC", tmp_path)
    before = cuda_spmv._library_digest()
    header = next(tmp_path.glob("*.cuh"))
    header.write_text(header.read_text() + "\n")
    assert cuda_spmv._library_digest() != before


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    x = np.random.default_rng(0).standard_normal((50, 2)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmgp.RiemannMaternKernel(nu=2, x=x, nearest_neighbors=5)  # default device
    assert resolve_device("cpu").type == "cpu"


def test_spmv_kernel_cuda_needs_a_cuda_device():
    x = np.random.default_rng(0).standard_normal((50, 2)).astype(np.float32)
    with pytest.raises(ValueError, match="cuda"):
        tmgp.RiemannMaternKernel(nu=2, x=x, nearest_neighbors=5, device="cpu",
                                 cfg=InferenceConfig(spmv_kernel="cuda"))
    # the device alone picks the product: no value sends CUDA tensors to the
    # plain version
    for value in ("pallas", "torch"):
        with pytest.raises(ValueError, match="spmv_kernel"):
            InferenceConfig(spmv_kernel=value)


def test_config_fields_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.InferenceConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(InferenceConfig)}
    assert jf == tf  # every field, same defaults ("auto" SpMV kernel included)


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
