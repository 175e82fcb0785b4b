"""The port's small helper modules against the JAX package's on the same
inputs: ``utils.debug`` (the non-finite guard, the trainer's debug path,
the memory reports), ``utils.io``, ``utils.mesh.load_mesh`` (a .msh and an
ASCII .stl written here), ``utils.roofline`` (byte and FLOP models on the
same block-ELL and DIA layouts; the card's bounds) and ``utils.plotting``
(behind matplotlib)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data import one_torch_thread, small_cloud  # noqa: F401
from manifold_gp_tpu.utils import debug as jdebug
from manifold_gp_tpu.utils import io as jio
from manifold_gp_tpu.utils import mesh as jmesh
from manifold_gp_tpu.utils import roofline as jroof
from manifold_gp_torch.utils import debug, io, mesh, roofline


def test_check_finite_names_the_leaf_as_jax_does():
    tree = {"a": torch.ones(3), "b": [torch.zeros(2), torch.tensor([1.0, float("nan")])],
            "c": torch.tensor([1, 2])}
    jtree = {"a": jnp.ones(3), "b": [jnp.zeros(2), jnp.asarray([1.0, float("nan")])],
             "c": jnp.asarray([1, 2])}
    with pytest.raises(FloatingPointError) as got:
        debug.check_finite(tree, name="params")
    with pytest.raises(FloatingPointError) as want:
        jdebug.check_finite(jtree, name="params")
    assert str(got.value) == str(want.value) == "non-finite values in params: [\"['b'][1]\"]"
    debug.check_finite({"a": torch.ones(2), "n": np.ones(3), "i": torch.tensor([3])})
    with pytest.raises(FloatingPointError, match=r"\['x'\]"):
        debug.check_finite({"x": np.array([np.inf])})


def test_trainer_debug_path_raises_on_a_non_finite_loss():
    """``manifold_informed_train(debug=True)`` stops at the first epoch
    whose loss is not finite (labels poisoned with a NaN), as JAX's."""
    from manifold_gp_torch import InferenceConfig, RiemannGP, RiemannMaternKernel
    from manifold_gp_torch.utils import manifold_informed_train

    x, y = small_cloud()
    y = y.copy()
    y[3] = np.nan
    kernel = RiemannMaternKernel(nu=1, x=x, nearest_neighbors=6,
                                 laplacian_normalization="randomwalk", num_modes=10,
                                 cfg=InferenceConfig(), device="cpu")
    model = RiemannGP(x, y, kernel, cfg=InferenceConfig())
    params = model.init_params(noise=1e-2, outputscale=1.0, graphbandwidth=0.35,
                               lengthscale=1.0)
    with pytest.raises(FloatingPointError, match="non-finite training loss nan at epoch 0"):
        manifold_informed_train(model, params, lr=1e-1, max_iter=3, debug=True)


def test_memory_reports():
    marker = torch.zeros((123, 7))
    report = debug.live_arrays_report(top=10_000)
    assert report.splitlines()[0].endswith("MiB total")
    assert "(123, 7) cpu" in report
    stats = debug.device_memory_stats()
    assert isinstance(stats, dict)
    if not torch.cuda.is_available():
        assert stats == {}
    del marker


def test_io_matches_jax(capsys):
    assert io.green("x") == jio.green("x") and io.red("y") == jio.red("y")
    assert io.passfail(True, "a") == jio.passfail(True, "a")
    assert io.passfail(False, "b") == jio.passfail(False, "b")
    a = np.arange(12.0).reshape(3, 4) / 7
    io.print_mat(a, "m", decimals=3)
    got = capsys.readouterr().out
    jio.print_mat(a, "m", decimals=3)
    assert got == capsys.readouterr().out


# a closed 4-node chain in the section layout the parsers read (node: id
# x y z; line element: id type tags... n1 n2)
MSH = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
1 0.0 0.0 0
2 1.0 0.0 0
3 1.0 1.0 0
4 0.0 1.0 0
$EndNodes
$Elements
1 1 2 0 1 1 2
2 1 2 0 1 2 3
3 1 2 0 1 3 4
4 1 2 0 1 4 1
$EndElements
"""


def _ascii_stl():
    tris = [((0, 0, 0), (1, 0, 0), (0, 1, 0)), ((1, 0, 0), (1, 1, 0), (0, 1, 0)),
            ((0, 0, 0), (0, 1, 0), (0, 0, 1))]
    # both parsers take the first 80 bytes for the header: the solid line
    # fills them
    lines = ["solid test".ljust(79)]
    for tri in tris:
        lines += ["facet normal 0 0 1", "outer loop"]
        lines += [f"vertex {a} {b} {c}" for a, b, c in tri]
        lines += ["endloop", "endfacet"]
    return "\n".join(lines + ["endsolid test"]) + "\n"


@pytest.mark.parametrize("suffix", [".msh", ".stl"])
def test_load_mesh_matches_jax(tmp_path, suffix):
    path = tmp_path / f"mesh{suffix}"
    path.write_text(MSH if suffix == ".msh" else _ascii_stl())
    got = mesh.load_mesh(str(path))
    want = jmesh.load_mesh(str(path))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # 4 nodes and 4 edges; 5 distinct vertices of 3 triangles
    assert got[0].shape[0] == (4 if suffix == ".msh" else 5)
    assert got[1].shape[0] == (4 if suffix == ".msh" else 3)


def test_load_mesh_raises_as_jax_for_other_formats(tmp_path):
    path = tmp_path / "mesh.obj"
    path.write_text("v 0 0 0\n")
    try:
        import trimesh  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError) as got:
            mesh.load_mesh(str(path))
        with pytest.raises(ImportError) as want:
            jmesh.load_mesh(str(path))
        assert str(got.value) == str(want.value)
        with pytest.raises(ImportError, match="reduce_mesh requires trimesh"):
            mesh.reduce_mesh(str(path))


@pytest.fixture(scope="module")
def layouts():
    """The same graph's block-ELL and DIA layouts in both packages."""
    from manifold_gp_torch.ops import block_sparse, dia
    from manifold_gp_torch.ops.graph import graph_from_edges
    from manifold_gp_tpu.ops import block_sparse as jbs
    from manifold_gp_tpu.ops import dia as jdia
    from manifold_gp_tpu.ops.graph import build_graph

    t = np.linspace(0, 2 * np.pi, 3000, endpoint=False)
    x = np.stack([np.cos(t), np.sin(t)], 1).astype(np.float32)
    jg = build_graph(x, 8)
    g = graph_from_edges(np.asarray(jg.rows), np.asarray(jg.cols), np.asarray(jg.sqdist),
                         jg.num_nodes, device="cpu")
    return ((block_sparse.build_block_layout(g), jbs.build_block_layout(jg)),
            (dia.build_dia_layout(g, max_offsets=128), jdia.build_dia_layout(jg, max_offsets=128)))


@pytest.mark.parametrize("fmt, streaming", [("block", False), ("block", True), ("dia", True)])
def test_roofline_counts_match_jax(layouts, fmt, streaming):
    """Bytes of an apply and of a CG iteration, FLOPs, and the rate fields
    (no peaks off the card in either package) on the same layouts. (JAX's
    DIA model has one schedule, the windowed operand; the port's default
    reads the operand once.)"""
    lay, jlay = layouts[0] if fmt == "block" else layouts[1]
    assert roofline.normalize_spec(lay) == jroof.normalize_spec(jlay)
    for batch, ob, bb in ((1, 4, 4), (48, 4, 2), (125, 2, 2)):
        kw = dict(operand_dtype_bytes=ob, buf_dtype_bytes=bb, streaming=streaming,
                  packed_band=True)
        got, want = roofline.matvec_bytes(lay, batch, **kw), jroof.matvec_bytes(jlay, batch, **kw)
        for key in ("format", "operator", "operand", "output", "total"):
            assert got[key] == want[key], (key, got[key], want[key])
        assert roofline.cg_iter_bytes(lay, batch, 2, jacobi=True, **kw) == \
            jroof.cg_iter_bytes(jlay, batch, 2, jacobi=True, **kw)
        assert roofline.block_matvec_flops(lay, batch) == jroof.block_matvec_flops(jlay, batch)
        assert roofline.roofline_fields(lay, batch, 2, 1e6, **kw) == \
            jroof.roofline_fields(jlay, batch, 2, 1e6, device=_cpu(), **kw)
    if fmt == "block":
        assert got["index"] == lay.num_row_blocks * lay.max_blocks * 4


def _cpu():
    import jax

    return jax.devices("cpu")[0]


def test_roofline_bounds_are_the_kernel_table_bounds():
    """The card's bounds of PERF.md's kernel table (H100 SXM: 3.35 TB/s,
    67 TFLOP/s f32, 989 TFLOP/s bf16) at the 262k torus's block layout
    (2,032 row blocks, S = 22) and the curve's DIA layout (Npd = 261,120,
    D = 21); None off the card."""
    name = "NVIDIA H100 80GB HBM3"
    torus = {"format": "block", "nrb": 2032, "s_max": 22, "num_padded": 2032 * 128}
    curve = {"format": "dia", "num_padded": 261_120, "num_offsets": 21, "halfwidth": 10}

    def fwd(batch, panel_bytes, passes=1):
        mv = roofline.matvec_bytes(torus, batch, buf_dtype_bytes=panel_bytes)
        return roofline.bound_ms(mv["total"] + mv["index"],
                                 roofline.matvec_flops(torus, batch, passes),
                                 4 if panel_bytes == 4 and passes == 1 else 2, name)

    def bwd(batch, out_bytes):
        return roofline.bound_ms(
            roofline.bwd_blocks_bytes(torus, batch, out_dtype_bytes=out_bytes)["total"],
            roofline.block_matvec_flops(torus, batch), out_bytes, name)

    def k4(batch):
        return roofline.bound_ms(roofline.matvec_bytes(curve, batch)["total"],
                                 roofline.matvec_flops(curve, batch), 4, name)

    table = [(fwd(125, 4), 2.733, "operations"), (fwd(100, 4), 2.186, "operations"),
             (fwd(300, 4), 6.559, "operations"), (fwd(1, 2), 0.438, "bytes"),
             (fwd(48, 2), 0.467, "bytes"), (fwd(100, 2), 0.499, "bytes"),
             (fwd(125, 2), 0.515, "bytes"), (fwd(48, 4, 3), 0.904, "bytes"),
             (fwd(125, 4, 3), 0.952, "bytes"), (bwd(1, 4), 0.875, "bytes"),
             (bwd(100, 4), 2.186, "operations"), (bwd(48, 2), 0.467, "bytes"),
             (bwd(1, 2), 0.438, "bytes"), (bwd(100, 2), 0.499, "bytes"),
             (k4(128), 0.086, "bytes"), (k4(100), 0.069, "bytes"), (k4(1), 0.007, "bytes")]
    for (ms, by), want_ms, want_by in table:
        assert (round(ms, 3), by) == (want_ms, want_by)
    assert roofline.card_peaks("NVIDIA H100 PCIe")[0] == "H100 PCIe"
    assert roofline.card_peaks("Tesla T4") is None
    assert roofline.hbm_peak_bytes_per_s(name) == 3.35e12
    if not torch.cuda.is_available():
        assert roofline.bound_ms(1.0, 1.0) is None and roofline.hbm_peak_bytes_per_s() is None


def test_plotting_matches_jax():
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from manifold_gp_torch.utils import plotting
    from manifold_gp_tpu.utils import plotting as jplot

    xs = np.linspace(0, 1, 7)
    for name, args in (("colormap_diverging", ("RdBu", -1.0, 3.0)),
                       ("colormap_left", ("viridis",)), ("colormap_right", ("viridis",))):
        got = getattr(plotting, name)(*args, res=64)
        want = getattr(jplot, name)(*args, res=64)
        np.testing.assert_array_equal(got(xs), want(xs))
    t = np.linspace(0, 2 * np.pi, 20, endpoint=False)
    vertices = np.stack([np.cos(t), np.sin(t)], 1)
    edges = np.stack([np.arange(20), (np.arange(20) + 1) % 20], 1)
    fig, ax = plt.subplots()
    line = plotting.plot_1D_mesh(fig, ax, vertices, edges, torch.arange(20.0))
    np.testing.assert_array_equal(line.get_array(), np.arange(20.0))
    im = ax.imshow(np.eye(3))
    plotting.colorbar(im, fig, ax)
    plotting.beautify(fig, ax)
    plt.close(fig)
