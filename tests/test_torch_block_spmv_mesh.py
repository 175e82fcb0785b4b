"""Twin of tests/test_block_spmv_mesh.py: the port's row-sharded fused
block-ELL SpMV (``manifold_gp_torch.parallel.block_spmv``) at world sizes 2
and 4, one gloo process per rank on the CPU (``_torch_mesh_worker``).

Each world size spawns once for the file and runs every scenario; each test
reads its part. The port's mesh is held to JAX's single-chip fused path at
the JAX test's tolerances (JAX's own test holds JAX's mesh to the same
single-chip path), its tables to JAX's mesh tables of the same world size,
element for element, and to the port's single-device results (a mesh of one
process) at 1e-5 relative. The JAX test's ``impl`` parametrisation
(einsum / Pallas interpret) has one CPU route here: the device alone picks
the kernel or its plain version, and CPU tensors take the plain one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh_worker as W
from _torch_data import one_torch_thread  # noqa: F401
from manifold_gp_tpu.ops import block_sparse as jbs
from manifold_gp_tpu.ops.graph import build_graph
from manifold_gp_tpu.ops.laplacian import laplacian_coeffs
from manifold_gp_tpu.ops.matern import make_matern_precision_matvec
from manifold_gp_tpu.parallel import make_mesh
from manifold_gp_tpu.parallel.block_spmv import build_mesh_block_tables

WORLD_SIZES = (2, 4)
HALO_SEEDS = (0, 1, 2, 3, 4)
EPS, EPS_Q, LS_Q, NU = 0.5, 0.45, 1.2, 2


def _edges(graph):
    return (np.array(graph.rows), np.array(graph.cols), np.array(graph.sqdist),
            graph.num_nodes)


def _problems():
    """The JAX test's clustered 900-point problem and banded circle, drawn
    from generators of their own, with JAX's graphs and block layout."""
    rng = np.random.default_rng(1337)
    centers = rng.standard_normal((4, 8)).astype(np.float32) * 3
    x = centers[rng.integers(0, 4, 900)] + 0.2 * rng.standard_normal((900, 8)).astype(np.float32)
    graph = build_graph(x, 8)
    layout = jbs.build_block_layout(graph)
    assert layout is not None
    n = graph.num_nodes
    v = rng.standard_normal((n, 4)).astype(np.float32)
    rows = -(-layout.num_row_blocks // 4) * 4 * 128  # the widest padding of the world sizes
    cot = rng.standard_normal((rows, 4)).astype(np.float32)
    vq = rng.standard_normal((n, 1)).astype(np.float32)
    t = np.sort(np.random.default_rng(7).uniform(0, 2 * np.pi, 2048))
    xc = np.stack([np.cos(t), np.sin(t)], 1).astype(np.float32)
    xc += 0.005 * np.random.default_rng(8).standard_normal(xc.shape).astype(np.float32)
    circle = build_graph(xc, 6)
    return (dict(edges=_edges(graph), circle=_edges(circle), v=v, cot=cot, vq=vq,
                 layout=layout), graph, circle)


def _jax_references(inp, graph, circle):
    """JAX's single-chip fused matvec, its VJPs and the Matérn quadratic
    form's gradients, and JAX's mesh tables at each world size."""
    layout, v, cot, vq = inp["layout"], inp["v"], inp["cot"], inp["vq"]
    coeffs = laplacian_coeffs(graph, EPS)
    nrows0 = layout.num_padded
    blocks = jbs.assemble(layout, coeffs.diag, coeffs.triu)
    pv = jbs.permute_in(layout, jnp.asarray(v))
    out = jbs.matvec_permuted(layout, blocks, pv)
    g_blocks, g_pv = jax.grad(
        lambda b, p: jnp.sum(jbs.matvec_permuted(layout, b, p) * jnp.asarray(cot[:nrows0])),
        argnums=(0, 1))(blocks, pv)

    def quad(eps, ls):
        c = laplacian_coeffs(graph, eps)
        mv = make_matern_precision_matvec(graph, c, NU, ls, "randomwalk",
                                          block=(layout, None), permuted_io=False, pallas=False)
        return jnp.sum(jnp.asarray(vq) * mv(jnp.asarray(vq)))

    args = (jnp.float32(EPS_Q), jnp.float32(LS_Q))
    q_val = float(quad(*args))
    q_grad = [float(g) for g in jax.grad(quad, argnums=(0, 1))(*args)]
    jax_tables = {}
    for ws in WORLD_SIZES:
        mesh = make_mesh(ws)
        jax_tables[ws] = {name: build_mesh_block_tables(g, mesh) for name, g in
                          (("cloud", graph), ("circle", circle))}
    return dict(blocks=np.asarray(blocks), out=np.asarray(out),
                g_blocks=np.asarray(g_blocks), g_pv=np.asarray(g_pv),
                q_val=q_val, q_grad=q_grad, jax_tables=jax_tables)


@pytest.fixture(scope="module")
def problems():
    return _problems()


@pytest.fixture(scope="module")
def worlds(problems, tmp_path_factory):
    """The rank processes of both world sizes, started on the problems
    (a future of ``run_worlds``' result)."""
    return W.run_worlds_async(WORLD_SIZES, _scenarios(problems[0]),
                              tmp_path_factory.mktemp("mesh"), together=True)


@pytest.fixture(scope="module")
def inputs(problems, worlds):
    """The problems and JAX's references, computed while the ranks run."""
    return dict(problems[0], **_jax_references(*problems))


def _scenarios(inp):
    return [
        ("tables", dict(edges=inp["edges"])),
        ("tables", dict(edges=inp["circle"])),
        ("block_matvec", dict(edges=inp["edges"], eps=EPS, v=inp["v"], cot=inp["cot"])),
        ("halo_vs_gather", dict(edges=inp["circle"], eps=0.35, seeds=HALO_SEEDS)),
        ("fused_matern", dict(edges=inp["edges"], v=inp["vq"], eps=EPS_Q, ls=LS_Q, nu=NU)),
    ]


@pytest.fixture(scope="module")
def runs(inputs, worlds):
    """[ws] -> [rank] -> [scenario] results; ws = 1 is the port on one
    process with no group (the single-device reference)."""
    from manifold_gp_torch.parallel import make_mesh as port_mesh

    out = {}
    single = port_mesh(device="cpu")
    out[1] = [[W.SCENARIOS[name](single, **kw) for name, kw in _scenarios(inputs)]]
    out.update(worlds.result())
    return out


def _stack(ranks, idx, key):
    return np.concatenate([r[idx][key] for r in ranks])


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_mesh_block_tables_match_jax(inputs, runs, ws):
    """The port's MeshBlockTables (assembly tables, halo, row_of_node) equal
    JAX's for the same graph and world size, on every rank."""
    for idx, name in ((0, "cloud"), (1, "circle")):
        jt = inputs["jax_tables"][ws][name]
        for rank, res in enumerate(runs[ws]):
            got = res[idx]
            assert got["halo"] == jt.halo, (name, rank)
            assert got["rows"] == jt.rows and got["nrb"] == jt.nrb
            assert got["row_lo"] == rank * jt.rows // ws
            for key, want in (("block_col", jt.block_col), ("edge_sel", jt.edge_sel),
                              ("edge_pos", jt.edge_pos), ("diag_sel", jt.diag_sel),
                              ("diag_pos", jt.diag_pos), ("row_of_node", jt.row_of_node_np)):
                np.testing.assert_array_equal(got[key], np.asarray(want), err_msg=(name, key))


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_assemble_sharded_matches_single_chip(inputs, runs, ws):
    nrb0 = inputs["layout"].num_row_blocks
    got = _stack(runs[ws], 2, "blocks")
    single = runs[1][0][2]["blocks"]
    np.testing.assert_array_equal(got[:single.shape[0]], single)
    np.testing.assert_allclose(got[:nrb0], inputs["blocks"], rtol=1e-6, atol=1e-6)
    assert np.all(got[nrb0:] == 0.0), "padding row blocks must stay zero"


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_sharded_matvec_matches_single_chip(inputs, runs, ws):
    """Forward and both VJPs of the sharded fused matvec vs JAX's
    single-chip path (2e-5) and the port on one process (1e-5 relative)."""
    nrows0 = inputs["layout"].num_padded
    nrb0 = inputs["layout"].num_row_blocks
    single = runs[1][0][2]
    for key, want, rows in (("out", inputs["out"], nrows0),
                            ("g_blocks", inputs["g_blocks"], nrb0),
                            ("g_pv", inputs["g_pv"], nrows0)):
        got = _stack(runs[ws], 2, key)
        np.testing.assert_allclose(got[:rows], want, atol=2e-5, err_msg=key)
        mine = single[key]
        scale = np.abs(mine).max()
        assert np.abs(got[:mine.shape[0]] - mine).max() <= 1e-5 * scale, key
    assert np.all(_stack(runs[ws], 2, "out")[nrows0:] == 0.0)


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_halo_exchange_matches_gather(runs, ws):
    """Banded circle: the layout admits a small halo, and the halo exchange
    (an all_gather of the boundary slices) equals the whole-operand gather,
    forward and both VJPs, over several seeds in one spawn."""
    for res in runs[ws]:
        halo = res[3]
        assert halo["halo"] is not None and halo["halo"] <= 2, halo["halo"]
        assert halo["exchange"] == "halo"
        assert len(halo["diffs"]) == len(HALO_SEEDS)
        for diffs in halo["diffs"]:
            assert max(diffs) <= 1e-5, diffs


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_sharded_fused_matern_matches_single_chip_and_scan(inputs, runs, ws):
    """The fused mesh Matérn operator == JAX's single-chip fused block path
    == the port's scan path, values and gradients w.r.t. graphbandwidth and
    lengthscale; every rank returns the same numbers."""
    q = [res[4] for res in runs[ws]]
    assert all(r == q[0] for r in q), "ranks disagree"
    fused, scan = q[0]["fused"], q[0]["scan"]
    np.testing.assert_allclose(fused[0], inputs["q_val"], rtol=1e-5)
    np.testing.assert_allclose(fused[0], scan[0], rtol=1e-5)
    np.testing.assert_allclose(fused[1:], inputs["q_grad"], rtol=1e-4)
    single = runs[1][0][4]["fused"]
    np.testing.assert_allclose(fused, single, rtol=1e-5)
