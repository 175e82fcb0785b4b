"""Twin of tests/test_sharding.py: the port's row-sharded ELL SpMV
(``manifold_gp_torch.parallel.spmv``), its ring schedule, and the sharded
Matérn operator with a sharded CG solve, at world sizes 2 and 4 (gloo
processes on the CPU, ``_torch_mesh_worker``), held to JAX's single-device
functions at the JAX test's tolerances and to the port on one process at
1e-5 relative.

``test_training_step_under_mesh`` (JAX's probe-axis sharding of a
single-device model) waits for the port's probe-axis item (ROADMAP,
"Sharded kNN and probe-axis sharding"); ``test_graft_dryrun_multichip``
tests the JAX package's ``__graft_entry__.py`` and has no twin."""

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh_worker as W
from _torch_data import one_torch_thread, small_cloud  # noqa: F401
from manifold_gp_tpu.ops.cg import cg_solve
from manifold_gp_tpu.ops.graph import build_graph
from manifold_gp_tpu.ops.laplacian import adjacency_matvec_ell, laplacian_coeffs
from manifold_gp_tpu.ops.matern import make_matern_precision_matvec

WORLD_SIZES = (2, 4)
EPS, NU, LS = 0.35, 2, 1.3


def _problems():
    x, _ = small_cloud()
    graph = build_graph(x, 6)
    rng = np.random.default_rng(2024)
    v = rng.standard_normal((graph.num_nodes, 4)).astype(np.float32)
    edges = (np.array(graph.rows), np.array(graph.cols), np.array(graph.sqdist),
             graph.num_nodes)
    return dict(edges=edges, n=graph.num_nodes, v=v), graph


def _jax_references(inp, graph):
    """JAX on one device: the adjacency and Matérn products and a CG solve."""
    c = laplacian_coeffs(graph, EPS)
    v = jnp.asarray(inp["v"])
    ref_mv = make_matern_precision_matvec(graph, c, NU, LS, "randomwalk")
    return dict(adj=np.asarray(adjacency_matvec_ell(graph, c.triu, v)),
                mv=np.asarray(ref_mv(v)),
                sol=np.asarray(cg_solve(ref_mv, v, tol=1e-8, max_iter=400)))


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
    return [("sharded_spmv", dict(edges=inp["edges"], eps=EPS, v=inp["v"])),
            ("matern_cg", dict(edges=inp["edges"], eps=EPS, nu=NU, ls=LS, v=inp["v"]))]


@pytest.fixture(scope="module")
def runs(inputs, worlds):
    from manifold_gp_torch.parallel import make_mesh

    single = make_mesh(device="cpu")
    out = {1: [[W.SCENARIOS[name](single, **kw) for name, kw in _scenarios(inputs)]]}
    out.update(worlds.result())
    return out


def _rows(ranks, idx, key, part=0):
    return np.concatenate([r[idx][key][part] if part is not None else r[idx][key]
                           for r in ranks])


def _close_to_single(got, single, what):
    scale = np.abs(single).max()
    assert np.abs(got[:single.shape[0]] - single).max() <= 1e-5 * scale, what


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_sharded_spmv_matches_single_device(inputs, runs, ws):
    n = inputs["n"]
    out = _rows(runs[ws], 0, "gather")
    np.testing.assert_allclose(out[:n], inputs["adj"], rtol=1e-4, atol=1e-5)
    _close_to_single(out[:n], runs[1][0][0]["gather"][0][:n], "gather")


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_ring_spmv_matches_gather(inputs, runs, ws):
    """The ring schedule (shards passed round the ranks with
    batch_isend_irecv) vs the all-gather schedule and the single-device
    ELL matvec, forward and the VJPs (edge values, operand); and the rule
    that engages it above the gather budget."""
    from manifold_gp_torch.parallel import spmv as spmv_mod

    n = inputs["n"]
    ring = _rows(runs[ws], 0, "ring")
    np.testing.assert_allclose(ring[:n], inputs["adj"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ring, _rows(runs[ws], 0, "gather"), rtol=1e-5, atol=1e-6)
    for part in (1, 2):  # the edge-value and operand cotangents
        np.testing.assert_allclose(
            np.concatenate([r[0]["ring"][part][None] if part == 1 else r[0]["ring"][part]
                            for r in runs[ws]]),
            np.concatenate([r[0]["gather"][part][None] if part == 1 else r[0]["gather"][part]
                            for r in runs[ws]]),
            rtol=1e-5, atol=1e-5)
    n_pad = runs[ws][0][0]["n_pad"]
    assert n_pad * 4 * 4 <= spmv_mod._OPERAND_GATHER_BUDGET  # this test: gather
    big = spmv_mod._OPERAND_GATHER_BUDGET // (4 * n_pad) + 1
    assert n_pad * big * 4 > spmv_mod._OPERAND_GATHER_BUDGET  # would ring


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_sharded_matern_precision_matches_dense_oracle(inputs, runs, ws):
    """The row-sharded Matérn operator and a sharded CG solve (all-reduced
    dot products) match JAX's single-device operator and CG."""
    n = inputs["n"]
    mv = _rows(runs[ws], 1, "mv", part=None)
    np.testing.assert_allclose(mv[:n], inputs["mv"], rtol=1e-4, atol=1e-5)
    _close_to_single(mv[:n], runs[1][0][1]["mv"][:n], "matvec")
    sol = _rows(runs[ws], 1, "sol", part=None)
    np.testing.assert_allclose(sol[:n], inputs["sol"], rtol=1e-3, atol=1e-4)
