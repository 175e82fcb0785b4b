"""Twin of tests/test_sharding.py: the port's row-sharded ELL SpMV
(``manifold_gp_torch.parallel.spmv``), its ring schedule, and the sharded
Matérn operator with a sharded CG solve, at world sizes 2 and 4 (gloo
processes on the CPU, ``_torch_mesh_worker``), held to JAX's single-device
functions at the JAX test's tolerances and to the port on one process at
1e-5 relative; and ``test_training_step_under_mesh``: a single-device
model under ``use_mesh``, whose probe columns the port splits over the
ranks (JAX places them), held to JAX's loss and gradients and to the
port's unsplit run. ``test_graft_dryrun_multichip`` tests the JAX
package's ``__graft_entry__.py`` and has no twin."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh_worker as W
from _torch_data import one_torch_thread, small_cloud  # noqa: F401
from manifold_gp_tpu.ops.cg import cg_solve
from manifold_gp_tpu.ops.graph import build_graph
from manifold_gp_tpu.ops.laplacian import adjacency_matvec_ell, laplacian_coeffs
from manifold_gp_tpu.ops.matern import make_matern_precision_matvec
from manifold_gp_tpu.ops.slq import rademacher_probes

WORLD_SIZES = (2, 4)
EPS, NU, LS = 0.35, 2, 1.3
# tests/test_sharding.py::test_training_step_under_mesh's configuration
STEP_CFG = dict(max_cholesky=0, num_probes=16, lanczos_max_iter=30, cg_tolerance=1e-3,
                cg_max_iter=200, dense_operator_max_size=0)
UNSPLIT_PROBES = 6  # not divisible by 4: no split at world size 4


def _problems():
    x, y = small_cloud()
    graph = build_graph(x, 6)
    rng = np.random.default_rng(2024)
    v = rng.standard_normal((graph.num_nodes, 4)).astype(np.float32)
    edges = (np.array(graph.rows), np.array(graph.cols), np.array(graph.sqdist),
             graph.num_nodes)
    n = graph.num_nodes
    # JAX's engine.logdet draws its probes from the test's key as they are
    probes = np.asarray(rademacher_probes(jax.random.PRNGKey(0), n, STEP_CFG["num_probes"]))
    return dict(edges=edges, n=n, v=v, x=x, y=y, probes=probes,
                idx=rng.integers(0, n, 8)), graph


def _jax_references(inp, graph):
    """JAX on one device: the adjacency and Matérn products and a CG solve,
    and the JAX test's loss and gradients (probes from its key)."""
    from manifold_gp_tpu.config import InferenceConfig
    from manifold_gp_tpu.kernels import RiemannMaternKernel
    from manifold_gp_tpu.models import RiemannGP

    c = laplacian_coeffs(graph, EPS)
    v = jnp.asarray(inp["v"])
    ref_mv = make_matern_precision_matvec(graph, c, NU, LS, "randomwalk")
    cfg = InferenceConfig(**STEP_CFG)
    kernel = RiemannMaternKernel(nu=1, x=inp["x"], nearest_neighbors=6,
                                 laplacian_normalization="randomwalk", num_modes=10, cfg=cfg,
                                 graph=graph)
    model = RiemannGP(inp["x"], inp["y"], kernel, cfg=cfg)
    params = model.init_params(noise=1e-2, outputscale=1.0, graphbandwidth=EPS,
                               lengthscale=1.0)
    loss, grads = jax.jit(jax.value_and_grad(model.mll_loss))(params, jax.random.PRNGKey(0))
    return dict(adj=np.asarray(adjacency_matvec_ell(graph, c.triu, v)),
                mv=np.asarray(ref_mv(v)),
                sol=np.asarray(cg_solve(ref_mv, v, tol=1e-8, max_iter=400)),
                step_loss=float(loss), step_grads={k: float(g) for k, g in grads.items()})


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


def _row_scenarios(inp):
    return [("sharded_spmv", dict(edges=inp["edges"], eps=EPS, v=inp["v"])),
            ("matern_cg", dict(edges=inp["edges"], eps=EPS, nu=NU, ls=LS, v=inp["v"]))]


def _scenarios(inp):
    step = dict(x=inp["x"], y=inp["y"], edges=inp["edges"], cfg_kw=STEP_CFG, idx=inp["idx"])
    return _row_scenarios(inp) + [
        ("probe_split", dict(step, probes=inp["probes"])),  # 2
        ("probe_split", dict(step, probes=inp["probes"][:, :UNSPLIT_PROBES],
                             idx=inp["idx"][:UNSPLIT_PROBES]), (4,)),  # 3
    ]


@pytest.fixture(scope="module")
def runs(inputs, worlds):
    from manifold_gp_torch.parallel import make_mesh

    single = make_mesh(device="cpu")
    out = {1: [[W.SCENARIOS[name](single, **kw) for name, kw in _row_scenarios(inputs)]]}
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


def _grad_gap(grads, ref):
    return max(abs(grads[k] - ref[k]) for k in ref) / max(abs(v) for v in ref.values())


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_training_step_under_mesh(inputs, runs, ws):
    """A single-device model's loss and gradients under ``use_mesh``: its 16
    probe columns split over the ranks (8 / 8, 4 x 4) and summed back by
    the Megatron pair (one all-reduce of the loss, one of the parameters'
    gradient, nothing panel-sized). Held to JAX's at the JAX test's
    tolerances (loss 1e-3, gradients 2e-2 / 1e-5) and to the unsplit run
    at 1e-5 (of the largest gradient); every rank holds the same loss and
    gradients bit for bit. The average variance's one-hot columns split
    alike (8 over 2 or 4 ranks), held to the unsplit value at 1e-5."""
    ranks = [r[2] for r in runs[ws]]
    for r in ranks:
        assert r["split"] == [True, True]
        mesh, single = r["mesh"], r["single"]
        np.testing.assert_allclose(mesh["loss"], inputs["step_loss"], rtol=1e-3)
        for k, g in inputs["step_grads"].items():
            np.testing.assert_allclose(mesh["grads"][k], g, rtol=2e-2, atol=1e-5)
        np.testing.assert_allclose(mesh["loss"], single["loss"], rtol=1e-5)
        assert _grad_gap(mesh["grads"], single["grads"]) <= 1e-5
        np.testing.assert_allclose(mesh["avg_var"], single["avg_var"], rtol=1e-5)
        assert mesh["collectives"] == {"all_reduce": 2}
        assert single["collectives"] == {}
    for r in ranks[1:]:
        assert (r["mesh"]["loss"], r["mesh"]["grads"], r["mesh"]["avg_var"]) == \
            (ranks[0]["mesh"]["loss"], ranks[0]["mesh"]["grads"], ranks[0]["mesh"]["avg_var"])


def test_training_step_under_mesh_without_a_split(inputs, runs):
    """Six probe columns (and six one-hot columns) at world size 4: the
    world size does not divide them, so every rank keeps all of them, takes
    no collective, and returns the unsplit run's numbers exactly."""
    assert runs[2][0][3] is None  # the case runs at world size 4 only
    for r in runs[4]:
        r = r[3]
        assert r["split"] == [False, False]
        assert r["mesh"]["collectives"] == {}
        assert (r["mesh"]["loss"], r["mesh"]["grads"], r["mesh"]["avg_var"]) == \
            (r["single"]["loss"], r["single"]["grads"], r["single"]["avg_var"])
