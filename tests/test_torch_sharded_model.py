"""Twin of tests/test_sharded_model.py (its 9 cases), of the two mesh tests
of tests/test_edge_cotangent.py and of
tests/test_eval_basis_10k.py::test_mesh_eval_basis_matches_single_device (its
1,024-point circle; the 262k torus basis is held on the card, chip_smoke.py
phase 14):
``RiemannGP`` on a port mesh kernel (``manifold_gp_torch.parallel``) at
world sizes 2 and 4, gloo processes on the CPU (``_torch_mesh_worker``),
one spawn per world size for the file (the ELL-scan predict cycle and
LOBPCG basis at world size 2 only: ``END_TO_END_WORLDS``).

The references: JAX on one device, on the same numpy inputs and the same
probes (JAX's own draws for the JAX test's keys), at the JAX test's
tolerances (JAX's test holds JAX's mesh to the same single-device values);
and the port on one device at 1e-5 relative (losses, matvec-level values).
Beyond the JAX tests: every rank returns the same loss and gradients bit
for bit, world sizes 2 and 4 give the same gradients (a double-counted
all-reduce would scale one of them), a graphbandwidth prior counts once,
and the parameters stay identical on every rank through Adam steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh_worker as W
from _torch_data import one_torch_thread, small_cloud  # noqa: F401
from manifold_gp_tpu.config import InferenceConfig as JConfig
from manifold_gp_tpu.kernels import RiemannMaternKernel as JKernel
from manifold_gp_tpu.models import RiemannGP as JGP
from manifold_gp_tpu.ops.graph import build_graph
from manifold_gp_tpu.ops.laplacian import laplacian_coeffs
from manifold_gp_tpu.ops.matern import make_matern_precision_matvec
from manifold_gp_tpu.ops.slq import rademacher_probes
from manifold_gp_tpu.priors import GammaPrior as JGamma

WORLD_SIZES = (2, 4)
HYPERS = dict(noise=1e-2, outputscale=1.0, graphbandwidth=0.35, lengthscale=1.0)
SUP = dict(max_cholesky=0, num_probes=16, lanczos_max_iter=30, cg_tolerance=1e-4,
           cg_max_iter=400, dense_operator_max_size=4096, use_block_sparse=False)
SEMI = dict(max_cholesky=800, cg_tolerance=1e-6, cg_max_iter=800,
            dense_operator_max_size=4096, use_block_sparse=False)
TRAIN = dict(max_cholesky=0, num_probes=8, lanczos_max_iter=20, cg_tolerance=1e-3,
             cg_max_iter=150)
# the predict cycle checks the glue on an injected basis (JAX's posterior on
# the mesh's basis), not the basis's accuracy: 20 LOBPCG iterations of the
# JAX test's 200 (the basis is held to dense eigh below)
PREDICT = dict(TRAIN, eigensolver_max_iter=20)
EDGE = dict(max_cholesky=0, dense_operator_max_size=0, use_dia=False, num_probes=16,
            lanczos_max_iter=12, cg_tolerance=1e-4, cg_max_iter=300)
BASIS_M, BASIS_EPS = 8, 0.4
# the mesh basis's LOBPCG iterations (JAX's test runs 300): 200 hold its
# tolerances on both SpMV paths at world size 2 and on the fused one at 4
BASIS_ITERS = 200
# The ELL-scan LOBPCG basis and predict cycle make thousands of gloo
# collectives each, a few hundred microseconds apiece on the CPU and
# milliseconds when every core is busy with other test files: they run at
# world size 2 only. Every other case (losses, gradients, exchanges, world
# sizes 2 and 4 equal, the training utility on the small cloud, the fused
# predict cycle and basis) runs at both; the card holds the basis and
# training at world sizes 1 and 2 (chip_smoke.py phases 14, 14a).
END_TO_END_WORLDS = (2,)


def _edges(graph):
    return (np.array(graph.rows), np.array(graph.cols), np.array(graph.sqdist),
            graph.num_nodes)


def _medium_cloud():
    rng = np.random.default_rng(99)
    n = 2048
    t = np.sort(rng.uniform(0, 2 * np.pi, n))
    x = np.stack([np.cos(t), np.sin(t)], axis=1)
    x += 0.01 * rng.standard_normal(x.shape)
    return x.astype(np.float32), np.sin(3 * t).astype(np.float32)


def _edge_cloud():
    rng = np.random.default_rng(7)
    t = np.sort(rng.uniform(0, 2 * np.pi, 900))
    x = np.stack([np.cos(t), np.sin(t), 0.3 * np.sin(2 * t)], 1).astype(np.float32)
    x += 0.01 * rng.standard_normal(x.shape).astype(np.float32)
    return x, np.sin(3 * t).astype(np.float32)


def _jax_loss(x, y, graph, cfg_kw, labeled=None, key=None, k=6):
    cfg = JConfig(**cfg_kw)
    kernel = JKernel(nu=2, x=x, nearest_neighbors=k, laplacian_normalization="randomwalk",
                     num_modes=10, cfg=cfg, graph=graph)
    model = JGP(x if labeled is None else x[labeled], y if labeled is None else y[labeled],
                kernel, labeled=labeled, cfg=cfg)
    params = model.init_params(**HYPERS)
    loss, grads = jax.jit(jax.value_and_grad(model.mll_loss))(params, key)
    return float(loss), {k: float(v) for k, v in grads.items()}


def _jax_with_prior(ref, x, graph, n):
    """``ref`` (loss, grads) plus JAX's graphbandwidth prior term, as
    ``RiemannGP.mll_loss`` adds it: -log p(graphbandwidth) / n, n labels."""
    kernel = JKernel(nu=2, x=x, nearest_neighbors=6, laplacian_normalization="randomwalk",
                     num_modes=10, graph=graph, graphbandwidth_prior=JGamma(3.0, 6.0))
    params = JGP(x, np.zeros(len(x), np.float32), kernel).init_params(**HYPERS)
    (_, prior, value_fn), = kernel.priors()
    term, grads = jax.value_and_grad(
        lambda p: -jnp.sum(prior.log_prob(value_fn(p))) / n)(params)
    return ref[0] + float(term), {k: v + float(grads.get(k, 0.0)) for k, v in ref[1].items()}


def _basis_cloud():
    """tests/test_eval_basis_10k.py's mesh-basis circle (its 1,024 points)."""
    rng = np.random.default_rng(3)
    t = np.sort(rng.uniform(0, 2 * np.pi, 1024))
    x = np.stack([np.cos(t), np.sin(t)], 1).astype(np.float32)
    return x + 0.01 * rng.standard_normal(x.shape).astype(np.float32)


def _problems():
    """The numpy problems, JAX's probes for them and JAX's graphs."""
    x, y = _medium_cloud()
    sx, sy = small_cloud()
    ex, ey = _edge_cloud()
    graph, sgraph, egraph = build_graph(x, 6), build_graph(sx, 6), build_graph(ex, 8)
    n = graph.num_nodes
    labeled = np.zeros(len(sy), bool)
    labeled[::8] = True
    # 150 labeled points: two column chunks (128 + 22), where the JAX
    # test's 80 take one
    labeled2 = np.ones(len(sy), bool)
    labeled2[::16] = False
    probes = np.asarray(rademacher_probes(jax.random.PRNGKey(3), n, SUP["num_probes"]))
    train_probes = [np.asarray(rademacher_probes(jax.random.PRNGKey(i), n, 8))
                    for i in range(3)]
    eprobes = np.asarray(rademacher_probes(jax.random.PRNGKey(0), egraph.num_nodes, 16))
    xs = (x[::31] + 0.02).astype(np.float32)
    # SLQ vs the dense log-det: the JAX test's 512-point graph and probes
    g512 = build_graph(x[:512], 6)
    z512 = np.asarray(rademacher_probes(jax.random.PRNGKey(11), 512, 64))
    # the mesh-basis test's circle
    bx = _basis_cloud()
    bgraph = build_graph(bx, 6)
    graphs = dict(graph=graph, sgraph=sgraph, egraph=egraph, g512=g512, bgraph=bgraph)
    return dict(
        x=x, y=y, sx=sx, sy=sy, ex=ex, ey=ey, edges=_edges(graph), sedges=_edges(sgraph),
        eedges=_edges(egraph), e512=_edges(g512), labeled=labeled, labeled2=labeled2,
        probes=probes, train_probes=train_probes, eprobes=eprobes, xs=xs, z512=z512,
        bx=bx, bedges=_edges(bgraph)), graphs


def _jax_references(inp, graphs):
    """JAX on one device: the losses and gradients, the dense log-det and
    the dense-eigh basis the twins are held to."""
    x, y, sx, sy = inp["x"], inp["y"], inp["sx"], inp["sy"]
    c512 = laplacian_coeffs(graphs["g512"], 0.35)
    dense = make_matern_precision_matvec(graphs["g512"], c512, 2, 1.0, "randomwalk")(
        jnp.eye(512, dtype=jnp.float32))
    ld_exact = 2.0 * float(jnp.sum(jnp.log(jnp.diagonal(jnp.linalg.cholesky(dense)))))
    kb = JKernel(nu=2, x=inp["bx"], nearest_neighbors=6, laplacian_normalization="randomwalk",
                 num_modes=BASIS_M, cfg=JConfig(eigensolver_max_iter=300),
                 graph=graphs["bgraph"])
    val_ref, vec_ref = kb.eval_basis(kb.init_params(graphbandwidth=BASIS_EPS, lengthscale=1.0))
    jax_semi = _jax_loss(sx, sy, graphs["sgraph"], SEMI, labeled=inp["labeled"])
    return dict(
        ld_exact=ld_exact, val_ref=np.asarray(val_ref), vec_ref=np.asarray(vec_ref),
        jax_sup=_jax_loss(x, y, graphs["graph"], SUP, key=jax.random.PRNGKey(3)),
        jax_semi=jax_semi,
        jax_prior=_jax_with_prior(jax_semi, sx, graphs["sgraph"], int(inp["labeled"].sum())),
        jax_edge=_jax_loss(inp["ex"], inp["ey"], graphs["egraph"],
                           dict(EDGE, spmv_kernel="einsum"), key=jax.random.PRNGKey(0), k=8),
    )


@pytest.fixture(scope="module")
def problems():
    return _problems()


@pytest.fixture(scope="module")
def worlds(problems, tmp_path_factory):
    """The rank processes of every world size, started on the problems
    (a future of ``run_worlds``' result)."""
    return W.run_worlds_async(WORLD_SIZES, _scenarios(problems[0]),
                              tmp_path_factory.mktemp("mesh"))


@pytest.fixture(scope="module")
def inputs(problems, worlds):
    """The problems and JAX's references, computed while the ranks run."""
    inp, graphs = problems
    return dict(inp, **_jax_references(inp, graphs))


def _scenarios(inp):
    x, y, e = inp["x"], inp["y"], inp["edges"]
    sx, sy, se = inp["sx"], inp["sy"], inp["sedges"]
    ex, ey, ee = inp["ex"], inp["ey"], inp["eedges"]
    fused = dict(SUP, use_block_sparse=True)
    return [
        ("model_loss", dict(x=x, y=y, edges=e, cfg_kw=SUP, probes=inp["probes"])),  # 0
        ("model_loss", dict(x=sx, y=sy, edges=se, cfg_kw=SEMI, labeled=inp["labeled"])),
        ("model_loss", dict(x=x, y=y, edges=e, cfg_kw=fused, probes=inp["probes"])),  # 2
        ("model_loss", dict(x=sx, y=sy, edges=se, cfg_kw=dict(SEMI, use_block_sparse=True),
                            labeled=inp["labeled"])),
        ("dense_chunked", dict(x=sx, y=sy, edges=se, cfg_kw=dict(SEMI, use_block_sparse=True),
                               labeled=inp["labeled2"])),  # 4
        ("slq_dense", dict(edges=inp["e512"], eps=0.35, nu=2, ls=1.0, z=inp["z512"],
                           num_steps=40)),
        ("informed_train", dict(x=sx, y=sy, edges=se,
                                cfg_kw=dict(TRAIN, use_block_sparse=False), epochs=4)),  # 6
        ("predict_cycle", dict(x=x, y=y, edges=e, cfg_kw=dict(PREDICT, use_block_sparse=True),
                               probes=inp["train_probes"], xs=inp["xs"])),
        ("predict_cycle", dict(x=x, y=y, edges=e, cfg_kw=dict(PREDICT, use_block_sparse=False),
                               probes=inp["train_probes"], xs=inp["xs"]),
         END_TO_END_WORLDS),  # 8
        ("fused_matern", dict(edges=ee, v=np.random.default_rng(3).standard_normal(
            (len(ex), 3)).astype(np.float32), eps=0.4, ls=1.3, nu=2, grad_space="edge")),
        ("fused_matern", dict(edges=ee, v=np.random.default_rng(3).standard_normal(
            (len(ex), 3)).astype(np.float32), eps=0.4, ls=1.3, nu=2)),  # 10
        ("model_loss", dict(x=ex, y=ey, edges=ee, cfg_kw=dict(EDGE, solve_cotangent="panel"),
                            probes=inp["eprobes"], k=8)),
        ("model_loss", dict(x=ex, y=ey, edges=ee, cfg_kw=dict(EDGE, solve_cotangent="edge"),
                            probes=inp["eprobes"], k=8)),  # 12
        ("basis", dict(x=inp["bx"], edges=inp["bedges"],
                       cfg_kw=dict(eigensolver_max_iter=BASIS_ITERS),
                       m=BASIS_M, eps=BASIS_EPS)),
        ("basis", dict(x=inp["bx"], edges=inp["bedges"],
                       cfg_kw=dict(eigensolver_max_iter=BASIS_ITERS, use_block_sparse=False),
                       m=BASIS_M, eps=BASIS_EPS), END_TO_END_WORLDS),  # 14
        ("model_loss", dict(x=sx, y=sy, edges=se, cfg_kw=dict(SEMI, use_block_sparse=True),
                            labeled=inp["labeled"], prior=True)),
    ]


# the scenarios the port also runs on one device (no mesh), in-process
SINGLE = (0, 1, 5, 11, 15)


@pytest.fixture(scope="module")
def runs(inputs, worlds):
    """[ws] -> [rank] -> [scenario] results; [1] -> {scenario: result}: the
    port on one device (the SLQ operator on a mesh of one process, no
    group)."""
    from manifold_gp_torch.parallel import make_mesh

    sc = _scenarios(inputs)
    one = make_mesh(device="cpu")
    out = {1: {i: W.SCENARIOS[sc[i][0]](one if sc[i][0] == "slq_dense" else None, **sc[i][1])
               for i in SINGLE}}
    out.update(worlds.result())
    return out


def _same_on_every_rank(ranks, idx):
    first = ranks[0][idx]
    for r in ranks[1:]:
        assert r[idx]["loss"] == first["loss"] and r[idx]["grads"] == first["grads"]
    return first


def _hold(res, ref, loss_rtol, grad_rtol, grad_atol):
    np.testing.assert_allclose(res["loss"], ref[0], rtol=loss_rtol)
    for k, v in ref[1].items():
        np.testing.assert_allclose(res["grads"][k], v, rtol=grad_rtol, atol=grad_atol,
                                   err_msg=k)


def _hold_single(res, single):
    np.testing.assert_allclose(res["loss"], single["loss"], rtol=1e-5)
    scale = max(abs(v) for v in single["grads"].values())
    for k, v in single["grads"].items():
        assert abs(res["grads"][k] - v) <= 1e-4 * scale, (k, res["grads"][k], v)


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_sharded_supervised_mll_matches_single_device(inputs, runs, ws):
    """Scan path, SLQ with support-embedded probes (JAX's draws for key 3)."""
    res = _same_on_every_rank(runs[ws], 0)
    assert not res["fused"]
    _hold(res, inputs["jax_sup"], 2e-3, 3e-2, 1e-4)
    _hold_single(res, runs[1][0])


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_sharded_semisup_mll_matches_single_device(inputs, runs, ws):
    """Masked Schur on the scan path, exact dense-Cholesky log-det."""
    res = _same_on_every_rank(runs[ws], 1)
    _hold(res, inputs["jax_semi"], 1e-4, 1e-2, 1e-5)
    _hold_single(res, runs[1][1])


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_sharded_supervised_mll_fused_mesh(inputs, runs, ws):
    """The fused block-ELL mesh path (not the scan) against one device."""
    res = _same_on_every_rank(runs[ws], 2)
    assert res["fused"], "fused mesh layout must build"
    _hold(res, inputs["jax_sup"], 2e-3, 3e-2, 1e-4)
    _hold_single(res, runs[1][0])


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_sharded_semisup_mll_fused_mesh(inputs, runs, ws):
    res = _same_on_every_rank(runs[ws], 3)
    assert res["fused"]
    _hold(res, inputs["jax_semi"], 1e-4, 1e-2, 1e-5)
    _hold_single(res, runs[1][1])


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_fused_mesh_chunked_dense_logdet_matches_batched(runs, ws):
    """The 128-column chunked support-block densification (two chunks)
    equals the single batch it replaces, and every rank holds the same
    block."""
    for r in runs[ws]:
        res = r[4]
        np.testing.assert_allclose(res["ld_chunked"], res["ld_batched"], rtol=1e-6)
        np.testing.assert_allclose(res["dense"], res["dense"].T, atol=1e-5)
    np.testing.assert_array_equal(runs[ws][0][4]["dense"], runs[ws][-1][4]["dense"])


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_sharded_slq_logdet_matches_dense(inputs, runs, ws):
    """SLQ on the row-sharded operator (padded probes, the true trace
    dimension) vs the dense log-det oracle; Monte-Carlo tolerance."""
    ld = runs[ws][0][5]["logdet"]
    assert abs(ld - inputs["ld_exact"]) / abs(inputs["ld_exact"]) < 0.05, (ld, inputs["ld_exact"])
    np.testing.assert_allclose(ld, runs[1][5]["logdet"], rtol=1e-5)


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_sharded_training_step_runs(runs, ws):
    """Adam steps over the sharded loss give finite updates, and the
    parameters stay bit-identical on every rank."""
    first = runs[ws][0][7]
    assert np.all(np.isfinite(first["losses"]))
    for r in runs[ws]:
        for k, v in first["params"].items():
            assert np.isfinite(v).all(), k
            np.testing.assert_array_equal(r[7]["params"][k], v, err_msg=k)


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_sharded_manifold_informed_train(runs, ws):
    """The training utility (outputscale normalization by the sharded
    average variance, plateau scheduler) drives a mesh model end to end;
    every rank ends with the same parameters."""
    first = runs[ws][0][6]
    assert np.isfinite(first["loss"]) and np.all(np.isfinite(first["history"]))
    for r in runs[ws]:
        assert r[6]["history"] == first["history"]
        for k, v in first["params"].items():
            np.testing.assert_array_equal(r[6]["params"][k], v, err_msg=k)


@pytest.mark.parametrize(("fused", "ws"), [(True, 2), (False, 2), (True, 4)],
                         ids=["fused-2", "scan-2", "fused-4"])
def test_mesh_predict_cycle_matches_single_device(inputs, runs, ws, fused):
    """Train a few Adam steps on the mesh model, eval (the sharded LOBPCG
    basis, gathered to node order) and the posterior on the trained params;
    JAX's single-device model at the same params on the same (injected)
    basis must give the same posterior, in-sample and out of sample."""
    res = runs[ws][0][7 if fused else 8]
    assert res["fused"] == fused
    assert np.all(np.isfinite(res["eigvec"]))
    cfg = JConfig(**dict(TRAIN, use_block_sparse=False))
    x, y = inputs["x"], inputs["y"]
    kernel = JKernel(nu=2, x=x, nearest_neighbors=6, laplacian_normalization="randomwalk",
                     num_modes=10, cfg=cfg)
    model = JGP(x, y, kernel, cfg=cfg)
    basis = (jnp.asarray(res["eigval"]), jnp.asarray(res["eigvec"]))
    kernel.eval_basis = lambda p: basis
    params = {k: jnp.asarray(v) for k, v in res["params"].items()}
    model.eval(params)
    tr = model.posterior(params, kernel.x, is_train=True)
    te = model.posterior(params, inputs["xs"])
    for got, want in ((res["mean_tr"], tr.mean), (res["std_tr"], tr.stddev),
                      (res["mean_te"], te.mean), (res["std_te"], te.stddev)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    for r in runs[ws]:
        np.testing.assert_array_equal(r[7 if fused else 8]["mean_te"], res["mean_te"])


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_sharded_edge_grad_matches_panel(runs, ws):
    """The fused mesh Matérn operator: a loss-like scalar's value and its
    (graphbandwidth, lengthscale) gradients agree between edge-space and
    panel-space cotangents."""
    edge, panel = runs[ws][0][9]["fused"], runs[ws][0][10]["fused"]
    np.testing.assert_allclose(edge[0], panel[0], rtol=1e-6)
    np.testing.assert_allclose(edge[1:], panel[1:], rtol=2e-4)


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_sharded_model_loss_edge_vs_panel(inputs, runs, ws):
    """The mesh training loss (fused block-ELL) with edge- vs panel-space
    cotangents, and against JAX's single-device loss with the same probes."""
    panel = _same_on_every_rank(runs[ws], 11)
    edge = _same_on_every_rank(runs[ws], 12)
    assert panel["fused"] and edge["fused"]
    np.testing.assert_allclose(edge["loss"], panel["loss"], rtol=1e-5)
    for k, v in panel["grads"].items():
        np.testing.assert_allclose(edge["grads"][k], v, rtol=5e-4, atol=1e-6, err_msg=k)
    _hold(panel, inputs["jax_edge"], 1e-4, 5e-3, 1e-5)
    _hold_single(panel, runs[1][11])


@pytest.mark.parametrize(("fused", "ws"), [(True, 2), (False, 2), (True, 4)],
                         ids=["True-2", "False-2", "True-4"])
def test_mesh_eval_basis_matches_single_device(inputs, runs, ws, fused):
    """The row-sharded LOBPCG basis (fused block-ELL and ELL-scan SpMV) vs
    JAX's single-device dense-eigh basis of the same graph."""
    res = runs[ws][0][13 if fused else 14]
    assert res["fused"] == fused
    n = inputs["bx"].shape[0]
    assert res["eigvec"].shape == (n, BASIS_M)
    vals = inputs["val_ref"]
    np.testing.assert_allclose(res["eigval"], vals, rtol=1e-2, atol=1e-5)
    for j in range(BASIS_M - 1):
        gap = min(vals[j] - vals[j - 1] if j > 0 else 1.0, vals[j + 1] - vals[j])
        if gap < 1e-3:
            continue
        dot = abs(float(res["eigvec"][:, j] @ inputs["vec_ref"][:, j]))
        assert dot > 0.98, (j, dot)


def test_mesh_gradients_equal_across_world_sizes(runs):
    """World sizes 2 and 4 give the same loss and gradients (fused and scan
    paths, supervised and semisupervised): each all-reduce of a gradient
    partial runs once, or one world size would scale it."""
    for idx in (0, 1, 2, 3, 11, 12, 15):
        a, b = runs[2][0][idx], runs[4][0][idx]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        scale = max(abs(v) for v in a["grads"].values())
        for k, v in a["grads"].items():
            assert abs(b["grads"][k] - v) <= 1e-5 * scale, (idx, k, v, b["grads"][k])


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_mesh_prior_counts_once(inputs, runs, ws):
    """A graphbandwidth prior on a mesh model (the fused semisupervised
    case): its term and gradient count once, as on one device and in JAX."""
    res = _same_on_every_rank(runs[ws], 15)
    _hold(res, inputs["jax_prior"], 1e-4, 1e-2, 1e-5)
    _hold_single(res, runs[1][15])
    plain = runs[ws][0][3]
    prior_term = inputs["jax_prior"][0] - inputs["jax_semi"][0]
    np.testing.assert_allclose(res["loss"] - plain["loss"], prior_term, rtol=1e-3)
