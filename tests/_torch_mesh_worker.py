"""Rank processes of the port's multi-GPU twins, on the CPU over gloo.

``run_worlds(world_sizes, scenarios, workdir)`` starts, for each world
size (in turn, or all at once with ``together``), that many processes of
this file, each of which joins its world's gloo group through a file in
``workdir``, makes the mesh and runs every scenario of the list in order
(``SCENARIOS[name](mesh, **inputs)``, numpy in and numpy out; ``mesh`` None
runs one device), then writes its results. The parent waits with a time
limit, kills every rank when one fails or the limit passes, and returns
the results by world size as lists over ranks; ``run_worlds_async`` does
the same on a thread, so the parent computes its references meanwhile.
This file imports torch, numpy and the port only: JAX runs in the parent.
"""

from __future__ import annotations

import concurrent.futures
import os
import pathlib
import pickle
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 300


def run_worlds(world_sizes, scenarios: list, workdir, timeout: float = RANK_TIMEOUT_S,
               together: bool = False):
    """Run ``scenarios`` ([(name, inputs dict)] or [(name, inputs dict,
    world sizes to run it on)]) on a world of each size in ``world_sizes``,
    one world after the other (their collectives stall when more ranks than
    cores compete), or all at once with ``together`` (for scenarios of a
    few collectives, where the ranks' start-up dominates); returns {world
    size: [rank] -> [scenario] -> result dict, None where the scenario skips
    that world size}."""
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))

    def start(ws):
        run = workdir / f"ws{ws}"
        run.mkdir(exist_ok=True)
        spec = run / "spec.pkl"
        spec.write_bytes(pickle.dumps([sc[:2] if len(sc) < 3 or ws in sc[2] else None
                                       for sc in scenarios]))
        return [subprocess.Popen([sys.executable, __file__, str(spec), str(r), str(ws),
                                  str(run / "rendezvous"), str(run)],
                                 env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
                for r in range(ws)]

    def finish(worlds):
        """Wait for every rank of ``worlds`` ({ws: procs}); kill them all
        when one fails or the time limit passes."""
        procs = [p for ps in worlds.values() for p in ps]
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline or any(p.returncode not in (None, 0)
                                                      for p in procs):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            logs = {ws: [p.communicate()[0] for p in ps] for ws, ps in worlds.items()}
        for ws, ps in worlds.items():
            bad = [r for r, p in enumerate(ps) if p.returncode != 0]
            if bad:
                raise RuntimeError(
                    f"ranks {bad} of world size {ws} failed or passed {timeout} s:\n"
                    + "\n".join(f"--- rank {r}\n{logs[ws][r][-4000:]}" for r in bad))
        return {ws: [pickle.loads((workdir / f"ws{ws}" / f"rank{r}.pkl").read_bytes())
                     for r in range(ws)] for ws in worlds}

    if together:
        return finish({ws: start(ws) for ws in world_sizes})
    out = {}
    for ws in world_sizes:
        out.update(finish({ws: start(ws)}))
    return out


def run_worlds_async(*args, **kwargs):
    """``run_worlds`` on a thread of its own: a future of its result, so
    the parent's own work (JAX's references) overlaps the ranks."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(run_worlds, *args, **kwargs)
    pool.shutdown(wait=False)
    return future


# -- scenarios ---------------------------------------------------------------


def _np(t):
    return t.detach().cpu().numpy()


def _graph(edges):
    from manifold_gp_torch.ops.graph import graph_from_edges

    rows, cols, sqdist, n = edges
    return graph_from_edges(rows, cols, sqdist, int(n), device="cpu")


def _f32(x):
    import torch

    return torch.tensor(np.float32(x))


def scenario_tables(mesh, edges):
    from manifold_gp_torch.parallel.block_spmv import build_mesh_block_tables

    t = build_mesh_block_tables(_graph(edges), mesh)
    return {"block_col": t.block_col_np, "edge_sel": t.edge_sel_np, "edge_pos": t.edge_pos_np,
            "diag_sel": t.diag_sel_np, "diag_pos": t.diag_pos_np,
            "row_of_node": t.row_of_node_np, "halo": t.halo, "rows": t.rows, "nrb": t.nrb,
            "row_lo": t.local.row_lo, "lrows": t.local.lrows}


def scenario_block_matvec(mesh, edges, eps, v, cot):
    """Sharded assembly, forward and both VJPs of the sharded fused matvec,
    on this rank's rows (the parent stacks them)."""
    import torch

    from manifold_gp_torch.ops.laplacian import laplacian_coeffs
    from manifold_gp_torch.parallel.block_spmv import (
        assemble_sharded, build_mesh_block_tables, make_sharded_block_matvec_ad)

    g = _graph(edges)
    tables = build_mesh_block_tables(g, mesh)
    c = laplacian_coeffs(g, _f32(eps))
    sh = tables.local
    blocks = assemble_sharded(tables, c.diag, c.triu).requires_grad_(True)
    pv = tables.embed_rows(v).requires_grad_(True)
    cot_l = torch.from_numpy(cot[sh.row_lo:sh.row_lo + sh.lrows])
    mv = make_sharded_block_matvec_ad(tables)
    out = mv(blocks, pv)
    gb, gp = torch.autograd.grad(torch.sum(out * cot_l), [blocks, pv])
    return {"blocks": _np(blocks), "out": _np(out), "g_blocks": _np(gb), "g_pv": _np(gp),
            "row_lo": sh.row_lo}


def scenario_halo_vs_gather(mesh, edges, eps, seeds):
    import torch

    from manifold_gp_torch.ops.laplacian import laplacian_coeffs
    from manifold_gp_torch.parallel.block_spmv import (
        assemble_sharded, build_mesh_block_tables, exchange_name, make_sharded_block_matvec_ad)

    g = _graph(edges)
    tables = build_mesh_block_tables(g, mesh)
    c = laplacian_coeffs(g, _f32(eps))
    blocks0 = assemble_sharded(tables, c.diag, c.triu)
    sh = tables.local
    out = {"halo": tables.halo, "exchange": exchange_name(tables), "diffs": []}
    for seed in seeds:
        rng = np.random.default_rng(seed)
        v = rng.standard_normal((g.num_nodes, 4)).astype(np.float32)
        cot = rng.standard_normal((tables.rows, 4)).astype(np.float32)
        cot_l = torch.from_numpy(cot[sh.row_lo:sh.row_lo + sh.lrows])
        res = []
        for exchange in ("auto", "gather"):
            blocks = blocks0.clone().requires_grad_(True)
            pv = tables.embed_rows(v).requires_grad_(True)
            y = make_sharded_block_matvec_ad(tables, exchange=exchange)(blocks, pv)
            res.append((y, *torch.autograd.grad(torch.sum(y * cot_l), [blocks, pv])))
        out["diffs"].append([float(torch.max(torch.abs(a - b)).detach()) for a, b in zip(*res)])
    return out


def scenario_fused_matern(mesh, edges, v, eps, ls, nu, grad_space="panel"):
    """quad = v' Q v (and its gradients w.r.t. eps, ls) on the fused mesh
    Matérn operator and on the scan path."""
    import torch

    from manifold_gp_torch.ops.laplacian import laplacian_coeffs
    from manifold_gp_torch.parallel.block_spmv import (
        build_mesh_block_tables, make_sharded_matern_precision_matvec_fused)
    from manifold_gp_torch.parallel.mesh import row_sum, use_mesh
    from manifold_gp_torch.parallel.spmv import make_sharded_matern_precision_matvec, pad_nodes

    g = _graph(edges)
    tables = build_mesh_block_tables(g, mesh)
    out = {}
    for path in ("fused", "scan"):
        e = _f32(eps).requires_grad_(True)
        lsc = _f32(ls).requires_grad_(True)
        c = laplacian_coeffs(g, e)
        with use_mesh(mesh):
            if path == "fused":
                mv = make_sharded_matern_precision_matvec_fused(
                    tables, c, nu, lsc, "randomwalk", grad_space=grad_space)
                vs = tables.embed_rows(v)
            else:
                mv, n_pad = make_sharded_matern_precision_matvec(g, mesh, c, nu, lsc,
                                                                 "randomwalk")
                vs = pad_nodes(torch.from_numpy(v), n_pad, mesh)
            q = row_sum(torch.sum(vs * mv(vs), dim=1))
        ge, gl = torch.autograd.grad(q, [e, lsc])
        out[path] = (float(q.detach()), float(ge), float(gl))
    return out


def scenario_sharded_spmv(mesh, edges, eps, v):
    import torch

    from manifold_gp_torch.ops.laplacian import laplacian_coeffs
    from manifold_gp_torch.parallel import pad_nodes, shard_graph_rows, sharded_adjacency_matvec

    g = _graph(edges)
    c = laplacian_coeffs(g, _f32(eps))
    ee, ec, em, n_pad = shard_graph_rows(g, mesh)
    vp = pad_nodes(torch.from_numpy(v), n_pad, mesh)
    out = {}
    for ring in (False, True):
        triu = c.triu.clone().requires_grad_(True)
        vv = vp.clone().requires_grad_(True)
        y = sharded_adjacency_matvec(ee, ec, em, triu, vv, mesh, ring=ring)
        gt, gv = torch.autograd.grad(torch.sum(y * vp), [triu, vv])
        out["ring" if ring else "gather"] = (_np(y), _np(gt), _np(gv))
    out["n_pad"] = n_pad
    return out


def scenario_matern_cg(mesh, edges, eps, nu, ls, v):
    """Row-sharded scan Matérn matvec and a sharded CG solve."""
    import torch

    from manifold_gp_torch.ops.cg import cg_raw
    from manifold_gp_torch.ops.laplacian import laplacian_coeffs
    from manifold_gp_torch.parallel import make_sharded_matern_precision_matvec, pad_nodes
    from manifold_gp_torch.parallel.mesh import use_mesh

    g = _graph(edges)
    c = laplacian_coeffs(g, _f32(eps))
    with torch.no_grad(), use_mesh(mesh):
        mv, n_pad = make_sharded_matern_precision_matvec(g, mesh, c, nu, ls, "randomwalk")
        vp = pad_nodes(torch.from_numpy(v), n_pad, mesh)
        y = mv(vp)
        sol = cg_raw(mv, vp, tol=1e-8, max_iter=400)
    return {"mv": _np(y), "sol": _np(sol)}


def scenario_slq_dense(mesh, edges, eps, nu, ls, z, num_steps):
    import torch

    from manifold_gp_torch.ops.laplacian import laplacian_coeffs
    from manifold_gp_torch.ops.slq import slq_logdet
    from manifold_gp_torch.parallel import make_sharded_matern_precision_matvec, pad_nodes
    from manifold_gp_torch.parallel.mesh import use_mesh

    g = _graph(edges)
    c = laplacian_coeffs(g, _f32(eps))
    with torch.no_grad(), use_mesh(mesh):
        mv, n_pad = make_sharded_matern_precision_matvec(g, mesh, c, nu, ls, "randomwalk")
        probes = pad_nodes(torch.from_numpy(np.array(z)), n_pad, mesh)
        ld = slq_logdet(mv, probes, num_steps=num_steps, cg_tol=1e-4, cg_max_iter=400,
                        num_nodes=g.num_nodes)
    return {"logdet": float(ld)}


def _model(mesh, x, y, edges, cfg_kw, labeled=None, nu=2, k=6, num_modes=10, prior=False,
           hypers=None):
    from manifold_gp_torch import InferenceConfig, RiemannGP, RiemannMaternKernel
    from manifold_gp_torch.priors import GammaPrior

    cfg = InferenceConfig(**cfg_kw)
    kernel = RiemannMaternKernel(
        nu=nu, x=x, nearest_neighbors=k, laplacian_normalization="randomwalk",
        num_modes=num_modes, cfg=cfg, mesh=mesh, graph=_graph(edges), device="cpu",
        graphbandwidth_prior=GammaPrior(3.0, 6.0) if prior else None)
    tx = x if labeled is None else x[labeled]
    ty = y if labeled is None else y[labeled]
    model = RiemannGP(tx, ty, kernel, labeled=labeled, cfg=cfg)
    hypers = hypers or dict(noise=1e-2, outputscale=1.0, graphbandwidth=0.35, lengthscale=1.0)
    return model, model.init_params(**hypers)


def _loss_and_grads(model, params, probes=None):
    import torch

    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    if isinstance(probes, tuple):
        probes = tuple(torch.from_numpy(np.array(p)) for p in probes)
    elif probes is not None:
        probes = torch.from_numpy(np.array(probes))
    loss = model.mll_loss(leaves, probes=probes)
    names = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
    return float(loss.detach()), {k: (0.0 if g is None else float(g))
                                  for k, g in zip(names, grads)}


def scenario_model_loss(mesh, x, y, edges, cfg_kw, labeled=None, probes=None, prior=False,
                        nu=2, k=6, hypers=None):
    """One mesh-model loss and its gradients (bits of the gradients too, for
    the cross-rank identity)."""
    model, params = _model(mesh, x, y, edges, cfg_kw, labeled=labeled, prior=prior, nu=nu,
                           k=k, hypers=hypers)
    loss, grads = _loss_and_grads(model, params, probes)
    return {"loss": loss, "grads": grads, "fused": model.kernel._mesh_fused is not None}


def scenario_dense_chunked(mesh, x, y, edges, cfg_kw, labeled):
    """The 128-column chunked support densification against one batch."""
    import torch

    from manifold_gp_torch.parallel.mesh import leave_sharded, use_mesh

    model, params = _model(mesh, x, y, edges, cfg_kw, labeled=labeled)
    n = model.num_data
    rows, ids = model._support_local_rows, model._support_local_ids
    with torch.no_grad(), use_mesh(mesh):
        mv = model.precision_matvec(params, noise=True)
        count = model._y_pad.shape[0]
        rhs = torch.zeros((count, n))
        rhs[rows, ids] = 1.0
        out = mv(rhs)
        batched = leave_sharded(out.new_zeros((n, n)).index_copy(0, ids, out[rows]), mesh)
        ld_chunked = model._dense_support_logdet(mv)
    ld_batched = 2.0 * torch.sum(torch.log(torch.diagonal(torch.linalg.cholesky(batched))))
    return {"ld_chunked": float(ld_chunked), "ld_batched": float(ld_batched),
            "dense": _np(batched)}


def scenario_informed_train(mesh, x, y, edges, cfg_kw, epochs):
    from manifold_gp_torch.utils import ReduceLROnPlateau, manifold_informed_train

    model, params = _model(mesh, x, y, edges, cfg_kw)
    params, loss, history = manifold_informed_train(
        model, params, lr=5e-2, max_iter=epochs, tolerance=0.0, update_norm=None,
        num_rand_vec=32, scheduler=ReduceLROnPlateau(factor=0.5, patience=50, threshold=1e-3),
        verbose=False)
    return {"loss": float(loss), "history": history,
            "params": {k: _np(v).copy() for k, v in params.items()}}


def scenario_predict_cycle(mesh, x, y, edges, cfg_kw, probes, xs, lr=5e-2):
    """A few Adam steps on the loss (one probe set a step), then eval ->
    posterior on the trained parameters: the parameters' values, the
    basis, and the posterior in-sample and at ``xs``."""
    import torch

    model, params = _model(mesh, x, y, edges, cfg_kw)
    for p in params.values():
        p.requires_grad_(True)
    opt = torch.optim.Adam(list(params.values()), lr=lr)
    losses = []
    for z in probes:
        loss = model.mll_loss(params, probes=torch.from_numpy(z))
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    params = {k: v.detach() for k, v in params.items()}
    model.eval(params)
    eigval, eigvec = model._cache["basis"]
    tr = model.posterior(params, model.kernel.x, is_train=True)
    te = model.posterior(params, xs)
    return {"losses": losses, "params": {k: _np(v).copy() for k, v in params.items()},
            "eigval": _np(eigval), "eigvec": _np(eigvec),
            "fused": model.kernel._mesh_fused is not None,
            "mean_tr": _np(tr.mean), "std_tr": _np(tr.stddev),
            "mean_te": _np(te.mean), "std_te": _np(te.stddev)}


def scenario_basis(mesh, x, edges, cfg_kw, m, eps, k=6):
    from manifold_gp_torch import InferenceConfig, RiemannMaternKernel

    kernel = RiemannMaternKernel(nu=2, x=x, nearest_neighbors=k,
                                 laplacian_normalization="randomwalk", num_modes=m,
                                 cfg=InferenceConfig(**cfg_kw), mesh=mesh, graph=_graph(edges),
                                 device="cpu")
    val, vec = kernel.eval_basis(kernel.init_params(graphbandwidth=eps, lengthscale=1.0))
    return {"eigval": _np(val), "eigvec": _np(vec), "fused": kernel._mesh_fused is not None}


def scenario_probe_split(mesh, x, y, edges, cfg_kw, probes, idx, nu=1):
    """A single-device model's loss, gradients and average variance under
    ``use_mesh(mesh)`` (its probe and one-hot columns split over the ranks
    where the world size divides them) and without a mesh context; whether
    each batch was split, and the collectives of one loss and gradient."""
    import contextlib

    import torch

    from manifold_gp_torch import InferenceConfig, RiemannGP, RiemannMaternKernel
    from manifold_gp_torch.parallel import mesh as pmesh

    cfg = InferenceConfig(**cfg_kw)
    kernel = RiemannMaternKernel(nu=nu, x=x, nearest_neighbors=6,
                                 laplacian_normalization="randomwalk", num_modes=10, cfg=cfg,
                                 graph=_graph(edges), device="cpu")
    model = RiemannGP(x, y, kernel, cfg=cfg)
    params = model.init_params(noise=1e-2, outputscale=1.0, graphbandwidth=0.35,
                               lengthscale=1.0)
    out = {}
    with pmesh.use_context(pmesh.ShardingContext(mesh, pmesh.PROBE_AXIS)):
        out["split"] = [pmesh.probe_split(np.asarray(probes).shape[1]) is not None,
                        pmesh.probe_split(len(idx)) is not None]
    for name, scope in (("mesh", pmesh.use_mesh(mesh)), ("single", contextlib.nullcontext())):
        with scope:
            pmesh.collective_counts.clear()
            loss, grads = _loss_and_grads(model, params, probes)
            collectives = dict(pmesh.collective_counts)
            with torch.no_grad():
                avg = model.average_variance(params, num_rand_vec=len(idx),
                                             idx=torch.as_tensor(idx))
        out[name] = {"loss": loss, "grads": grads, "avg_var": float(avg),
                     "collectives": collectives}
    return out


def _edges_np(graph):
    return {"rows": _np(graph.rows), "cols": _np(graph.cols), "sqdist": _np(graph.sqdist),
            "ell_col": _np(graph.ell_col), "max_degree": graph.max_degree}


def scenario_knn_searches(mesh, cloud, q_oos, db_uneven, q_uneven, db_small, q_small):
    """The sharded exact search on both schedules (self-query, out-of-sample
    queries, an uneven database and k above a shard on the ring), the
    sharded graph build, and ``NearestNeighbors(mesh=)`` alone and with
    IVF; numpy (sqdist, idx) pairs and edge lists."""
    from manifold_gp_torch.ops.knn import NearestNeighbors
    from manifold_gp_torch.parallel import build_graph_sharded, sharded_knn_search

    def search(*args, **kw):
        return tuple(_np(t) for t in sharded_knn_search(*args, mesh=mesh, **kw))

    out = {}
    for sched in ("replicated", "ring"):
        out[f"self_{sched}"] = search(cloud, cloud, 9, self_query=True, schedule=sched,
                                      block_size=128)
        out[f"oos_{sched}"] = search(cloud, q_oos, 5, schedule=sched, block_size=64)
        out[f"graph_{sched}"] = _edges_np(build_graph_sharded(cloud, 8, mesh, schedule=sched))
    out["uneven_ring"] = search(db_uneven, q_uneven, 7, schedule="ring", block_size=32)
    out["kbig_ring"] = search(db_small, q_small, 50, schedule="ring", block_size=32)
    nn = NearestNeighbors(cloud, mesh=mesh)
    out["nn_search"] = tuple(_np(t) for t in nn.search(nn.x, 6))
    out["nn_graph"] = _edges_np(nn.graph(6))
    nn = NearestNeighbors(cloud, use_ivf=True, nlist=32, nprobe=32, mesh=mesh)
    out["nn_ivf_search"] = tuple(_np(t) for t in nn.search(cloud, 6, self_query=True))
    out["nn_ivf_graph"] = _edges_np(nn.graph(6))
    return out


def scenario_sharded_ivf(mesh, index, cloud, q_oos, q_pad, k_pad):
    """The sharded IVF search on a given index (numpy centroids, lists,
    mask, database) beside the single-device ``ivf_search`` on it: the
    self-query, out-of-sample queries, a chunked dispatch, and queries
    whose probed lists hold fewer than k points (padding slots)."""
    import torch

    from manifold_gp_torch.ops.knn import IVFIndex, ivf_search
    from manifold_gp_torch.parallel import sharded_ivf_search

    idx = IVFIndex(*(torch.from_numpy(np.asarray(a)) for a in index))
    idx = IVFIndex(idx.centroids, idx.lists.long(), idx.list_mask, idx.database)
    cases = {"self": (cloud, 9, 8, True, {}), "oos": (q_oos, 9, 8, False, {}),
             "chunked": (cloud, 7, 8, True, {"queries_per_dispatch": 512}),
             "pad": (q_pad, k_pad, 2, False, {})}
    out = {}
    for name, (q, k, nprobe, self_query, kw) in cases.items():
        qt = torch.from_numpy(q)
        sh = sharded_ivf_search(idx, qt, k, mesh, nprobe=nprobe, self_query=self_query,
                                block_size=64, **kw)
        one = ivf_search(idx, qt, k, nprobe=nprobe, self_query=self_query, block_size=64)
        out[name] = {"sharded": tuple(_np(t) for t in sh), "single": tuple(_np(t) for t in one)}
    return out


def scenario_mesh_graph_model(mesh, x, y, probes, x_oos_n, xs):
    """The sharded-built graph fed to a single-device kernel (loss beside
    the kernel's own build), and out-of-sample features through an
    injected ``NearestNeighbors(mesh=)`` index (posterior beside the
    default index)."""
    import torch

    from manifold_gp_torch import InferenceConfig, RiemannGP, RiemannMaternKernel
    from manifold_gp_torch.ops.knn import NearestNeighbors
    from manifold_gp_torch.parallel import build_graph_sharded

    cfg = InferenceConfig(max_cholesky=0, num_probes=8, lanczos_max_iter=20, cg_tolerance=1e-3,
                          cg_max_iter=100)
    hypers = dict(noise=1e-2, outputscale=1.0, graphbandwidth=0.3, lengthscale=1.0)
    out = {}
    for name, graph in (("sharded", build_graph_sharded(x, 6, mesh)), ("own", None)):
        kernel = RiemannMaternKernel(nu=2, x=x, nearest_neighbors=6,
                                     laplacian_normalization="randomwalk", num_modes=10, cfg=cfg,
                                     graph=graph, device="cpu")
        model = RiemannGP(x, y, kernel, cfg=cfg)
        with torch.no_grad():
            out[f"loss_{name}"] = float(model.mll_loss(model.init_params(**hypers),
                                                       probes=torch.from_numpy(probes)))
    xo, yo = x[:x_oos_n], y[:x_oos_n]
    for name, index in (("mesh", NearestNeighbors(xo, mesh=mesh)), ("default", None)):
        cfg = InferenceConfig()
        kernel = RiemannMaternKernel(nu=2, x=xo, nearest_neighbors=6,
                                     laplacian_normalization="randomwalk", num_modes=8, cfg=cfg,
                                     knn_index=index, device="cpu")
        model = RiemannGP(xo, yo, kernel, cfg=cfg)
        params = model.init_params(**hypers)
        model.eval(params)
        post = model.posterior(params, xs)
        out[f"post_{name}"] = (_np(post.mean), _np(post.stddev))
    return out


SCENARIOS = {name[len("scenario_"):]: fn for name, fn in dict(globals()).items()
             if name.startswith("scenario_")}


def _main(spec, rank, world_size, init, workdir):
    import torch

    torch.set_num_threads(1)
    from manifold_gp_torch.parallel import init_distributed, make_mesh

    init_distributed(backend="gloo", init_method=f"file://{init}", world_size=world_size,
                     rank=rank, timeout_s=60)
    mesh = make_mesh(device="cpu")
    results = [None if sc is None else SCENARIOS[sc[0]](mesh, **sc[1])
               for sc in pickle.loads(pathlib.Path(spec).read_bytes())]
    out = pathlib.Path(workdir) / f"rank{rank}.pkl"
    tmp = out.with_suffix(".tmp")
    tmp.write_bytes(pickle.dumps(results))
    tmp.rename(out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
