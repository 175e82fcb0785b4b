"""Port vs JAX: the Matérn precision on every execution path, the scale and
noise wrappers and the Jacobi diagonals (twin of tests/test_precision.py).

The same numpy inputs go through both packages on the CPU; both compute in
f32 with different sum orders, so values agree to a few 1e-6 of the output
scale, and gradients (sums of many such terms) to 1e-4 relative. bf16
panels round identically on both sides (the same bf16 products, summed in
f32); x3 panels differ by ~2^-15 per apply because the JAX CPU path merges
them back to f32 while the port keeps the kernel's three bf16 products.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data import one_torch_thread, small_cloud  # noqa: F401  (autouse fixture)
from manifold_gp_tpu.ops import block_sparse as jbs
from manifold_gp_tpu.ops import graph as jgraph
from manifold_gp_tpu.ops import laplacian as jlap
from manifold_gp_tpu.ops import matern as jmat
from manifold_gp_torch.ops import block_sparse as tbs
from manifold_gp_torch.ops import graph as tgraph
from manifold_gp_torch.ops import laplacian as tlap
from manifold_gp_torch.ops import matern as tmat
from manifold_gp_torch.ops.operator import Operator

EPS = 0.35
LS = 1.3
SCALE = 0.7
NOISE = 0.01
VAL_TOL = 5e-6  # of the output scale
JDT = {"float32": None, "bfloat16": jnp.bfloat16, "float32x3": "float32x3"}
TDT = {"float32": None, "bfloat16": torch.bfloat16, "float32x3": "float32x3"}


@pytest.fixture(scope="module")
def graphs():
    x, _ = small_cloud()
    jg = jgraph.build_graph(x, 6)
    tg = tgraph.build_graph(x, 6, device="cpu")
    return jg, tg, jbs.build_block_layout(jg), tbs.build_block_layout(tg)


def _vec(n, batch=3, seed=0):
    return np.random.default_rng(seed).standard_normal((n, batch)).astype(np.float32)


def _close(got, want, tol=VAL_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max())


def _jax_op(graphs, path, nu, normalization, eps=EPS, ls=LS, dtype="float32",
            permuted_io=False):
    """The JAX closure for one execution path."""
    jg, _, jl, _ = graphs
    jc = jlap.laplacian_coeffs(jg, eps)
    kw = {}
    if path == "dense":
        kw["dense"] = jlap.laplacian_dense(jg, jc)
    elif path in ("panel", "edge"):
        kw.update(block=(jl, JDT[dtype]), grad_space=path, permuted_io=permuted_io)
    return jmat.make_matern_precision_matvec(jg, jc, nu, ls, normalization, **kw)


def _torch_op(graphs, path, nu, normalization, eps=EPS, ls=LS, dtype="float32",
              permuted_io=False):
    """The port's Operator for one execution path."""
    _, tg, _, tl = graphs
    tc = tlap.laplacian_coeffs(tg, eps)
    kw = {}
    if path == "dense":
        kw["dense"] = tlap.laplacian_dense(tg, tc)
    elif path in ("panel", "edge"):
        kw.update(block=(tl, TDT[dtype]), grad_space=path, permuted_io=permuted_io)
    return tmat.make_matern_precision_matvec(tg, tc, nu, ls, normalization, **kw)


def _pair(graphs, *args, **kwargs):
    return _jax_op(graphs, *args, **kwargs), _torch_op(graphs, *args, **kwargs)


@pytest.mark.parametrize("normalization", ["symmetric", "randomwalk"])
@pytest.mark.parametrize("nu", [1, 2, 3])
@pytest.mark.parametrize("path", ["ell", "dense", "panel", "edge"])
def test_matern_precision_matvec_matches_jax(graphs, path, nu, normalization):
    jmv, tmv = _pair(graphs, path, nu, normalization)
    assert isinstance(tmv, Operator)
    v = _vec(graphs[0].num_nodes, seed=nu)
    _close(tmv(torch.from_numpy(v)).numpy(), jmv(jnp.asarray(v)))
    _close(tmv(torch.from_numpy(v[:, 0])).numpy(), jmv(jnp.asarray(v[:, 0])))  # [N] in, [N] out


@pytest.mark.parametrize("path", ["panel", "edge"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32x3"])
def test_block_precision_panel_types_and_permuted_io(graphs, path, dtype):
    jl, tl = graphs[2], graphs[3]
    jmv, tmv = _pair(graphs, path, 2, "randomwalk", dtype=dtype, permuted_io=True)
    v = _vec(jl.num_nodes, seed=7)
    want = jbs.permute_out(jl, jmv(jbs.permute_in(jl, jnp.asarray(v))))
    got = tbs.permute_out(tl, tmv(tbs.permute_in(tl, torch.from_numpy(v))))
    # nu = 2 chained applies; x3: merged-f32 (JAX CPU) vs three bf16 products
    _close(got.numpy(), want, tol=4e-4 if dtype == "float32x3" else VAL_TOL)


def test_randomwalk_precision_is_symmetric(graphs):
    tmv = _torch_op(graphs, "panel", 2, "randomwalk")
    q = tmv(torch.eye(graphs[1].num_nodes))
    np.testing.assert_allclose(q.numpy(), q.T.numpy(), atol=5e-6 * float(q.abs().max()))


@pytest.mark.parametrize("inverse_scale", [False, True])
def test_scale_and_noise_wrappers_match_jax(graphs, inverse_scale):
    jmv, tmv = _pair(graphs, "ell", 2, "randomwalk")
    v = _vec(graphs[0].num_nodes, seed=3)
    jq = jmat.make_noisy_matvec(
        jmat.make_scaled_matvec(jmv, jnp.float32(SCALE), inverse_scale), jnp.float32(NOISE))
    tq = tmat.make_noisy_matvec(
        tmat.make_scaled_matvec(tmv, torch.tensor(SCALE), inverse_scale), torch.tensor(NOISE))
    # consts compose by concatenation: the base operator's, then scale, then noise
    assert len(tq.consts) == len(tmv.consts) + 2
    _close(tq(torch.from_numpy(v)).numpy(), jq(jnp.asarray(v)))
    # a bare callable and python scalars are accepted like the JAX closures
    plain = tmat.make_noisy_matvec(tmat.make_scaled_matvec(lambda u: tmv(u), SCALE, inverse_scale),
                                   NOISE)
    _close(plain(torch.from_numpy(v)).numpy(), jq(jnp.asarray(v)))


@pytest.mark.parametrize("normalization", ["symmetric", "randomwalk"])
@pytest.mark.parametrize("nu", [1, 2, 3])
def test_precision_diag_and_noisy_scaled_diag_match_jax(graphs, nu, normalization):
    jg, tg = graphs[0], graphs[1]
    jc = jlap.laplacian_coeffs(jg, EPS)
    tc = tlap.laplacian_coeffs(tg, EPS)
    jd = jmat.matern_precision_diag(jg, jc, nu, LS, normalization)
    td = tmat.matern_precision_diag(tg, tc, nu, LS, normalization)
    _close(td.numpy(), jd)
    for scale, noise in ((None, None), (SCALE, None), (SCALE, NOISE), (40.0, 0.5)):
        js = None if scale is None else jnp.float32(scale)
        jn = None if noise is None else jnp.float32(noise)
        ts = None if scale is None else torch.tensor(scale)
        tn = None if noise is None else torch.tensor(noise)
        _close(tmat.noisy_scaled_diag(td, ts, tn).numpy(), jmat.noisy_scaled_diag(jd, js, jn))
    v = _vec(jg.num_nodes, seed=5)
    _close(tmat.make_jacobi_precond(td)(torch.from_numpy(v)).numpy(),
           jmat.make_jacobi_precond(jd)(jnp.asarray(v)))
    if nu <= 2:  # exact diagonals: hold them to the operator itself
        tmv = _torch_op(graphs, "ell", nu, normalization)
        q = tmv(torch.eye(tg.num_nodes))
        np.testing.assert_allclose(td.numpy(), torch.diagonal(q).numpy(), rtol=2e-5)


@pytest.mark.parametrize("path,dtype", [("ell", "float32"), ("dense", "float32"),
                                         ("panel", "float32"), ("edge", "float32"),
                                         ("panel", "bfloat16"), ("edge", "bfloat16")])
def test_precision_gradients_match_jax(graphs, path, dtype):
    """d/d(bandwidth), d/d(lengthscale) of v' Noise(Scale(Q)) v through every
    path, against jax.grad of the same composition."""
    n = graphs[0].num_nodes
    v = _vec(n, batch=2, seed=11)

    def jquad(eps, ls, scale, noise):
        mv = _jax_op(graphs, path, 2, "randomwalk", eps=eps, ls=ls, dtype=dtype)
        mv = jmat.make_noisy_matvec(jmat.make_scaled_matvec(mv, scale), noise)
        return jnp.sum(jnp.asarray(v) * mv(jnp.asarray(v)))

    jargs = tuple(jnp.float32(a) for a in (EPS, LS, SCALE, NOISE))
    jval, jgrads = jax.value_and_grad(jquad, argnums=(0, 1, 2, 3))(*jargs)

    targs = [torch.tensor(a, requires_grad=True) for a in (EPS, LS, SCALE, NOISE)]
    tmv = _torch_op(graphs, path, 2, "randomwalk", eps=targs[0], ls=targs[1], dtype=dtype)
    tmv = tmat.make_noisy_matvec(tmat.make_scaled_matvec(tmv, targs[2]), targs[3])
    tv = torch.from_numpy(v)
    tval = torch.sum(tv * tmv(tv))
    tgrads = torch.autograd.grad(tval, targs)
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=2e-5)
    # bf16 panel cotangents (panel path) round to 2^-8 per entry on both
    # sides, at slightly different f32 sums
    rtol = 2e-4 if dtype == "float32" else 5e-3
    np.testing.assert_allclose([float(g) for g in tgrads], [float(g) for g in jgrads],
                               rtol=rtol, atol=rtol * max(abs(float(g)) for g in jgrads))


def test_edge_gradients_match_panel(graphs):
    """Twin of tests/test_edge_cotangent.py: edge- and panel-space cotangents
    give the same gradients to f32 roundoff (f32 panels)."""
    n = graphs[0].num_nodes
    tv = torch.from_numpy(_vec(n, batch=4, seed=2))
    grads = {}
    for mode in ("edge", "panel"):
        eps = torch.tensor(EPS, requires_grad=True)
        ls = torch.tensor(LS, requires_grad=True)
        tmv = _torch_op(graphs, mode, 3, "randomwalk", eps=eps, ls=ls)
        grads[mode] = torch.autograd.grad(torch.sum(tv * tmv(tv)), (eps, ls))
    np.testing.assert_allclose([float(g) for g in grads["edge"]],
                               [float(g) for g in grads["panel"]], rtol=2e-5)


def test_edge_mode_panels_carry_no_gradient_and_bad_inputs_raise(graphs):
    _, tg, _, tl = graphs
    eps = torch.tensor(EPS, requires_grad=True)
    tc = tlap.laplacian_coeffs(tg, eps)
    op = tmat.make_matern_precision_matvec(tg, tc, 2, LS, block=(tl, None), grad_space="edge")
    assert not op.consts[0].requires_grad and op.consts[1].requires_grad
    with pytest.raises(ValueError, match="block-ELL"):
        tmat.make_matern_precision_matvec(tg, tc, 2, LS, block=(object(), None),
                                          grad_space="edge")
    with pytest.raises(ValueError, match="normalization"):
        tmat.make_matern_precision_matvec(tg, tc, 2, LS, "other", block=(tl, None))
    # the Schur complement composes over the edge-mode operator too: its
    # index-array entry point as JAX's over JAX's edge-mode operator, and
    # the masked form on full-length vectors
    labeled = np.arange(tg.num_nodes) % 4 == 0
    li, ui = tmat.labeled_split(labeled)
    schur = tmat.make_schur_matvec(op, li, ui, tg.num_nodes, cg_tol=1e-8, cg_max_iter=2000)
    assert schur.consts == op.consts
    v = _vec(len(li), batch=2, seed=5)
    jschur = jmat.make_schur_matvec(_jax_op(graphs, "edge", 2, "randomwalk"), li, ui,
                                    tg.num_nodes, cg_tol=1e-8, cg_max_iter=2000)
    _close(schur(torch.from_numpy(v)).detach().numpy(), jax.jit(jschur)(jnp.asarray(v)),
           tol=1e-5)
    ml = torch.from_numpy(labeled.astype(np.float32))
    masked = tmat.make_schur_matvec_masked(op, ml, 1.0 - ml)
    assert masked.consts == op.consts
    out = masked(ml[:, None] * torch.ones(tg.num_nodes, 2))
    assert torch.all(torch.isfinite(out)) and torch.all(out[torch.from_numpy(~labeled)] == 0)
