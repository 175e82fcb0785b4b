"""The semi-supervised training estimator in float64: the labeled block's
Schur complement of the kernel precision, its noisy composition, the
marginal likelihood by stochastic Lanczos quadrature on the given probes,
and its Hutchinson gradient, without differentiating through a solve.

  S     = Q_ll - Q_lu Q_uu^-1 Q_ul       (Q the unscaled kernel precision
                                          over every node, l / u the
                                          labeled / unlabeled nodes)
  p(x)  = x - noise x^2 + noise^2 x^3    (the 3-term Neumann composition)
  loss  = 0.5 (y' p(sS) y - logdet p(sS) + n_l log 2 pi) / n_l
  logdet p(sS) ~ SLQ on the probes (``train.slq_logdet``)
  d logdet     ~ (1 / p) sum_i u_i' dp(sS) z_i,   u_i = p(sS)^-1 z_i

Each apply of S is an inner Jacobi-preconditioned CG on Q_uu. With
v^ = [v; -Q_uu^-1 Q_ul v] (the inner solve's by-product):

  S v = (Q v^)_l        and        a' dS b = a^' dQ b^   (exactly),

so every bilinear form of dS is one of dQ between two detached hats, which
``operator.BlockOperator`` differentiates. dp(sS) expands into such forms,
with a and b from {a, Sa, S^2 a} and {b, Sb, S^2 b}; the scale and noise
enter through p's coefficients. (Autograd through Q inside one hatted
apply, (Q b^)_l, would differentiate half of dS only.)

The gradient's solves use p(sS) = sS r(sS), r(x) = 1 - noise x + noise^2 x^2
(whose eigenvalues lie above 3/4): u = r(sS)^-1 (Q^-1 [z; 0])_l / s, since
S^-1 = (Q^-1)_ll. The gradient's solves, inner ones included, run to
``train.SOLVE_TOL_FACTOR`` times the configuration's tolerance. The loss is
the estimator as configured: the program's probes, its Lanczos steps, and
inner solves to the configuration's own tolerance, which the loss's value
depends on (an inner CG stopped early overestimates S, and the loss with
it, by far more than the program's own error).
``loss(..., tol=...)`` takes another inner tolerance.
"""

from __future__ import annotations

import math

import torch

from .operator import Precision, values
from .train import Problem, cg, slq_logdet

MEMO = 8  # losses kept: the check asks for a step's loss more than once


class Schur:
    """S of one ``Precision`` over the labeled rows ``li`` (the rest ``ui``)."""

    def __init__(self, prec: Precision, li: torch.Tensor, ui: torch.Tensor, tol: float,
                 max_iter: int):
        self.prec, self.li, self.ui = prec, li, ui
        self.n = prec.coeffs.graph.n
        self.tol, self.max_iter = tol, max_iter
        self.diag_uu = prec.kernel_q_diag()[ui]

    def embed(self, rows: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        out = v.new_zeros((self.n, v.shape[1]))
        out[rows] = v
        return out

    def hat(self, v: torch.Tensor) -> torch.Tensor:
        """v^ = [v; -Q_uu^-1 Q_ul v], full length, node order."""
        q = self.prec.kernel_q
        out = self.embed(self.li, v)
        rhs = -q(out)[self.ui]
        w, _ = cg(lambda u: q(self.embed(self.ui, u))[self.ui], rhs, self.diag_uu, self.tol,
                  self.max_iter)
        out[self.ui] = w
        return out

    def apply(self, v: torch.Tensor):
        """(S v, v^)."""
        vh = self.hat(v)
        return self.prec.kernel_q(vh)[self.li], vh


class SemisupProblem(Problem):
    """One semi-supervised training problem: the graph over every node, the
    labels ``y`` of the nodes where ``labeled`` (a bool [n] tensor) is set."""

    def __init__(self, graph, y: torch.Tensor, labeled: torch.Tensor, gb_floor: float, nu: int,
                 inference: dict, precision: str = "f64"):
        super().__init__(graph, y, gb_floor, nu, inference, precision)
        self.li = torch.nonzero(labeled).flatten()
        self.ui = torch.nonzero(~labeled).flatten()
        self.loss_tol = float(inference["cg_tolerance"])  # the loss's inner solves
        self._losses = []  # (raw values and tolerance, probes, loss) of the last MEMO losses

    def schur(self, prec: Precision, tol: float = None) -> Schur:
        return Schur(prec, self.li, self.ui, self.tol if tol is None else tol, self.max_iter)

    def noisy(self, sch: Schur):
        """v -> p(sS) v, three applies of S."""
        s, noise = sch.prec.scale, sch.prec.noise

        def sq(v):
            return s * sch.apply(v)[0]
        return lambda v: sq(v - noise * sq(v - noise * sq(v)))

    @torch.no_grad()
    def loss(self, raw: dict, probes: torch.Tensor, tol: float = None) -> float:
        """The loss with inner solves to ``tol`` (the configuration's own
        tolerance by default)."""
        tol = self.loss_tol if tol is None else tol
        key = (tuple(float(v) for v in raw.values()), tol)
        for k, z, value in self._losses:
            if k == key and torch.equal(z, probes):
                return value
        noisy = self.noisy(self.schur(self.op(raw), tol))
        y = self.y[:, None]
        n = y.shape[0]
        quad = torch.sum(y * noisy(y))
        ld = slq_logdet(noisy, probes, self.steps)
        out = float(0.5 * (quad - ld + n * math.log(2.0 * math.pi)) / n)
        self._losses = self._losses[-(MEMO - 1):] + [(key, probes.clone(), out)]
        return out

    @torch.no_grad()
    def solve(self, sch: Schur, z: torch.Tensor) -> torch.Tensor:
        """p(sS)^-1 z = r(sS)^-1 (Q^-1 [z; 0])_l / s."""
        prec = sch.prec
        s, noise = prec.scale, prec.noise
        w, _ = cg(prec.kernel_q, sch.embed(self.li, z), prec.kernel_q_diag(), self.tol,
                  self.max_iter)

        def r(v):
            sv = s * sch.apply(v)[0]
            return v - noise * sv + noise * noise * s * sch.apply(sv)[0]
        ones = torch.ones(z.shape[0], dtype=z.dtype, device=z.device)
        u, _ = cg(r, w[self.li] / s, ones, self.tol, self.max_iter)
        return u

    @staticmethod
    def chain(sch: Schur, a: torch.Tensor):
        """([a, Sa, S^2 a], [a^, (Sa)^, (S^2 a)^])."""
        sa, ah = sch.apply(a)
        s2a, sah = sch.apply(sa)
        return [a, sa, s2a], [ah, sah, sch.hat(s2a)]

    def form_terms(self, sch: Schur, a_chain, b_chain, weight: float):
        """The pieces of weight * a' p(sS) b whose gradient is the form's:
        (left hats, right hats, weight) for sum(left * dQ right), and the
        detached numbers m_k = a' S^k b (k = 1, 2, 3) that p's
        coefficients multiply."""
        (a, sa, _), (ah, sah, s2ah) = a_chain
        (_, sb, s2b), (bh, sbh, s2bh) = b_chain
        s, noise = float(sch.prec.scale), float(sch.prec.noise)
        c1, c2, c3 = s, -noise * s * s, noise * noise * s ** 3
        m = torch.stack([torch.sum(a * sb), torch.sum(sa * sb), torch.sum(sa * s2b)])
        left = torch.cat([ah, sah, s2ah], dim=1)
        right = torch.cat([c1 * bh + c2 * sbh + c3 * s2bh, c2 * bh + c3 * sbh, c3 * bh], dim=1)
        return (left, right, weight), weight * m

    def loss_and_grad(self, raw: dict, probes: torch.Tensor, chunk: int = 16):
        """(loss, {leaf: gradient}) at ``raw`` (float64 leaves)."""
        n = self.y.shape[0]
        loss = self.loss(raw, probes)
        with torch.no_grad():
            sch = self.schur(self.op(raw))
            y = self.y[:, None]
            y_chain = self.chain(sch, y)
            quad_form, quad_m = self.form_terms(sch, y_chain, y_chain, 0.5 / n)
            u = self.solve(sch, probes)
            ld_form, ld_m = self.form_terms(sch, self.chain(sch, u), self.chain(sch, probes),
                                            -0.5 / (n * probes.shape[1]))
        leaves = {k: v.detach().clone().requires_grad_(k != "mean_constant")
                  for k, v in raw.items()}
        wanted = [leaves[k] for k in leaves if k != "mean_constant"]
        vals = values(leaves, self.gb_floor)
        s, noise = vals["outputscale"], vals["noise"]
        coeffs = torch.stack([s, -noise * s * s, noise * noise * s ** 3])
        grads = [torch.zeros_like(w) if g is None else g for w, g in zip(
            wanted, torch.autograd.grad(torch.sum(coeffs * (quad_m + ld_m)), wanted,
                                        allow_unused=True))]
        for left, right, weight in (quad_form, ld_form):
            for i in range(0, left.shape[1], chunk):
                prec = self.op(leaves, differentiable=True)
                term = weight * torch.sum(left[:, i:i + chunk]
                                          * prec.kernel_q(right[:, i:i + chunk]))
                for acc, g in zip(grads, torch.autograd.grad(term, wanted, allow_unused=True)):
                    if g is not None:
                        acc += g
        out = dict(zip([k for k in leaves if k != "mean_constant"], grads))
        out["mean_constant"] = torch.zeros_like(raw["mean_constant"])
        return loss, out
