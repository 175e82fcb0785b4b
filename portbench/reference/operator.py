"""The diffusion-maps Laplacian, the Matérn precision and its noisy
composition, in float64 from an edge list.

  w_e    = exp(-d_e^2 / (4 gb^2))
  q_i    = 1 + sum_{e at i} w_e
  a_e    = w_e / (q_row q_col)
  d_i    = q_i^-2 + sum_{e at i} a_e
  diag_i = (1 - q_i^-2 / d_i) / gb^2,   off_e = a_e / (sqrt(d_row d_col) gb^2)
  L_sym  = diag(diag) - A(off)
  Q      = D^1/2 (2 nu / l^2 I + L_sym)^nu D^1/2          (randomwalk)
  Qn     = s Q - noise (s Q)^2 + noise^2 (s Q)^3           (3-term Neumann)

Applies go through a CSR matrix (no gradient) or, where a gradient is
wanted, through gathers and index_add over the edge list.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F


def round_to(x: torch.Tensor, precision: str, per_column: bool = False) -> torch.Tensor:
    """``x`` stored in ``precision`` and read back in its own type; a
    gradient passes through the rounding unchanged. "fp8" scales the whole
    tensor (or, with ``per_column``, each column) to e4m3's range first."""
    if precision == "f64":
        return x
    with torch.no_grad():
        if precision == "fp8":
            if per_column and x.dim() == 2:
                amax = x.abs().amax(dim=0, keepdim=True)
            else:
                amax = x.abs().max()
            scale = torch.clamp(amax, min=1e-300) / 448.0
            r = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
        elif precision == "f32":
            r = x.to(torch.float32).to(x.dtype)
        elif precision == "bf16":
            r = x.to(torch.bfloat16).to(x.dtype)
        elif precision == "tf32":
            bits = x.to(torch.float32).view(torch.int32)
            bits = (bits + 0x1000) & ~0x1FFF  # round to 10 mantissa bits
            r = bits.view(torch.float32).to(x.dtype)
        else:
            raise ValueError(f"unknown precision {precision!r}")
    return x + (r - x).detach()


def softplus(x):
    return F.softplus(x, beta=1.0, threshold=1e9)


def values(raw: dict, gb_floor: float) -> dict:
    """Hyperparameter values from the raw parameters (softplus transforms;
    the noise above 1e-8, the graph bandwidth above its floor)."""
    return {
        "noise": softplus(raw["raw_noise"]) + 1e-8,
        "outputscale": softplus(raw["raw_outputscale"]),
        "lengthscale": softplus(raw["raw_lengthscale"]),
        "graphbandwidth": softplus(raw["raw_graphbandwidth"]) + gb_floor,
    }


def raw_from_values(vals: dict, gb_floor: float, dtype=torch.float64, device=None) -> dict:
    """The inverse of ``values`` (inverse softplus), plus a zero mean."""
    def inv(v):
        v = torch.as_tensor(v, dtype=dtype, device=device)
        return v + torch.log(-torch.expm1(-v))
    return {
        "raw_graphbandwidth": inv(vals["graphbandwidth"] - gb_floor),
        "raw_lengthscale": inv(vals["lengthscale"]),
        "raw_noise": inv(vals["noise"] - 1e-8),
        "raw_outputscale": inv(vals["outputscale"]),
        "mean_constant": torch.zeros((), dtype=dtype, device=device),
    }


class Graph:
    """Edge list (rows < cols) of n nodes, float64 squared lengths."""

    def __init__(self, rows, cols, sqdist, n: int):
        self.rows, self.cols, self.sqdist, self.n = rows, cols, sqdist, int(n)
        self.both_r = torch.cat([rows, cols])
        self.both_c = torch.cat([cols, rows])

    def incident(self, base, vals):
        return base.index_add(0, self.rows, vals).index_add(0, self.cols, vals)


class Coeffs:
    """Laplacian coefficients at one graph bandwidth (a tensor, which may
    carry a gradient)."""

    def __init__(self, graph: Graph, gb: torch.Tensor):
        g = graph
        eps2 = gb * gb
        w = torch.exp(-g.sqdist / (4.0 * eps2))
        q = g.incident(torch.ones(g.n, dtype=w.dtype, device=w.device), w)
        a = w / (q[g.rows] * q[g.cols])
        d = g.incident(q ** -2, a)
        self.graph = g
        self.deg = d
        self.deg_unnorm = q
        self.diag = (1.0 - q ** -2 / d) / eps2
        dsq = torch.sqrt(d)
        self.off = a / (dsq[g.rows] * dsq[g.cols]) / eps2

    def gershgorin(self):
        g = self.graph
        rowsum = g.incident(torch.zeros_like(self.diag), self.off.abs())
        return torch.max(self.diag + rowsum) * 1.01


class BlockOperator:
    """B = shift I + L_sym, applied as the port's block kernels apply it:
    coefficients and operand stored in ``precision``, accumulation in
    float64. ``differentiable``: applies by gathers (gradients reach the
    coefficients), else through a CSR matrix."""

    def __init__(self, coeffs: Coeffs, shift, precision: str = "f64",
                 differentiable: bool = False):
        g = coeffs.graph
        self.precision = precision
        self.differentiable = differentiable
        self.diag = coeffs.diag + shift
        self.off = coeffs.off
        if precision == "fp8":
            # one scale for the whole operator, as one panel buffer has
            both = round_to(torch.cat([self.diag, self.off]), precision)
            self.diag, self.off = both[:g.n], both[g.n:]
        else:
            self.diag = round_to(self.diag, precision)
            self.off = round_to(self.off, precision)
        self.graph = g
        if not differentiable:
            vals = torch.cat([-self.off, -self.off, self.diag]).detach()
            idx = torch.arange(g.n, device=vals.device)
            r = torch.cat([g.both_r, idx])
            c = torch.cat([g.both_c, idx])
            order = torch.argsort(r * g.n + c)
            crow = torch.zeros(g.n + 1, dtype=torch.int64, device=vals.device)
            crow[1:] = torch.cumsum(torch.bincount(r, minlength=g.n), 0)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)  # CSR support "in beta"
                self.csr = torch.sparse_csr_tensor(crow, c[order], vals[order], (g.n, g.n))

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        v = round_to(v, self.precision, per_column=True)
        if not self.differentiable:
            return self.csr @ v
        g = self.graph
        out = self.diag[:, None] * v
        out = out.index_add(0, g.rows, -self.off[:, None] * v[g.cols])
        return out.index_add(0, g.cols, -self.off[:, None] * v[g.rows])


class Precision:
    """The noisy, scaled Matérn precision Qn at raw parameters ``raw``."""

    def __init__(self, graph: Graph, raw: dict, gb_floor: float, nu: int,
                 precision: str = "f64", differentiable: bool = False):
        vals = values(raw, gb_floor)
        self.nu = nu
        self.coeffs = Coeffs(graph, vals["graphbandwidth"])
        shift = 2.0 * nu / vals["lengthscale"] ** 2
        self.block = BlockOperator(self.coeffs, shift, precision, differentiable)
        self.dsq = torch.sqrt(self.coeffs.deg)
        self.scale = vals["outputscale"]
        self.noise = vals["noise"]

    def kernel_q(self, v):
        """Q v, the unscaled kernel precision."""
        out = self.dsq[:, None] * v
        for _ in range(self.nu):
            out = self.block(out)
        return self.dsq[:, None] * out

    def __call__(self, v):
        """Qn v."""
        def sq(u):
            return self.scale * self.kernel_q(u)
        return sq(v - self.noise * sq(v - self.noise * sq(v)))

    def kernel_q_diag(self):
        """diag(Q): deg * diag(B^nu) for nu <= 2 (B^2's diagonal is diag^2
        plus the squared off-diagonals of each row)."""
        c = self.block
        if self.nu == 1:
            d = c.diag
        else:
            d = c.diag ** 2 + self.coeffs.graph.incident(torch.zeros_like(c.diag), c.off ** 2)
        return self.coeffs.deg * d

    def diag(self):
        """diag of Qn, by the composition applied to diag(Q) entrywise (a
        Jacobi preconditioner, not exact)."""
        q = self.scale * self.kernel_q_diag()
        return q * (1.0 - self.noise * q * (1.0 - self.noise * q))

