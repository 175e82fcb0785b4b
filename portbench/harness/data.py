"""The campaign's inputs and set-up arithmetic, frozen here.

Copied from ``examples_torch/run_large.py`` (``torus_points``,
``curve_points``, ``campaign_data``, the unit-bandwidth rescale and the
bandwidth floor of ``build_campaign``), so that the benchmark's yardstick
stays the same whatever later changes make to the examples. Host numpy,
vectorized; everything is a function of the seed.
"""

from __future__ import annotations

import numpy as np


def curve_points(n: int, seed: int = 0):
    """Noisy closed 3D curve (cos t, sin t, 0.3 sin 2t) and its parameter t."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    x = np.stack([np.cos(t), np.sin(t), 0.3 * np.sin(2 * t)], axis=1).astype(np.float32)
    x += (0.1 / n) * rng.standard_normal(x.shape).astype(np.float32)
    return x, t


def torus_points(n: int, seed: int = 0, big_r: float = 1.0, small_r: float = 0.4):
    """n samples uniform on the surface of a torus in R^3, with the (u, v)
    angles (v drawn from the area element by rejection)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.0, 2 * np.pi, n).astype(np.float32)
    v = np.empty(n, np.float32)
    filled = 0
    while filled < n:
        cand = rng.uniform(0.0, 2 * np.pi, 2 * (n - filled))
        acc = rng.uniform(0.0, 1.0, cand.shape[0]) < (
            (1.0 + (small_r / big_r) * np.cos(cand)) / (1.0 + small_r / big_r)
        )
        take = cand[acc][: n - filled]
        v[filled : filled + take.shape[0]] = take
        filled += take.shape[0]
    x = np.stack(
        [
            (big_r + small_r * np.cos(v)) * np.cos(u),
            (big_r + small_r * np.cos(v)) * np.sin(u),
            small_r * np.sin(v),
        ],
        axis=1,
    ).astype(np.float32)
    return x, u, v


def campaign_data(n: int, num_test: int, seed: int, manifold: str):
    """The campaign's sample of ``manifold``, labels y_true + 0.1 N(0, 1),
    the split and the label normalization by train statistics: (train_x,
    test_x, train_y, test_y, test_y_true, std_y)."""
    rng = np.random.default_rng(seed)
    if manifold == "torus":
        x_all, u_all, v_all = torus_points(n, seed=seed)
        y_true = np.sin(2 * u_all) + 0.5 * np.cos(3 * u_all) * np.sin(2 * v_all)
    elif manifold == "curve":
        x_all, t_all = curve_points(n, seed=seed)
        y_true = np.sin(3 * t_all) + 0.5 * np.sin(7 * t_all)
    else:
        raise ValueError(f"unknown manifold {manifold!r}")
    y_noisy = (y_true + 0.1 * rng.standard_normal(n)).astype(np.float32)
    perm = rng.permutation(n)
    test_idx = perm[:num_test]
    train_idx = np.sort(perm[num_test:])
    mu_y, std_y = y_noisy[train_idx].mean(), y_noisy[train_idx].std(ddof=1)
    return (x_all[train_idx], x_all[test_idx], (y_noisy[train_idx] - mu_y) / std_y,
            (y_noisy[test_idx] - mu_y) / std_y, (y_true[test_idx] - mu_y) / std_y, std_y)


def query_points(manifold: str, count: int, seed: int) -> np.ndarray:
    """``count`` new points on ``manifold``, where the posterior is asked:
    uniform on the torus's surface, or at uniform parameters on the curve."""
    if manifold == "torus":
        return torus_points(count, seed=seed)[0]
    if manifold == "curve":
        t = np.random.default_rng(seed).uniform(0.0, 2 * np.pi, count)
        return np.stack([np.cos(t), np.sin(t), 0.3 * np.sin(2 * t)], axis=1).astype(np.float32)
    raise ValueError(f"unknown manifold {manifold!r}")


def unit_bandwidth(sqdist: np.ndarray) -> float:
    """The campaign's coordinate scale eps: twice the median edge length, so
    that the rescaled graph has unit bandwidth (points and test points are
    divided by it, squared edge lengths by its square)."""
    return 2.0 * float(np.sqrt(np.median(sqdist)))


def bandwidth_floor(rows: np.ndarray, cols: np.ndarray, sqdist: np.ndarray,
                    num_nodes: int) -> float:
    """The campaign's data-driven floor of the graph bandwidth: every node's
    nearest edge weight exp(-d^2 / (4 gb^2)) stays above 1e-4."""
    min_edge = np.full(num_nodes, np.inf, np.float32)
    np.minimum.at(min_edge, rows, sqdist)
    np.minimum.at(min_edge, cols, sqdist)
    return float(np.sqrt(min_edge.max() / (4.0 * np.log(1e4))))
