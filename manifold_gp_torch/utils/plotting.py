"""Plot helpers (port of ``manifold_gp_tpu.utils.plotting``; reference
``manifold_gp/utils/plot_helper.py:7-178``): custom colormaps whose center /
edge fades to a (transparent) anchor color, compact colorbars, figure
beautifiers, and a 1D-mesh line-collection plot colored by a scalar field.

On matplotlib's colormap machinery, imported only inside each function, so
that a headless run never pays for it. The data are numpy arrays (or CPU
tensors, which ``np.asarray`` takes as they are); nothing here touches a
tensor on the card.
"""

from __future__ import annotations

import numpy as np

_TRANSPARENT_WHITE = (1.0, 1.0, 1.0, 0.0)


def _base_cmap(name):
    import matplotlib.pyplot as plt

    return plt.get_cmap(name)


def colormap_diverging(
    colormap: str,
    vmin: float,
    vmax: float,
    center_color=_TRANSPARENT_WHITE,
    res: int = 1000,
):
    """Diverging colormap anchored so that *data value 0* maps to
    ``center_color`` (default: transparent white) for an asymmetric
    [vmin, vmax] range — the reference's transparent-center diverging map
    (plot_helper.py:7-53). Values below/above 0 sample the lower/upper half
    of ``colormap``.
    """
    import matplotlib.colors as mcolors

    assert vmin < 0 < vmax, "diverging map needs vmin < 0 < vmax"
    cmap = _base_cmap(colormap)
    span = vmax - vmin
    pivot = abs(vmin) / span  # where 0 lands in [0, 1]
    xs = np.linspace(0.0, 1.0, res)
    rgba = np.empty((res, 4))
    lower = xs < pivot
    # lower half: cmap[0, 0.5] stretched onto [0, pivot], fading into the
    # center color near the pivot; mirrored for the upper half.
    t_lo = xs[lower] / max(pivot, 1e-12)
    rgba[lower] = cmap(0.5 * t_lo)
    t_hi = (xs[~lower] - pivot) / max(1.0 - pivot, 1e-12)
    rgba[~lower] = cmap(0.5 + 0.5 * t_hi)
    # blend toward the center color within a window around the pivot
    w = 0.5 / 10  # one color-step of the reference's 0.1 sampling
    blend = np.clip(1.0 - np.abs(xs - pivot) / w, 0.0, 1.0)
    center = np.asarray(center_color, float)
    rgba = rgba * (1.0 - blend[:, None]) + center[None, :] * blend[:, None]
    return mcolors.ListedColormap(rgba)


def colormap_left(colormap: str, left_color=_TRANSPARENT_WHITE, res: int = 1000):
    """One-sided colormap fading to ``left_color`` at the low end
    (reference plot_helper.py:56-85)."""
    import matplotlib.colors as mcolors

    cmap = _base_cmap(colormap)
    xs = np.linspace(0.0, 1.0, res)
    rgba = np.asarray(cmap(xs))
    w = 0.1
    blend = np.clip(1.0 - xs / w, 0.0, 1.0)
    left = np.asarray(left_color, float)
    rgba = rgba * (1.0 - blend[:, None]) + left[None, :] * blend[:, None]
    return mcolors.ListedColormap(rgba)


def colormap_right(colormap: str, right_color=_TRANSPARENT_WHITE, res: int = 1000):
    """One-sided colormap fading to ``right_color`` at the high end."""
    import matplotlib.colors as mcolors

    cmap = _base_cmap(colormap)
    xs = np.linspace(0.0, 1.0, res)
    rgba = np.asarray(cmap(xs))
    w = 0.1
    blend = np.clip(1.0 - (1.0 - xs) / w, 0.0, 1.0)
    right = np.asarray(right_color, float)
    rgba = rgba * (1.0 - blend[:, None]) + right[None, :] * blend[:, None]
    return mcolors.ListedColormap(rgba)


def colorbar(im, fig, ax, pos: str = "left", size: str = "5%", pad: float = 0.2,
             ticks=None):
    """Frameless side colorbar (reference plot_helper.py:117-133)."""
    from mpl_toolkits.axes_grid1 import make_axes_locatable

    divider = make_axes_locatable(ax)
    cax = divider.append_axes(pos, size=size, pad=pad)
    cbar = fig.colorbar(im, cax=cax, ticks=ticks)
    cax.yaxis.set_ticks_position(pos)
    cbar.outline.set_visible(False)
    if ticks is None:
        cbar.set_ticks([])
    return cbar


def beautify(fig, ax):
    """Hide axes/frames, equalize aspect, tighten layout
    (reference plot_helper.py:136-157)."""
    ax.axes.get_xaxis().set_visible(False)
    ax.axes.get_yaxis().set_visible(False)
    fig.patch.set_visible(False)
    ax.axis("off")
    ax.axis("equal")
    fig.tight_layout()


def plot_1D_mesh(fig, ax, vertices, edges, values, cmap: str = "viridis",
                 linewidth: float = 5.0):
    """Plot a 1D mesh embedded in 2D as a line collection colored by a
    per-edge scalar (reference plot_helper.py:159-178)."""
    import matplotlib.pyplot as plt
    from matplotlib.collections import LineCollection

    vertices = np.asarray(vertices, float).reshape(-1, 1, 2)
    edges = np.asarray(edges, int)
    values = np.asarray(values, float)
    segments = np.concatenate(
        [vertices[edges[:, 0]], vertices[edges[:, 1]]], axis=1
    )
    norm = plt.Normalize(values.min(), values.max())
    lc = LineCollection(segments, cmap=cmap, norm=norm)
    lc.set_array(values)
    lc.set_linewidth(linewidth)
    line = ax.add_collection(lc)
    fig.colorbar(line, ax=ax)
    ax.set_xlim(vertices[:, 0, 0].min(), vertices[:, 0, 0].max())
    ax.set_ylim(vertices[:, 0, 1].min(), vertices[:, 0, 1].max())
    ax.axis("equal")
    return line
