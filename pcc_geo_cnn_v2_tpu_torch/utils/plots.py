"""Shared matplotlib styling for RD figures and paper artifacts.

The port's own copy of ``pcc_geo_cnn_v2_tpu/utils/plots.py``: the
reference's ``src/utils/matplotlib_utils.py`` (rcParams presets, marker /
linestyle cycles, standalone shared legends, ``:32-55``) and
``src/utils/colorbar.py`` (colorbar and cmap factory, ``:6-22``).
matplotlib is imported inside the functions that draw.
"""

from __future__ import annotations

import itertools
import logging

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "set_paper_style",
    "style_cycle",
    "style_for",
    "render_standalone_legend",
    "make_colorbar",
]

MARKERS = "osv^D<>ph*"
LINESTYLES = ["-", "--", "-.", ":"]


def set_paper_style(latex=False, font_size=9):
    """Apply the shared rcParams preset (serif fonts, light grids).

    ``latex=True`` turns on TeX text rendering like the reference's paper
    figures; leave it off unless a TeX toolchain is installed.
    """
    import matplotlib

    matplotlib.rcParams.update({
        "font.family": "serif",
        "font.size": font_size,
        "axes.grid": True,
        "grid.alpha": 0.4,
        "legend.framealpha": 0.8,
        "figure.dpi": 150,
        "savefig.bbox": "tight",
        "text.usetex": bool(latex),
    })


def style_cycle():
    """Endless (marker, linestyle) pairs in a fixed order, so that a mode
    keeps its marker in every plot of a comparison sweep."""
    return itertools.cycle(
        [(m, ls) for ls in LINESTYLES for m in MARKERS])


def style_for(mode, style_order=None):
    """(marker, linestyle) for ``mode``, keyed by its position in
    ``style_order`` (the sweep's global sorted mode list), so that a mode
    keeps its style in every figure even where a figure lacks some modes."""
    table = [(m, ls) for ls in LINESTYLES for m in MARKERS]
    if style_order and mode in style_order:
        return table[list(style_order).index(mode) % len(table)]
    return table[hash(mode) % len(table)]


def render_standalone_legend(labels, out_path, ncol=None, figsize=None):
    """Write a legend-only figure shared by a grid of RD plots: one
    horizontal strip with each mode's marker and linestyle, cropped to the
    legend (reference ``matplotlib_utils.py:32-55``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = list(labels)
    ncol = ncol or min(len(labels), 5)
    fig = plt.figure(figsize=figsize or (max(2, 1.6 * ncol), 0.6))
    ax = fig.add_subplot(111)
    handles = []
    for label in labels:
        marker, ls = style_for(label, labels)
        (h,) = ax.plot([], [], marker=marker, linestyle=ls, label=label,
                       markersize=4)
        handles.append(h)
    ax.axis("off")
    legend = ax.legend(handles, labels, loc="center", ncol=ncol,
                       frameon=False, fontsize=8)
    fig.canvas.draw()
    bbox = legend.get_window_extent().transformed(
        fig.dpi_scale_trans.inverted())
    fig.savefig(out_path, dpi=200, bbox_inches=bbox)
    plt.close(fig)
    logger.info("wrote %s", out_path)


def make_colorbar(vmax, cmap="inferno", label="squared error",
                  figsize=(0.5, 3.2)):
    """Standalone vertical colorbar figure for error-map renders
    (reference ``colorbar.py:6-22``). Returns (fig, cmap_fn): the caller
    saves and closes; cmap_fn maps [0, vmax] errors to RGB rows."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colorbar import ColorbarBase
    from matplotlib.colors import Normalize

    fig, ax = plt.subplots(figsize=figsize)
    norm = Normalize(vmin=0.0, vmax=vmax)
    ColorbarBase(ax, cmap=plt.get_cmap(cmap), norm=norm, label=label)
    fig.tight_layout()
    cmap_fn = lambda err: plt.get_cmap(cmap)(  # noqa: E731
        norm(np.asarray(err, np.float64)))[..., :3]
    return fig, cmap_fn
