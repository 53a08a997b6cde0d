"""Point-cloud rendering for figures: error maps, comparisons, colorbars.

The port's own copy of ``pcc_geo_cnn_v2_tpu/utils/render.py`` (the
reference drove Open3D's offscreen renderer, ``src/utils/o3d.py``,
``ut_run_render.py``). Open3D is optional: the CLIs use it when it is
installed; otherwise a dependency-free orthographic splat renderer on
numpy makes the paper artifacts (renders, per-point D1 error colormaps,
error histograms). All host code; matplotlib, scipy and open3d are
imported inside the functions that use them.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["ortho_render", "error_colormap", "render_comparison",
           "have_open3d"]


def have_open3d():
    try:
        import open3d  # noqa: F401

        return True
    except ImportError:
        return False


def ortho_render(points, colors=None, axis=2, img_size=1024, flip=True):
    """Orthographic z-buffer splat along ``axis`` → [H, W, 3] float image.

    Points closest to the camera win (max depth order). ``flip`` changes
    nothing, as in the JAX package, so that both give the same images.
    """
    points = np.asarray(points, np.float64)
    if colors is None:
        colors = np.full((len(points), 3), 0.7)
    colors = np.asarray(colors, np.float64)
    if colors.max() > 1.0:
        colors = colors / 255.0
    axes = [a for a in range(3) if a != axis]
    lo = points[:, axes].min(axis=0)
    hi = points[:, axes].max(axis=0)
    span = max((hi - lo).max(), 1e-9)
    uv = ((points[:, axes] - lo) / span * (img_size - 1)).astype(int)
    order = np.argsort(points[:, axis])  # far first; near overwrites
    img = np.ones((img_size, img_size, 3))
    u, v = uv[order, 0], uv[order, 1]
    img[img_size - 1 - v, u] = colors[order]
    return img


def error_colormap(points, reference_points, cmap="inferno", vmax=None):
    """Per-point D1 error colours (reference ``ut_run_render.py:149-251``):
    (colours [N, 3], squared errors [N], vmax)."""
    from matplotlib import pyplot as plt
    from scipy.spatial import cKDTree

    t = cKDTree(np.asarray(reference_points)[:, :3], balanced_tree=False)
    d, _ = t.query(np.asarray(points)[:, :3], workers=-1)
    err = d ** 2
    if vmax is None:
        vmax = max(np.percentile(err, 99), 1e-9)
    norm = np.clip(err / vmax, 0, 1)
    colors = plt.get_cmap(cmap)(norm)[:, :3]
    return colors, err, vmax


def render_comparison(ori_points, dec_points, out_png, axis=2,
                      img_size=1024, with_colorbar=True):
    """Side-by-side original / decoded render, error map and histogram.

    ``with_colorbar`` also writes ``<out_png>.colorbar.png``, the
    standalone error-scale strip the reference pairs with its error-map
    renders (``ut_run_render.py:149-251`` and ``colorbar.py``).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from pcc_geo_cnn_v2_tpu_torch.utils.plots import make_colorbar

    colors, err, vmax = error_colormap(dec_points, ori_points)
    if with_colorbar:
        cb_fig, _ = make_colorbar(vmax)
        cb_fig.savefig(str(out_png) + ".colorbar.png", dpi=200)
        plt.close(cb_fig)
    fig, axs = plt.subplots(1, 3, figsize=(13, 4.5))
    axs[0].imshow(ortho_render(ori_points, axis=axis, img_size=img_size))
    axs[0].set_title(f"original ({len(ori_points)} pts)")
    axs[1].imshow(ortho_render(dec_points, colors, axis=axis,
                               img_size=img_size))
    axs[1].set_title(f"decoded ({len(dec_points)} pts), D1 err ≤ {vmax:.2f}")
    axs[2].hist(err, bins=50, log=True)
    axs[2].set_title("per-point squared error")
    for ax in axs[:2]:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_png, dpi=130)
    plt.close(fig)
    logger.info("wrote %s", out_png)
