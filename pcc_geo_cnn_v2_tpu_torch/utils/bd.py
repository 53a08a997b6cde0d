"""Bjøntegaard-delta rate / PSNR between two RD curves.

The port's own copy of ``pcc_geo_cnn_v2_tpu/utils/bd.py`` (itself a port of
the reference's ``src/utils/bd.py``, derived from google/compare-codecs):
the PCHIP-interpolated variant (the reference author's addition, used for
every published BD number) and the classic cubic-polynomial fit. Deltas
integrate over the overlapping range of the two curves. Host numpy and
scipy only.
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import PchipInterpolator

__all__ = ["bdsnr", "bdrate"]


def _prep(metric_set, rate_axis_log=True):
    """Dedup exact pairs (as the reference does), sort by rate."""
    pts = np.unique(
        np.array([(float(r), float(p)) for r, p in metric_set]), axis=0
    )
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    rate, psnr = pts[:, 0], pts[:, 1]
    return (np.log(rate) if rate_axis_log else rate), psnr


def _avg_diff_pchip(x1, y1, x2, y2):
    """Mean (curve2 - curve1) over the overlapping x range via PCHIP."""
    if len(x1) < 2 or len(x2) < 2:
        raise ValueError("BD needs >=2 distinct points per curve")
    lo = max(x1.min(), x2.min())
    hi = min(x1.max(), x2.max())
    if hi <= lo:
        raise ValueError(
            f"BD curves have no overlapping range ([{lo:.3g}, {hi:.3g}])"
        )
    f1 = PchipInterpolator(x1, y1)
    f2 = PchipInterpolator(x2, y2)
    int1 = f1.integrate(lo, hi)
    int2 = f2.integrate(lo, hi)
    return (int2 - int1) / (hi - lo)


def _avg_diff_poly(x1, y1, x2, y2, order=3):
    if len(x1) < 2 or len(x2) < 2:
        raise ValueError("BD needs >=2 distinct points per curve")
    lo = max(x1.min(), x2.min())
    hi = min(x1.max(), x2.max())
    if hi <= lo:
        raise ValueError(
            f"BD curves have no overlapping range ([{lo:.3g}, {hi:.3g}])"
        )
    p1 = np.polyint(np.polyfit(x1, y1, order))
    p2 = np.polyint(np.polyfit(x2, y2, order))
    int1 = np.polyval(p1, hi) - np.polyval(p1, lo)
    int2 = np.polyval(p2, hi) - np.polyval(p2, lo)
    return (int2 - int1) / (hi - lo)


def bdsnr(metric_set1, metric_set2, pchip=True):
    """BD-PSNR (dB): average PSNR gain of set2 over set1 at equal rate.

    :param metric_set1/2: iterables of (rate, psnr) tuples.
    """
    x1, y1 = _prep(metric_set1)
    x2, y2 = _prep(metric_set2)
    if pchip:
        return float(_avg_diff_pchip(x1, y1, x2, y2))
    return float(_avg_diff_poly(x1, y1, x2, y2))


def bdrate(metric_set1, metric_set2, pchip=True):
    """BD-rate (%): average rate change of set2 vs set1 at equal quality
    (negative = set2 cheaper)."""
    r1, p1 = _prep(metric_set1)
    r2, p2 = _prep(metric_set2)
    # axes swapped: integrate log-rate over psnr; psnr must be increasing
    o1 = np.argsort(p1)
    o2 = np.argsort(p2)
    if pchip:
        avg_exp_diff = _avg_diff_pchip(p1[o1], r1[o1], p2[o2], r2[o2])
    else:
        avg_exp_diff = _avg_diff_poly(p1[o1], r1[o1], p2[o2], r2[o2])
    return float((np.exp(avg_exp_diff) - 1) * 100)
