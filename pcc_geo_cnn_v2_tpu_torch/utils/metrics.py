"""PSNR helper (port of ``psnr`` in ``pcc_geo_cnn_v2_tpu/utils/metrics.py``)."""

from __future__ import annotations

import numpy as np

__all__ = ["psnr"]


def psnr(mse, max_energy):
    if np.ndim(mse) == 0 and mse == 0:
        return np.inf  # perfect reconstruction (numpy would warn-and-inf)
    return 10 * np.log10(max_energy / mse)
