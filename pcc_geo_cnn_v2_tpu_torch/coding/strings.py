"""What a model's block becomes as strings, and back: the one owner of
every model family's string format, read from what the model is (whether
it has a z, its ``num_slices``), never from its class.

A block is ``(y, z)``, or ``(y,)`` without a z. z is coded under the
factorized prior (its refined quantiles), one CDF row a channel, NDHWC.
y without a z likewise; with a z under the Gaussian table at the scale
rows that the decoder derives on the device (the model's ``decode_hyper``
/ ``slice_params``), NDHWC for one slice and NCDHW for a sliced model, so
that each slice is one run of the string for the resumable decoder.
"""

from __future__ import annotations

import numpy as np

from pcc_geo_cnn_v2_tpu_torch.coding import range_coder as rc
from pcc_geo_cnn_v2_tpu_torch.models.entropy import (
    build_factorized_cdf,
    build_gaussian_cdf,
)

__all__ = ["StringFormat"]


def _channel_rows(shape):
    """One CDF row a channel: the rows of an NDHWC array of ``shape``."""
    return np.broadcast_to(np.arange(shape[-1], dtype=np.int32), shape)


class StringFormat:
    """The strings of one model's blocks of one y shape."""

    def __init__(self, model, y_shape, eb=None):
        """:param y_shape: one block's y, NDHWC ``(D/8, H/8, W/8, C)``.
        :param eb: the factorized prior's parameters (flax names, numpy
            leaves, quantiles refined); the model's own when None."""
        if eb is None:
            eb = {k: v.detach().cpu().numpy()
                  for k, v in model.entropy_bottleneck.state_dict().items()}
        self.eb_table = build_factorized_cdf(eb)
        self.has_z = hasattr(model, "hyper_analysis_t")
        self.sliced = model.num_slices > 1
        self.y_shape = tuple(y_shape)
        self.z_shape = tuple(-(-n // 2) for n in y_shape[:3]) + (
            self.y_shape[3],)
        self.y_table = (build_gaussian_cdf(model.conditional.scale_table,
                                           model.conditional.tail_mass)
                        if self.has_z else self.eb_table)
        # the per-block host arrays a block's strings are coded from
        self.keys = ("z_sym", "y_sym", "y_idx") if self.has_z else ("y_sym",)

    def y_order(self, a):
        """NDHWC y arrays (``[..., b, b, b, C]``) in the string's order."""
        return np.moveaxis(a, -1, -4) if self.sliced else a

    def ndhwc(self, a):
        """Inverse of :meth:`y_order`."""
        return np.moveaxis(a, -4, -1) if self.sliced else a

    def encode(self, out):
        """Every block's strings from :attr:`keys`' host arrays (NDHWC):
        a list of ``(y, z)`` (``(y,)``)."""
        rows = (self.y_order(out["y_idx"]) if self.has_z
                else _channel_rows(self.y_shape))
        y = rc.encode_batch(self.y_order(out["y_sym"]), rows, self.y_table)
        if not self.has_z:
            return [(s,) for s in y]
        return list(zip(y, rc.encode_batch(
            out["z_sym"], _channel_rows(self.z_shape), self.eb_table)))

    def encode_one(self, out, i):
        """Block ``i``'s strings: entry ``i`` of :meth:`encode`."""
        return self.encode({k: out[k][i:i + 1] for k in self.keys})[0]

    def decode_z(self, strings):
        """The blocks' z symbols, int32 ``[n, *z_shape]``; ``[n, 0]``
        without a z."""
        if not self.has_z:
            return np.zeros((len(strings), 0), np.int32)
        return rc.decode_batch([s[1] for s in strings],
                               _channel_rows(self.z_shape), self.eb_table,
                               per_stream=False)

    def y_decoder(self, strings):
        """The resumable decoder of the blocks' y strings:
        ``decode(rows, lo, hi)`` gives the next symbols of blocks
        ``lo`` … ``hi - 1``, shaped like their rows (:meth:`host_rows`)."""
        return rc.BatchDecoder([s[0] for s in strings], self.y_table)

    def host_rows(self, rows, m):
        """The y rows of ``m`` blocks on the host: the first ``m`` of the
        device ``rows`` (a model's ``slice_params``), or, None without a
        z, the factorized prior's channel rows."""
        if rows is None:
            return np.broadcast_to(_channel_rows(self.y_shape),
                                   (m,) + self.y_shape)
        return rows[:m].cpu().numpy()
