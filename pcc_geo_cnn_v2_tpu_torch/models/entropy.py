"""Entropy models: factorized prior + conditional Gaussian.

Port of ``pcc_geo_cnn_v2_tpu/models/entropy.py``. Symbol quantization,
dequantization and the Gaussian scale-index map run as torch ops in f32
(the JAX package quantizes in f32 too). The CDF-table builders are the
JAX package's float64 numpy code, copied verbatim so that the port's
tables are byte-equal to the reference's.

Training half: the likelihoods of both models, the factorized prior's
``aux_loss`` and the ``lower_bound`` custom gradient. The training noise is
an argument (NDHWC, the shape of the tensor it is added to): the JAX
package draws it inside the modules from ``jax.random`` keys, which the
port cannot reproduce, so parity tests pass JAX's draws in.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy.special import erfc as _erfc
from torch import nn

__all__ = [
    "lower_bound",
    "FactorizedPrior",
    "GaussianConditional",
    "CdfTable",
    "pmf_to_quantized_cdf",
    "refine_factorized_quantiles",
    "build_factorized_cdf",
    "build_gaussian_cdf",
    "default_scale_table",
]

LIKELIHOOD_BOUND = 1e-9
RANGE_CODER_PRECISION = 16


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x, bound):
    """max(x, bound) with a gradient that can push x back up: it passes
    where ``x >= bound`` or where the upstream gradient would increase x
    (tfc's ``math_ops.lower_bound``, JAX ``models/entropy.py:52-73``)."""
    return _LowerBound.apply(x, float(bound))


def default_scale_table(scales_min=0.11, scales_max=256.0, levels=64):
    """Log-spaced scale table (reference ``model_types.py:324``)."""
    return np.exp(np.linspace(np.log(scales_min), np.log(scales_max), levels))


class FactorizedPrior(nn.Module):
    """Learned per-channel factorized density (flax names kept so that
    :func:`pcc_geo_cnn_v2_tpu_torch.weights.params_from_jax` maps them
    one to one). Inference uses only ``quantiles``; training evaluates the
    density on ``[C, 1, M]`` views of NDHWC tensors, as the JAX module."""

    def __init__(self, channels, filters=(3, 3, 3), init_scale=10.0,
                 tail_mass=1e-9):
        super().__init__()
        self.channels, self.filters = channels, tuple(filters)
        self.init_scale, self.tail_mass = init_scale, tail_mass
        dims = (1,) + self.filters + (1,)
        for k in range(len(filters) + 1):
            self.register_parameter(f"matrix_{k}", nn.Parameter(
                torch.zeros(channels, dims[k + 1], dims[k])))
            self.register_parameter(f"bias_{k}", nn.Parameter(
                torch.zeros(channels, dims[k + 1], 1)))
            if k < len(filters):
                self.register_parameter(f"factor_{k}", nn.Parameter(
                    torch.zeros(channels, dims[k + 1], 1)))
        self.quantiles = nn.Parameter(torch.zeros(channels, 3))

    @torch.no_grad()
    def reset_parameters(self, generator):
        """flax's initial distributions (not its numbers): matrices
        ``log(expm1(1 / scale / dims[k + 1]))``, biases U(-0.5, 0.5) drawn
        from ``generator`` (a CPU one), factors 0, quantiles ``[-s, 0, s]``
        with s = ``init_scale``."""
        dims = (1,) + self.filters + (1,)
        scale = self.init_scale ** (1.0 / (len(self.filters) + 1))
        for k in range(len(self.filters) + 1):
            getattr(self, f"matrix_{k}").fill_(
                float(np.log(np.expm1(1.0 / scale / dims[k + 1]))))
            bias = getattr(self, f"bias_{k}")
            bias.copy_(torch.rand(bias.shape, generator=generator) - 0.5)
            if k < len(self.filters):
                getattr(self, f"factor_{k}").zero_()
        self.quantiles.copy_(torch.tensor(
            [-self.init_scale, 0.0, self.init_scale]).expand(
                self.channels, 3))

    def _logits_cumulative(self, x, stop_params=False):
        """Monotone logit of the cumulative; x: [C, 1, M] -> [C, 1, M].
        ``stop_params`` detaches the density parameters (the aux loss moves
        only the quantiles)."""
        sg = (lambda t: t.detach()) if stop_params else (lambda t: t)
        u = x
        for k in range(len(self.filters) + 1):
            m = F.softplus(sg(getattr(self, f"matrix_{k}")))
            u = torch.matmul(m, u) + sg(getattr(self, f"bias_{k}"))
            if k < len(self.filters):
                u = u + torch.tanh(sg(getattr(self, f"factor_{k}"))) \
                    * torch.tanh(u)
        return u

    def _likelihood(self, y_cm):
        """Likelihood of integer-width bins at y; y_cm: [C, 1, M]."""
        lo = self._logits_cumulative(y_cm - 0.5)
        hi = self._logits_cumulative(y_cm + 0.5)
        # evaluate in whichever tail is more precise (tfc sign trick)
        sign = -torch.sign(lo + hi).detach()
        return torch.abs(torch.sigmoid(sign * hi) - torch.sigmoid(sign * lo))

    def forward(self, y, training, noise=None):
        """(y_tilde, likelihoods) of NDHWC ``y``: ``y + noise`` when
        training (``noise`` U(-0.5, 0.5), y's shape), else rounded around
        the medians."""
        c = y.shape[-1]
        if training:
            if noise is None:
                raise ValueError("training quantization needs the noise")
            y_tilde = y + noise
        else:
            y_tilde = torch.round(y - self.medians()) + self.medians()
        flat = torch.movedim(y_tilde, -1, 0).reshape(c, 1, -1)
        p = lower_bound(self._likelihood(flat), LIKELIHOOD_BOUND)
        return y_tilde, torch.movedim(p.reshape((c,) + y.shape[:-1]), 0, -1)

    def aux_loss(self):
        """Drives the quantiles to the (t/2, 1/2, 1 - t/2) cumulative
        targets (the reference minimizes it with its own Adam(1e-3))."""
        logits = self._logits_cumulative(self.quantiles[:, None, :],
                                         stop_params=True)
        t = self.tail_mass
        targets = torch.log(
            torch.tensor([t / 2, 0.5, 1 - t / 2], dtype=torch.float32)
            / torch.tensor([1 - t / 2, 0.5, t / 2], dtype=torch.float32))
        return torch.sum(torch.abs(logits[:, 0, :]
                                   - targets.to(logits.device)))

    def medians(self):
        return self.quantiles[:, 1]

    def quantize_symbols(self, y):
        """Integer symbols round(y - median); y is [..., C]."""
        return torch.round(y - self.medians()).to(torch.int32)

    def dequantize_symbols(self, symbols):
        return symbols.to(torch.float32) + self.medians()


def _std_cumulative(x):
    """Standardized Gaussian CDF via erfc (stable left tail)."""
    return 0.5 * torch.special.erfc(-x / math.sqrt(2.0))


@dataclasses.dataclass(frozen=True)
class GaussianConditional:
    """Gaussian entropy model with a fixed scale table, zero-mean unless a
    location ``loc`` (μ, broadcast like ``y``) is given: the likelihood is
    then that of y − μ, the symbols are round(y − μ) and they dequantize
    to symbols + μ (the mean-scale model of the channel-wise context
    model, ``CompressionModelCW``)."""

    scale_table: np.ndarray = dataclasses.field(
        default_factory=default_scale_table)
    tail_mass: float = 2.0 ** -8

    def bound_scale(self, sigma):
        """Inference: the forward of :func:`lower_bound`."""
        return torch.clamp_min(sigma, float(self.scale_table[0]))

    def likelihood(self, y, sigma, loc=None):
        """P(round(y − loc) bin) under N(0, sigma²), with noise-compatible
        bins."""
        sigma = lower_bound(sigma, float(self.scale_table[0]))
        v = torch.abs(y if loc is None else y - loc)
        upper = _std_cumulative((0.5 - v) / sigma)
        lower = _std_cumulative((-0.5 - v) / sigma)
        return lower_bound(upper - lower, LIKELIHOOD_BOUND)

    def __call__(self, y, sigma, training, noise=None):
        """(y_tilde, likelihoods): ``y + noise`` when training, else
        round(y)."""
        if training:
            if noise is None:
                raise ValueError("training quantization needs the noise")
            y_tilde = y + noise
        else:
            y_tilde = torch.round(y)
        return y_tilde, self.likelihood(y_tilde, sigma)

    def indexes(self, sigma):
        """Per-element row index: smallest table scale ≥ sigma."""
        table = torch.as_tensor(self.scale_table[:-1], dtype=sigma.dtype,
                                device=sigma.device)
        return torch.sum(sigma[..., None] > table, dim=-1).to(torch.int32)

    def quantize_symbols(self, y, loc=None):
        return torch.round(y if loc is None else y - loc).to(torch.int32)

    def dequantize_symbols(self, symbols, loc=None):
        y = symbols.to(torch.float32)
        return y if loc is None else y + loc


# ---------------------------------------------------------------------------
# Quantized CDF tables (host, float64 — copied from the JAX package)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CdfTable:
    """Integer CDF rows for the range coder.

    ``cdf[r]`` holds ``cdf_length[r]`` int32 entries: 0, ...,
    2^precision. Row r describes ``cdf_length[r] - 2`` regular buckets plus
    one escape bucket (index ``cdf_length[r] - 2``). A symbol ``s`` maps to
    bucket ``s - offset[r]``; out-of-range symbols are escape-coded.
    """

    cdf: np.ndarray  # int32 [rows, max_len]
    cdf_length: np.ndarray  # int32 [rows]
    offset: np.ndarray  # int32 [rows]
    precision: int = RANGE_CODER_PRECISION

    @property
    def rows(self):
        return self.cdf.shape[0]


def pmf_to_quantized_cdf(pmf, precision=RANGE_CODER_PRECISION):
    """Quantize a pmf (incl. trailing escape mass) to an integer CDF.

    Every bucket gets frequency ≥ 1; the total is exactly 2^precision.
    """
    pmf = np.asarray(pmf, np.float64)
    n = len(pmf)
    assert n >= 1
    total = pmf.sum()
    if not np.isfinite(total) or total <= 0:
        pmf = np.ones(n)
        total = float(n)
    freq = np.round(pmf / total * (1 << precision)).astype(np.int64)
    freq = np.maximum(freq, 1)
    diff = (1 << precision) - freq.sum()
    if diff > 0:
        freq[np.argmax(freq)] += diff
    else:
        while diff < 0:
            i = int(np.argmax(freq))
            take = min(freq[i] - 1, -diff)
            assert take > 0, "cannot normalize pmf: too many buckets"
            freq[i] -= take
            diff += take
    cdf = np.zeros(n + 1, np.int32)
    cdf[1:] = np.cumsum(freq)
    assert cdf[-1] == (1 << precision)
    return cdf


def _logits_cumulative_np(params, x):
    """float64 monotone logit of the factorized cumulative; x: [C, 1, M]."""
    u = np.asarray(x, np.float64)
    n_layers = sum(1 for k in params if k.startswith("matrix_"))
    for k in range(n_layers):
        m = np.logaddexp(0.0, np.asarray(params[f"matrix_{k}"], np.float64))
        u = np.einsum("cij,cjm->cim", m, u) + np.asarray(
            params[f"bias_{k}"], np.float64
        )
        if f"factor_{k}" in params:
            u = u + np.tanh(np.asarray(params[f"factor_{k}"], np.float64)) * np.tanh(u)
    return u


def _sigmoid_np(x):
    out = np.empty_like(x)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    e = np.exp(x[~pos])
    out[~pos] = e / (1.0 + e)
    return out


def refine_factorized_quantiles(params, tail_mass=1e-9):
    """Solve the factorized-prior quantiles exactly by float64 bisection
    (deterministic, so encoder and decoder derive identical medians and
    tables from identical weights).

    :param params: factorized-prior param dict (numpy leaves).
    :return: new dict with the ``quantiles`` leaf replaced.
    """
    params = {k: np.asarray(v) for k, v in params.items()}
    n_channels = params["quantiles"].shape[0]
    t = float(tail_mass)
    targets = np.log(
        np.array([t / 2, 0.5, 1 - t / 2]) / np.array([1 - t / 2, 0.5, t / 2])
    )
    lo = np.full((n_channels, 1, 3), -1.0)
    hi = np.full((n_channels, 1, 3), 1.0)
    for _ in range(64):  # expand until every target is bracketed
        need_lo = _logits_cumulative_np(params, lo) > targets
        need_hi = _logits_cumulative_np(params, hi) < targets
        if not need_lo.any() and not need_hi.any():
            break
        lo = np.where(need_lo, lo * 2.0, lo)
        hi = np.where(need_hi, hi * 2.0, hi)
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        go_hi = _logits_cumulative_np(params, mid) < targets
        lo = np.where(go_hi, mid, lo)
        hi = np.where(go_hi, hi, mid)
    out = dict(params)
    out["quantiles"] = (0.5 * (lo + hi))[:, 0, :].astype(np.float32)
    return out


def build_factorized_cdf(params, precision=RANGE_CODER_PRECISION):
    """CDF table for a factorized prior; one row per channel (integer
    support around each channel's median, tails in the escape bucket)."""
    params = {k: np.asarray(v) for k, v in dict(params).items()}
    quantiles = np.asarray(params["quantiles"], np.float64)
    medians = quantiles[:, 1]
    minima = np.maximum(np.ceil(medians - quantiles[:, 0]).astype(int), 0)
    maxima = np.maximum(np.ceil(quantiles[:, 2] - medians).astype(int), 0)
    pmf_length = minima + maxima + 1
    max_length = int(pmf_length.max())
    channels = len(medians)

    samples = medians[:, None] + (np.arange(max_length)[None, :] - minima[:, None])
    lo = _logits_cumulative_np(params, samples[:, None, :] - 0.5)[:, 0, :]
    hi = _logits_cumulative_np(params, samples[:, None, :] + 0.5)[:, 0, :]
    sign = -np.sign(lo + hi)
    pmf = np.abs(_sigmoid_np(sign * hi) - _sigmoid_np(sign * lo))

    max_rowlen = max_length + 2
    cdf = np.zeros((channels, max_rowlen), np.int32)
    cdf_length = np.zeros(channels, np.int32)
    for c in range(channels):
        L = pmf_length[c]
        row_pmf = pmf[c, :L]
        tail = _sigmoid_np(lo[c, :1]) + _sigmoid_np(-hi[c, L - 1 : L])
        row = np.concatenate([row_pmf, np.maximum(tail, 0)])
        q = pmf_to_quantized_cdf(row, precision)
        cdf[c, : L + 2] = q
        cdf_length[c] = L + 2
    return CdfTable(cdf, cdf_length, (-minima).astype(np.int32), precision)


def build_gaussian_cdf(scale_table=None, tail_mass=2.0 ** -8,
                       precision=RANGE_CODER_PRECISION):
    """CDF table for the Gaussian conditional; one row per table scale."""
    if scale_table is None:
        scale_table = default_scale_table()
    scale_table = np.asarray(scale_table, np.float64)
    from scipy.stats import norm

    multiplier = -norm.ppf(tail_mass / 2)
    pmf_center = np.ceil(scale_table * multiplier).astype(int)
    pmf_length = 2 * pmf_center + 1
    max_length = int(pmf_length.max())
    rows = len(scale_table)

    def cum(x):
        return 0.5 * _erfc(-x / np.sqrt(2.0))

    d = np.abs(np.arange(max_length)[None, :] - pmf_center[:, None])
    upper = cum((0.5 - d) / scale_table[:, None])
    lower = cum((-0.5 - d) / scale_table[:, None])
    pmf = upper - lower
    tail = 2 * lower[:, :1]

    cdf = np.zeros((rows, max_length + 2), np.int32)
    cdf_length = np.zeros(rows, np.int32)
    for r in range(rows):
        L = pmf_length[r]
        row = np.concatenate([pmf[r, :L], np.maximum(tail[r], 0)])
        q = pmf_to_quantized_cdf(row, precision)
        cdf[r, : L + 2] = q
        cdf_length[r] = L + 2
    return CdfTable(cdf, cdf_length, (-pmf_center).astype(np.int32), precision)
