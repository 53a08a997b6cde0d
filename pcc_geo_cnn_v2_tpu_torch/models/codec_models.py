"""Compression models: the training graph and the inference entry points.

Port of ``CompressionModelV1`` (factorized prior on y,
``pcc_geo_cnn_v2_tpu/models/codec_models.py:38-80``) and
``CompressionModelV2`` (scale hyperprior, ``:83-186``): ``forward`` is the
JAX ``__call__`` (the training graph, noise quantization, likelihoods for
the RD loss), ``aux_loss`` the factorized prior's; ``encode_syms`` /
``decode`` / ``decode_z`` / ``decode_y`` the inference side, and
``encode`` the JAX fused encode (symbols plus the decoder's x_hat, made
from those same entry points, for ``BlockCodec.encode_blocks``). Public
tensors keep the JAX package's NDHWC layouts — x ``[N, B, B, B, 1]``,
latents and symbols ``[N, b, b, b, C]``, x_hat ``[N, B, B, B, 1]`` f32 —
and are converted to NCDHW once per call. Quantization is f32.

``CompressionModelCW`` is c3p's hyperprior model with Minnen & Singh's
channel-wise autoregressive entropy model (arXiv:2007.08739, the
reference code's ``models/ms2020.py``) in place of the zero-mean
Gaussian: y is coded in slices, each under a mean and a scale predicted
from the hyper synthesis and the slices decoded before it, and corrected
by a latent residual prediction. It is the one model whose decoder waits
on the host between device passes (``BlockCodec.decompress_blocks``).

The training noise is an argument: U(-0.5, 0.5) tensors of y's (and z's)
NDHWC shape. The training graph always runs the module convs, as the JAX
one always runs flax's: the fused-tail kernels K4a / K4b have no backward.
"""

from __future__ import annotations

import torch
from torch import nn

from pcc_geo_cnn_v2_tpu_torch.models.entropy import (
    FactorizedPrior,
    GaussianConditional,
    default_scale_table,
)
from pcc_geo_cnn_v2_tpu_torch.models.transforms import (
    TRANSFORMS,
    BlockStack,
    SliceTransform,
)
from pcc_geo_cnn_v2_tpu_torch.ops.fused_conv import (
    fused_block_stack_apply,
    packed_tails,
)

__all__ = ["CompressionModelV1", "CompressionModelV2", "CompressionModelCW",
           "CONV_BACKENDS"]

CONV_BACKENDS = ("xla", "pallas")


def _to_ncdhw(x):
    return x.permute(0, 4, 1, 2, 3).contiguous()


def _to_ndhwc(x):
    return x.permute(0, 2, 3, 4, 1).contiguous()


class CompressionModelV1(nn.Module):
    """Autoencoder + learned factorized prior on y (no hyperprior). The
    JAX package runs it without a conv backend choice: its V1 stacks have
    no residual tails."""

    def __init__(self, num_filters=32, analysis="AnalysisTransformV1",
                 synthesis="SynthesisTransformV1", dtype=None):
        super().__init__()
        self.num_filters = num_filters
        self.dtype = dtype
        self.analysis_t = TRANSFORMS[analysis](num_filters, dtype=dtype)
        self.synthesis_t = TRANSFORMS[synthesis](num_filters, dtype=dtype)
        self.entropy_bottleneck = FactorizedPrior(num_filters)

    def forward(self, x, training=True, noise_y=None):
        """x [N,B,B,B,1] → dict(y, y_tilde, y_likelihoods, x_tilde), NDHWC;
        ``noise_y`` is the factorized prior's noise on y."""
        y = _to_ndhwc(self.analysis_t(_to_ncdhw(x)))
        y_tilde, y_lik = self.entropy_bottleneck(y, training, noise_y)
        x_tilde = _to_ndhwc(self.synthesis_t(_to_ncdhw(y_tilde)))
        return {"y": y, "y_tilde": y_tilde, "y_likelihoods": y_lik,
                "x_tilde": x_tilde}

    def aux_loss(self):
        return self.entropy_bottleneck.aux_loss()

    @torch.no_grad()
    def encode_syms(self, x):
        """x [N,B,B,B,1] → dict(y_sym) int32, NDHWC."""
        y = _to_ndhwc(self.analysis_t(_to_ncdhw(x))).float()
        return {"y_sym": self.entropy_bottleneck.quantize_symbols(y)}

    @torch.no_grad()
    def encode(self, x):
        """x [N,B,B,B,1] → dict(y_sym int32, x_hat): the symbols and the
        decoder's reconstruction of them (JAX ``encode``)."""
        out = self.encode_syms(x)
        out["x_hat"] = self.decode(out["y_sym"])
        return out

    @torch.no_grad()
    def decode(self, y_sym):
        """y symbols → x_hat [N,B,B,B,1] f32 in [0, 1]."""
        y_hat = self.entropy_bottleneck.dequantize_symbols(y_sym)
        x_hat = _to_ndhwc(self.synthesis_t(_to_ncdhw(y_hat))).float()
        return torch.clamp(x_hat, 0.0, 1.0)


class CompressionModelV2(nn.Module):
    """Autoencoder + hyperprior: z = H_a(y) coded with a factorized prior,
    σ = H_s(ẑ) conditions a Gaussian model on y."""

    def __init__(self, num_filters=32, analysis="AnalysisTransformV2",
                 synthesis="SynthesisTransformV2",
                 hyper_analysis="HyperAnalysisTransform",
                 hyper_synthesis="HyperSynthesisTransform",
                 scales_min=0.11, scales_max=256.0, scales_levels=64,
                 dtype=None, conv_backend="xla"):
        super().__init__()
        if conv_backend not in CONV_BACKENDS:
            raise ValueError(f"conv_backend {conv_backend!r} is not one of "
                             f"{CONV_BACKENDS}")
        self.num_filters = num_filters
        self.dtype, self.conv_backend = dtype, conv_backend
        self.analysis_t = TRANSFORMS[analysis](num_filters, dtype=dtype)
        self.synthesis_t = TRANSFORMS[synthesis](num_filters, dtype=dtype)
        self.hyper_analysis_t = TRANSFORMS[hyper_analysis](num_filters,
                                                           dtype=dtype)
        self.hyper_synthesis_t = TRANSFORMS[hyper_synthesis](num_filters,
                                                             dtype=dtype)
        self.entropy_bottleneck = FactorizedPrior(num_filters)
        self.conditional = GaussianConditional(
            default_scale_table(scales_min, scales_max, scales_levels))

    def _fused(self, t):
        return (self.conv_backend == "pallas" and isinstance(t, BlockStack)
                and t.residual_mode == "add")

    def _stack(self, t, x):
        """Apply an analysis / synthesis stack to NDHWC ``x`` through the
        selected conv backend → NCDHW, in the compute type."""
        if self._fused(t):
            y = fused_block_stack_apply(t, x,
                                        dtype=self.dtype or torch.float32)
            return y.permute(0, 4, 1, 2, 3).contiguous()
        return t(_to_ncdhw(x))

    def pack_fused_weights(self):
        """Pack the tail weights of the stacks that run on K4a / K4b (after
        a weight load, so that no encode or decode call pays for it)."""
        for t in (self.analysis_t, self.synthesis_t):
            if self._fused(t):
                packed_tails(t, self.dtype or torch.float32)

    def forward(self, x, training=True, noise_z=None, noise_y=None):
        """x [N,B,B,B,1] → the JAX ``__call__``'s dict (y, z, z_tilde,
        z_likelihoods, sigma_tilde, y_tilde, y_likelihoods, x_tilde), NDHWC;
        ``noise_z`` / ``noise_y`` are the two entropy models' noises."""
        y = self.analysis_t(_to_ncdhw(x))
        z = _to_ndhwc(self.hyper_analysis_t(y))
        y = _to_ndhwc(y)
        z_tilde, z_lik = self.entropy_bottleneck(z, training, noise_z)
        sigma = _to_ndhwc(self.hyper_synthesis_t(_to_ncdhw(z_tilde)))
        y_tilde, y_lik = self.conditional(y, sigma, training, noise_y)
        x_tilde = _to_ndhwc(self.synthesis_t(_to_ncdhw(y_tilde)))
        return {"y": y, "z": z, "z_tilde": z_tilde, "z_likelihoods": z_lik,
                "sigma_tilde": sigma, "y_tilde": y_tilde,
                "y_likelihoods": y_lik, "x_tilde": x_tilde}

    def aux_loss(self):
        return self.entropy_bottleneck.aux_loss()

    @torch.no_grad()
    def encode_syms(self, x):
        """x [N,B,B,B,1] → dict(z_sym, y_sym) int32, NDHWC."""
        y = self._stack(self.analysis_t, x)
        z = _to_ndhwc(self.hyper_analysis_t(y)).float()
        return {
            "z_sym": self.entropy_bottleneck.quantize_symbols(z),
            "y_sym": self.conditional.quantize_symbols(
                _to_ndhwc(y).float()),
        }

    @torch.no_grad()
    def encode(self, x):
        """x [N,B,B,B,1] → dict(z_sym, y_sym, y_idx int32, x_hat): the
        symbols with the decoder's recomputation of the y CDF-row indexes
        (``decode_z``) and of x_hat (``decode_y``), as JAX ``encode``."""
        out = self.encode_syms(x)
        out["y_idx"] = self.decode_z(out["z_sym"])[1]
        out["x_hat"] = self.decode_y(out["y_sym"])
        return out

    @torch.no_grad()
    def decode_z(self, z_sym):
        """ẑ symbols → (σ̂, per-element y CDF-row indexes), NDHWC."""
        z_hat = self.entropy_bottleneck.dequantize_symbols(z_sym)
        sigma = _to_ndhwc(self.hyper_synthesis_t(_to_ncdhw(z_hat))).float()
        sigma_b = self.conditional.bound_scale(sigma)
        return sigma_b, self.conditional.indexes(sigma_b)

    @torch.no_grad()
    def decode_y(self, y_sym):
        """y symbols → x_hat [N,B,B,B,1] f32 in [0, 1]."""
        y_hat = self.conditional.dequantize_symbols(y_sym)
        x_hat = _to_ndhwc(self._stack(self.synthesis_t, y_hat)).float()
        return torch.clamp(x_hat, 0.0, 1.0)


def _round_st(x):
    """round(x) forward, identity backward (``tfc.round_st``)."""
    return x + (torch.round(x) - x).detach()


class CompressionModelCW(CompressionModelV2):
    """c3p's autoencoder, hyper analysis and z prior with the channel-wise
    autoregressive mean-scale entropy model of Minnen & Singh (2020).

    Two hyper synthesis transforms make ``latent_means`` and
    ``latent_scales`` from ẑ (the latter is the inherited
    ``hyper_synthesis_t``). y is split along channels into
    ``num_slices`` slices; for slice k the support is the first
    ``min(k, max_support)`` decoded slices ŷ_0, ŷ_1, … (the first, not
    the latest, as ``ms2020.py`` selects them) and

    - μ_k = ``slice_mean_k``(latent_means, support),
    - σ_k = ``slice_scale_k``(latent_scales, support),
    - symbols round(y_k − μ_k), coded under N(0, σ_k) by their scale-table
      row,
    - ŷ_k = symbols + μ_k + ½ tanh(``slice_lrp_k``(latent_means, support,
      symbols + μ_k)) (latent residual prediction),

    each net a :class:`SliceTransform`. ŷ feeds the synthesis. Inside the
    slice chain tensors are NCDHW (a slice is a channel range); the
    public ones stay NDHWC. Departures from ``ms2020.py``: 3-D k3 convs,
    and the hyper synthesis ends in a ReLU as c3p's does (ms2020's mean
    branch is linear at its end; the slice nets after it are not).
    """

    # the modules this model adds to c3p's (``hyper_synthesis_t``, the
    # scale branch, starts from c3p's and is trained with them)
    ADDED_PREFIXES = ("hyper_synthesis_t", "hyper_synthesis_mean_t",
                      "slice_")

    def __init__(self, num_filters=64, num_slices=8, max_support=4,
                 slice_widths=(48, 32),
                 hyper_synthesis="HyperSynthesisTransform", dtype=None,
                 **kw):
        super().__init__(num_filters, hyper_synthesis=hyper_synthesis,
                         dtype=dtype, **kw)
        if num_filters % num_slices:
            raise ValueError(f"{num_slices} slices do not divide "
                             f"{num_filters} channels")
        self.num_slices, self.max_support = num_slices, max_support
        self.slice_channels = cs = num_filters // num_slices
        self.hyper_synthesis_mean_t = TRANSFORMS[hyper_synthesis](
            num_filters, dtype=dtype)
        for k in range(num_slices):
            cin = num_filters + cs * min(k, max_support)
            setattr(self, f"slice_mean_{k}",
                    SliceTransform(cin, cs, slice_widths, dtype))
            setattr(self, f"slice_scale_{k}",
                    SliceTransform(cin, cs, slice_widths, dtype))
            setattr(self, f"slice_lrp_{k}",
                    SliceTransform(cin + cs, cs, slice_widths, dtype))

    # -- the slice chain (shared by training, encoder and decoder) --------

    def support(self, y_hats, k):
        """The decoded slices that slice ``k`` is conditioned on: the first
        ``min(k, max_support)``."""
        return y_hats[:min(k, self.max_support)]

    def _mean_scale(self, hyper, y_hats, k):
        """(μ_k, σ_k before its bound), NCDHW."""
        means, scales = hyper
        sup = self.support(y_hats, k)
        mu = getattr(self, f"slice_mean_{k}")(torch.cat([means] + sup, 1))
        sigma = getattr(self, f"slice_scale_{k}")(
            torch.cat([scales] + sup, 1))
        return mu, sigma

    def _lrp(self, hyper, y_hats, k, y_q):
        """ŷ_k from the quantized slice ``y_q`` = symbols + μ_k."""
        sup = self.support(y_hats, k)
        r = getattr(self, f"slice_lrp_{k}")(
            torch.cat([hyper[0]] + sup + [y_q], 1))
        return y_q + 0.5 * torch.tanh(r)

    @torch.no_grad()
    def decode_hyper(self, z_sym):
        """ẑ symbols (NDHWC) → (latent_means, latent_scales), NCDHW f32."""
        z_hat = _to_ncdhw(self.entropy_bottleneck.dequantize_symbols(z_sym))
        return (self.hyper_synthesis_mean_t(z_hat).float(),
                self.hyper_synthesis_t(z_hat).float())

    @torch.no_grad()
    def slice_params(self, hyper, y_hats, k):
        """(μ_k, per-element scale-table rows of σ_k as uint8), NCDHW: the
        decoder's device half before slice k's range decode."""
        mu, sigma = self._mean_scale(hyper, y_hats, k)
        idx = self.conditional.indexes(self.conditional.bound_scale(sigma))
        return mu, idx.to(torch.uint8)

    @torch.no_grad()
    def slice_lrp(self, hyper, y_hats, k, mu, sym):
        """ŷ_k (NCDHW f32) from slice k's symbols: its device half after
        the range decode."""
        return self._lrp(hyper, y_hats, k,
                         self.conditional.dequantize_symbols(sym, loc=mu))

    # -- training graph ---------------------------------------------------

    def forward(self, x, training=True, noise_z=None, noise_y=None):
        """x [N,B,B,B,1] → the dict of :meth:`CompressionModelV2.forward`
        (``sigma_tilde`` excepted), NDHWC. The rate takes y_k − μ_k plus
        the noise (training) or rounded; ẑ (to the hyper synthesis) and
        ŷ_k (to the support, the LRP and the synthesis) take
        straight-through rounding, as ``ms2020.py``."""
        y = self.analysis_t(_to_ncdhw(x))
        z = _to_ndhwc(self.hyper_analysis_t(y))
        z_tilde, z_lik = self.entropy_bottleneck(z, training, noise_z)
        med = self.entropy_bottleneck.medians()
        z_hat = _to_ncdhw(_round_st(z - med) + med)
        hyper = (self.hyper_synthesis_mean_t(z_hat),
                 self.hyper_synthesis_t(z_hat))
        cs = self.slice_channels
        noise = None if noise_y is None else _to_ncdhw(noise_y).split(cs, 1)
        if training and noise is None:
            raise ValueError("training quantization needs the noise")
        y_hats, liks = [], []
        for k, y_k in enumerate(y.split(cs, 1)):
            mu, sigma = self._mean_scale(hyper, y_hats, k)
            y_q = _round_st(y_k - mu) + mu
            liks.append(self.conditional.likelihood(
                y_k + noise[k] if training else y_q, sigma, loc=mu))
            y_hats.append(self._lrp(hyper, y_hats, k, y_q))
        y_hat = torch.cat(y_hats, 1)
        x_tilde = _to_ndhwc(self.synthesis_t(y_hat))
        return {"y": _to_ndhwc(y), "z": z, "z_tilde": z_tilde,
                "z_likelihoods": z_lik, "y_tilde": _to_ndhwc(y_hat),
                "y_likelihoods": _to_ndhwc(torch.cat(liks, 1)),
                "x_tilde": x_tilde}

    # -- inference ----------------------------------------------------------

    @torch.no_grad()
    def encode_syms(self, x, n_valid=None):
        """x [N,B,B,B,1] → dict(z_sym, y_sym int32 and y_idx uint8 NDHWC,
        y_hat NCDHW f32): the slice chain as the decoder runs it, slice by
        slice through :meth:`slice_params` and :meth:`slice_lrp`. Rows from
        ``n_valid`` on are padding: their z and y symbols are zero, as the
        decoder pads them."""
        n = len(x) if n_valid is None else n_valid
        y = self._stack(self.analysis_t, x)
        z = _to_ndhwc(self.hyper_analysis_t(y)).float()
        z_sym = self.entropy_bottleneck.quantize_symbols(z)
        z_sym[n:] = 0
        hyper = self.decode_hyper(z_sym)
        y_hats, syms, idxs = [], [], []
        for k, y_k in enumerate(y.float().split(self.slice_channels, 1)):
            mu, idx = self.slice_params(hyper, y_hats, k)
            sym = self.conditional.quantize_symbols(y_k, loc=mu)
            sym[n:] = 0
            y_hats.append(self.slice_lrp(hyper, y_hats, k, mu, sym))
            syms.append(sym)
            idxs.append(idx)
        return {"z_sym": z_sym, "y_sym": _to_ndhwc(torch.cat(syms, 1)),
                "y_idx": _to_ndhwc(torch.cat(idxs, 1)),
                "y_hat": torch.cat(y_hats, 1)}

    @torch.no_grad()
    def encode(self, x):
        """x [N,B,B,B,1] → dict(z_sym, y_sym, y_idx, x_hat), as
        :meth:`CompressionModelV2.encode`."""
        out = self.encode_syms(x)
        out["y_idx"] = out["y_idx"].to(torch.int32)
        out["x_hat"] = self.decode_y(out.pop("y_hat"))
        return out

    @torch.no_grad()
    def decode_y(self, y_hat):
        """ŷ (NCDHW f32, the slices' concatenation) → x_hat [N,B,B,B,1] f32
        in [0, 1]."""
        x_hat = _to_ndhwc(self._stack(self.synthesis_t, _to_ndhwc(y_hat)))
        return torch.clamp(x_hat.float(), 0.0, 1.0)
