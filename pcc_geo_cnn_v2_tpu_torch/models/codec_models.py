"""Compression models, inference entry points.

Port of ``CompressionModelV1.encode_syms`` / ``decode`` (factorized prior
on y, ``pcc_geo_cnn_v2_tpu/models/codec_models.py:38-80``) and
``CompressionModelV2.encode_syms`` / ``decode_z`` / ``decode_y``
(scale hyperprior, ``:161-186``). Public tensors
keep the JAX package's NDHWC layouts — x ``[N, B, B, B, 1]``, symbols
``[N, b, b, b, C]``, x_hat ``[N, B, B, B, 1]`` f32 — and are converted to
NCDHW once per call. Convolutions run in f32; quantization is f32 too.
"""

from __future__ import annotations

import torch
from torch import nn

from pcc_geo_cnn_v2_tpu_torch.models.entropy import (
    FactorizedPrior,
    GaussianConditional,
    default_scale_table,
)
from pcc_geo_cnn_v2_tpu_torch.models.transforms import TRANSFORMS, BlockStack
from pcc_geo_cnn_v2_tpu_torch.ops.fused_conv import (
    fused_block_stack_apply,
    packed_tails,
)

__all__ = ["CompressionModelV1", "CompressionModelV2", "CONV_BACKENDS"]

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

    @torch.no_grad()
    def encode_syms(self, x):
        """x [N,B,B,B,1] → dict(y_sym) int32, NDHWC."""
        y = _to_ndhwc(self.analysis_t(_to_ncdhw(x))).float()
        return {"y_sym": self.entropy_bottleneck.quantize_symbols(y)}

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
