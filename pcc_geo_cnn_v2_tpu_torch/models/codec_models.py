"""Scale-hyperprior compression model, inference entry points.

Port of ``CompressionModelV2.encode_syms`` / ``decode_z`` / ``decode_y``
(``pcc_geo_cnn_v2_tpu/models/codec_models.py:161-186``). Public tensors
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
from pcc_geo_cnn_v2_tpu_torch.models.transforms import TRANSFORMS

__all__ = ["CompressionModelV2"]


def _to_ncdhw(x):
    return x.permute(0, 4, 1, 2, 3).contiguous()


def _to_ndhwc(x):
    return x.permute(0, 2, 3, 4, 1).contiguous()


class CompressionModelV2(nn.Module):
    """Autoencoder + hyperprior: z = H_a(y) coded with a factorized prior,
    σ = H_s(ẑ) conditions a Gaussian model on y."""

    def __init__(self, num_filters=32, analysis="AnalysisTransformV2",
                 synthesis="SynthesisTransformV2",
                 hyper_analysis="HyperAnalysisTransform",
                 hyper_synthesis="HyperSynthesisTransform",
                 scales_min=0.11, scales_max=256.0, scales_levels=64):
        super().__init__()
        self.num_filters = num_filters
        self.analysis_t = TRANSFORMS[analysis](num_filters)
        self.synthesis_t = TRANSFORMS[synthesis](num_filters)
        self.hyper_analysis_t = TRANSFORMS[hyper_analysis](num_filters)
        self.hyper_synthesis_t = TRANSFORMS[hyper_synthesis](num_filters)
        self.entropy_bottleneck = FactorizedPrior(num_filters)
        self.conditional = GaussianConditional(
            default_scale_table(scales_min, scales_max, scales_levels))

    @torch.no_grad()
    def encode_syms(self, x):
        """x [N,B,B,B,1] → dict(z_sym, y_sym) int32, NDHWC."""
        y = self.analysis_t(_to_ncdhw(x))
        z = _to_ndhwc(self.hyper_analysis_t(y))
        return {
            "z_sym": self.entropy_bottleneck.quantize_symbols(z),
            "y_sym": self.conditional.quantize_symbols(_to_ndhwc(y)),
        }

    @torch.no_grad()
    def decode_z(self, z_sym):
        """ẑ symbols → (σ̂, per-element y CDF-row indexes), NDHWC."""
        z_hat = self.entropy_bottleneck.dequantize_symbols(z_sym)
        sigma = _to_ndhwc(self.hyper_synthesis_t(_to_ncdhw(z_hat)))
        sigma_b = self.conditional.bound_scale(sigma)
        return sigma_b, self.conditional.indexes(sigma_b)

    @torch.no_grad()
    def decode_y(self, y_sym):
        """y symbols → x_hat [N,B,B,B,1] f32 in [0, 1]."""
        y_hat = self.conditional.dequantize_symbols(y_sym)
        x_hat = _to_ndhwc(self.synthesis_t(_to_ncdhw(y_hat)))
        return torch.clamp(x_hat, 0.0, 1.0)
