"""Named model configurations (port of ``pcc_geo_cnn_v2_tpu/models/configs.py``).

- c1  — v1 (factorized prior), V1 transforms, 32 filters
- c2  — v2 (hyperprior), V1 transforms, 32 filters
- c3  — v2, residual V2 transforms, 32 filters
- c3p — v2, progressive V2 transforms, 64 filters (the flagship)
- c3p_cw — c3p with Minnen & Singh's channel-wise autoregressive
  mean-scale entropy model: 8 slices of 8 channels, support of the first
  4, latent residual prediction (``CompressionModelCW``); the port's own,
  no JAX counterpart
"""

from __future__ import annotations

from torch import nn

from pcc_geo_cnn_v2_tpu_torch.models.codec_models import (
    CompressionModelCW,
    CompressionModelV1,
    CompressionModelV2,
)

__all__ = ["MODEL_CONFIGS", "build_model"]

MODEL_CONFIGS: dict[str, dict] = {
    "c1": dict(
        model="v1",
        num_filters=32,
        analysis="AnalysisTransformV1",
        synthesis="SynthesisTransformV1",
    ),
    "c2": dict(
        model="v2",
        num_filters=32,
        analysis="AnalysisTransformV1",
        synthesis="SynthesisTransformV1",
    ),
    "c3": dict(
        model="v2",
        num_filters=32,
        analysis="AnalysisTransformV2",
        synthesis="SynthesisTransformV2",
    ),
    "c3p": dict(
        model="v2",
        num_filters=64,
        analysis="AnalysisTransformProgressiveV2",
        synthesis="SynthesisTransformProgressiveV2",
    ),
    "c3p_cw": dict(
        model="cw",
        num_filters=64,
        analysis="AnalysisTransformProgressiveV2",
        synthesis="SynthesisTransformProgressiveV2",
        num_slices=8,
        max_support=4,
        slice_widths=(48, 32),
    ),
}


def build_model(config, dtype=None, conv_backend="xla") -> nn.Module:
    """Instantiate a model from a config name or an explicit config dict.

    :param dtype: compute type of the transforms (None = f32, or
        ``torch.bfloat16``); parameters stay f32.
    :param conv_backend: ``"xla"`` (modules, cuDNN) or ``"pallas"`` (fused
        residual tails on kernels K4a / K4b) for the inference entry points
        of v2 models; see ``models/codec_models.py``. v1 models ignore it,
        as in the JAX package (their V1 stacks have no residual tails).
    """
    if isinstance(config, str):
        config = MODEL_CONFIGS[config]
    cfg = dict(config)
    kind = cfg.pop("model")
    if kind == "v1":
        return CompressionModelV1(dtype=dtype, **cfg)
    if kind == "v2":
        return CompressionModelV2(dtype=dtype, conv_backend=conv_backend,
                                  **cfg)
    if kind == "cw":
        return CompressionModelCW(dtype=dtype, conv_backend=conv_backend,
                                  **cfg)
    raise ValueError(f"unknown model kind {kind!r}")
