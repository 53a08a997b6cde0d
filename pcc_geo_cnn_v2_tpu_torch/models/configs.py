"""Named model configurations (port of ``pcc_geo_cnn_v2_tpu/models/configs.py``).

Only the residual hyperprior configs are ported so far:

- c3  — v2, residual V2 transforms, 32 filters
- c3p — v2, progressive V2 transforms, 64 filters (the flagship)
"""

from __future__ import annotations

from pcc_geo_cnn_v2_tpu_torch.models.codec_models import CompressionModelV2

__all__ = ["MODEL_CONFIGS", "build_model"]

MODEL_CONFIGS: dict[str, dict] = {
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
}


def build_model(config, dtype=None, conv_backend="xla") -> CompressionModelV2:
    """Instantiate a model from a config name or an explicit config dict.

    :param dtype: compute type of the transforms (None = f32, or
        ``torch.bfloat16``); parameters stay f32.
    :param conv_backend: ``"xla"`` (modules, cuDNN) or ``"pallas"`` (fused
        residual tails on kernels K4a / K4b) for the inference entry points;
        see ``models/codec_models.py``.
    """
    if isinstance(config, str):
        config = MODEL_CONFIGS[config]
    cfg = dict(config)
    kind = cfg.pop("model")
    if kind != "v2":
        raise ValueError(f"model kind {kind!r} is not ported yet")
    return CompressionModelV2(dtype=dtype, conv_backend=conv_backend, **cfg)
