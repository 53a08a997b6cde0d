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


def build_model(config) -> CompressionModelV2:
    """Instantiate a model from a config name or an explicit config dict."""
    if isinstance(config, str):
        config = MODEL_CONFIGS[config]
    cfg = dict(config)
    kind = cfg.pop("model")
    if kind != "v2":
        raise ValueError(f"model kind {kind!r} is not ported yet")
    return CompressionModelV2(**cfg)
