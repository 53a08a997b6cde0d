"""Shared CLI plumbing: model construction, weight assets, device."""

from __future__ import annotations

import logging

from pcc_geo_cnn_v2_tpu_torch.models.configs import MODEL_CONFIGS, build_model
from pcc_geo_cnn_v2_tpu_torch.weights import load_asset_tree

logger = logging.getLogger(__name__)

__all__ = ["add_model_args", "build_model_from_args", "load_params"]


def add_model_args(parser, num_filters_default=None):
    parser.add_argument("--model_config", required=True,
                        help=f"Model config: {list(MODEL_CONFIGS)}")
    parser.add_argument("--num_filters", type=int, default=num_filters_default,
                        help="Override the config's filter count.")
    parser.add_argument(
        "--data_format", default="channels_last",
        help="NDHWC at the public boundary; kept for reference CLI parity.")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="Run on the GPU (default) or, explicitly, on "
                             "the CPU with the kernels' plain versions.")


def build_model_from_args(args):
    assert args.data_format == "channels_last", (
        "the port keeps the JAX package's NDHWC layout at its boundary")
    cfg = dict(MODEL_CONFIGS[args.model_config])
    if getattr(args, "num_filters", None):
        cfg["num_filters"] = args.num_filters
    return build_model(cfg)


def load_params(checkpoint_dir):
    """Weights for codec use. ``--checkpoint_dir`` names a ``.msgpack.gz``
    asset in the layout ``tools/export_rd_assets.py`` writes (orbax
    training checkpoints are not read by the port yet)."""
    tree = load_asset_tree(checkpoint_dir)
    logger.info("loaded asset %s", checkpoint_dir)
    return tree
