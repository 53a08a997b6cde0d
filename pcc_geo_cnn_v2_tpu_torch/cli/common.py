"""Shared CLI plumbing: model construction, weight assets, device."""

from __future__ import annotations

import logging
import os

from pcc_geo_cnn_v2_tpu_torch.models.configs import MODEL_CONFIGS, build_model
from pcc_geo_cnn_v2_tpu_torch.training import load_params as _load_params
from pcc_geo_cnn_v2_tpu_torch.weights import merge_trees

logger = logging.getLogger(__name__)

__all__ = ["add_model_args", "build_model_from_args", "load_params",
           "config_names"]


def config_names():
    """The names ``--model_config`` accepts."""
    return list(MODEL_CONFIGS)


def add_model_args(parser, num_filters_default=None):
    parser.add_argument("--model_config", required=True,
                        help=f"Model config: {config_names()}")
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


def load_params(checkpoint_dirs):
    """Weights for codec use. ``--checkpoint_dir`` names a ``.msgpack.gz``
    asset in the layout ``tools/export_rd_assets.py`` writes, or a port
    training directory (its latest ``ckpt_<step>``; orbax checkpoints of
    the JAX package are not read), or several of them, merged by
    ``weights.merge_trees`` (a later one's modules over an earlier
    one's)."""
    if isinstance(checkpoint_dirs, (str, os.PathLike)):
        checkpoint_dirs = [checkpoint_dirs]
    tree = merge_trees(*[_load_params(d) for d in checkpoint_dirs])
    logger.info("loaded weights %s", ", ".join(map(str, checkpoint_dirs)))
    return tree
