"""Experiment-support helpers: the port's own copy of
``pcc_geo_cnn_v2_tpu/utils/experiment.py`` (the reference's
``src/utils/experiment.py``)."""

from __future__ import annotations

import functools
import logging
import sys
import time
from pathlib import Path

__all__ = ["assert_exists", "build_logger", "timing", "index_by_id"]


def assert_exists(path):
    assert Path(path).exists(), f"{path} does not exist"


def build_logger(name, path=None, level=logging.INFO):
    """Logger writing to stdout and optionally a file, one format."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter(
        "%(asctime)s.%(msecs)03d %(levelname)s %(name)s - %(funcName)s: "
        "%(message)s",
        datefmt="%H:%M:%S",
    )
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if path is not None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(path)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def timing(fn=None, *, logger=None):
    """Decorator logging the wall time of each call."""
    if fn is None:
        return functools.partial(timing, logger=logger)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.time()
        out = fn(*args, **kwargs)
        msg = f"{fn.__name__}: {time.time() - t0:.3f}s"
        (logger or logging.getLogger(fn.__module__)).info(msg)
        return out

    return wrapper


def index_by_id(items, key="id"):
    return {x[key]: x for x in items}
