"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes`` (no torch
headers: one such library builds in seconds). Builds go through the
package's one builder (``native.build`` / ``native.load_lib``): at first
use, or all at once — one ``nvcc`` per source, started together — through
:func:`build_all`.

``launches`` counts kernel launches per wrapper; a wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import time
from pathlib import Path

import torch

from pcc_geo_cnn_v2_tpu_torch import native

__all__ = ["KERNELS", "launches", "reset_launches", "build_all", "load",
           "check_cuda_tensor", "check_launch", "stream_ptr"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"

# kernel name → (source file, {C function: argtypes})
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNELS = {
    "bucket_colsums": ("bucket_colsums.cu", {
        "pcc_bucket_colsums": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    }),
    "halo_edt": ("halo_edt.cu", {
        "pcc_halo_edt": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _P],
    }),
}

launches = {name: 0 for name in KERNELS}


def reset_launches():
    for k in launches:
        launches[k] = 0


def _nvcc_cmd():
    nvcc = shutil.which("nvcc")
    if not nvcc:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / \
            "bin/nvcc"
        if not cand.exists():
            raise RuntimeError("nvcc not found: the CUDA kernels build only "
                               "on a machine with the CUDA toolkit")
        nvcc = str(cand)
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def build_all(force=False):
    """Compile every stale kernel library in parallel.

    :return: (seconds, {name: nvcc/ptxas log}).
    """
    t0 = time.time()
    logs = native.build({n: (CSRC / src, _nvcc_cmd)
                         for n, (src, _) in KERNELS.items()}, force=force)
    return time.time() - t0, logs


def _bind(name):
    def setup(lib):
        for fn, argtypes in KERNELS[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return setup


def load(name):
    """ctypes handle of a kernel library, building it on first use."""
    return native.load_lib(name, CSRC / KERNELS[name][0], _nvcc_cmd,
                           setup=_bind(name))


def check_cuda_tensor(t, name, dtype, shape=None):
    """Wrapper-side argument check: raises on what a kernel does not take."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def stream_ptr(device):
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(err, name):
    """Raise on a non-zero ``cudaGetLastError`` returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
