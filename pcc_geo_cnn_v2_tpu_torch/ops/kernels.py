"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes`` (no torch
headers: one such library builds in seconds). Builds go through the
package's one builder (``native.build`` / ``native.load_lib``): at first
use, or all at once — one ``nvcc`` per source, started together — through
:func:`build_all`.

``launches`` counts kernel launches per wrapper; a wrapper adds one where
it launches its kernel (:func:`launch`) and nowhere else, so a run can show
that its main path went through the kernels. The counts are the
``launches.<kernel>`` counters of the port's one registry
(:mod:`utils.trace`), which change under its lock: wrappers are called
from several threads at once (clouds in flight, ``bench.py``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import time
from collections.abc import Mapping
from pathlib import Path

import torch

from pcc_geo_cnn_v2_tpu_torch import native
from pcc_geo_cnn_v2_tpu_torch.utils import trace

__all__ = ["KERNELS", "launches", "reset_launches", "count", "build_all",
           "load", "check_cuda_tensor", "check_launch", "stream_ptr",
           "launch", "device_table"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"

# kernel name → (source file, {C function: argtypes})
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNELS = {
    "bucket_colsums": ("bucket_colsums.cu", {
        "pcc_bucket_colsums": [_P] * 7 + [_I] * 6 + [_P],
        "pcc_bucket_colsums_work_ints": [_I, _I],
    }),
    "halo_edt": ("halo_edt.cu", {
        "pcc_halo_edt": [_P, _P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I,
                         _P],
    }),
    "bucket_colsums_d2": ("bucket_colsums_d2.cu", {
        "pcc_bucket_colsums_d2": [_P] * 10 + [_I] * 6 + [_P],
        "pcc_bucket_colsums_d2_work_ints": [_I, _I],
    }),
    "edt_sweep": ("edt_sweep.cu", {
        "pcc_edt_sweep": [_P] * 18 + [ctypes.c_float] + [_I] * 4 + [_P],
    }),
    # both include csrc/fused_tail.cuh (the shared window body)
    "fused_tail": ("fused_tail.cu", {
        "pcc_fused_tail": [_P] * 6 + [_I] * 6 + [_P],
        "pcc_fused_tail_geometry": [_I, _I, _P],
    }),
    "fused_tail_slab": ("fused_tail_slab.cu", {
        "pcc_fused_tail_slab": [_P] * 6 + [_I] * 6 + [_P],
    }),
    # no TPU kernel: the synthesis' last layer (ops/conv_one_out.py)
    "conv_one_out": ("conv_one_out.cu", {
        "pcc_conv_one_out": [_P] * 4 + [_I] * 11 + [_P],
        "pcc_conv_one_out_geometry": [_I, _I, _I, _P],
    }),
    # no TPU kernel: training's stride-1 k3 weight gradients
    # (ops/conv_wgrad.py)
    "conv_wgrad": ("conv_wgrad.cu", {
        "pcc_conv_wgrad": [_P] * 4 + [_I] * 7 + [_P],
        "pcc_conv_wgrad_geometry": [_I, _I, _P],
    }),
    # no TPU kernel: the codec's stride-1 k3 synthesis tails
    # (ops/conv_fwd.py)
    "conv_fwd": ("conv_fwd.cu", {
        "pcc_conv_fwd": [_P] * 4 + [_I] * 7 + [_P],
    }),
}


class _Launches(Mapping):
    """Launches by kernel name: a read-only view of the registry's
    ``launches.<kernel>`` counters."""

    def __getitem__(self, name):
        if name not in KERNELS:
            raise KeyError(name)
        return trace.value("launches." + name)

    def __iter__(self):
        return iter(KERNELS)

    def __len__(self):
        return len(KERNELS)

    def __repr__(self):
        return repr(dict(self))


launches = _Launches()


def reset_launches():
    trace.reset("launches.")


def count(name):
    """Add one launch of kernel ``name``."""
    if name not in KERNELS:
        raise KeyError(name)
    trace.count("launches." + name)


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


def _header_newer(name):
    """True when a shared header (``csrc/*.cuh``) is newer than the built
    library: the builder compares a library with its ``.cu`` file only."""
    so = native.BUILD_DIR / f"lib{name}.so"
    return so.exists() and any(h.stat().st_mtime > so.stat().st_mtime
                               for h in CSRC.glob("*.cuh"))


def build_all(force=False):
    """Compile every stale kernel library in parallel.

    :return: (seconds, {name: nvcc/ptxas log}).
    """
    t0 = time.time()
    jobs = {n: (CSRC / src, _nvcc_cmd) for n, (src, _) in KERNELS.items()}
    logs = native.build({n: j for n, j in jobs.items()
                         if force or _header_newer(n)}, force=True)
    logs.update(native.build({n: j for n, j in jobs.items()
                              if n not in logs}))
    return time.time() - t0, logs


def _bind(name):
    def setup(lib):
        for fn, argtypes in KERNELS[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return setup


def load(name):
    """ctypes handle of a kernel library, building it on first use (a
    loaded library is returned as it is: no file is looked at again)."""
    lib = native.loaded(name)
    if lib is not None:
        return lib
    src = CSRC / KERNELS[name][0]
    if _header_newer(name):
        native.build({name: (src, _nvcc_cmd)}, force=True)
    return native.load_lib(name, src, _nvcc_cmd, setup=_bind(name))


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


def launch(name, entry, device, *args):
    """Launch kernel ``name`` through its C entry ``entry(*args, stream)``
    on ``device``'s current stream of the calling thread, with ``device``
    made the current device around the call (a C entry launches on the
    calling thread's current device, which need not be the tensors'),
    raise on its error and count it."""
    with torch.cuda.device(device):
        err = entry(*args, stream_ptr(device))
    check_launch(err, name)
    count(name)


def device_table(array, device):
    """A constant host table copied to ``device``, the copy complete when
    this returns: the tensor is cached and read from other threads'
    streams, which do not wait for the stream that made it."""
    t = torch.as_tensor(array, device=device)
    if t.is_cuda:
        torch.cuda.current_stream(device).synchronize()
    return t
