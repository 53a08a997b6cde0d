"""Build-at-first-use of the port's shared libraries, and its host C++.

One builder serves both kinds of library the port compiles: the host C++
here (the port's own copies of the JAX package's ``native/*.cpp``: the
range coder and the packed-mask unpack, built by ``g++``) and the CUDA
kernels of ``csrc/`` (built by ``nvcc``, see ``ops/kernels.py``). A
library is compiled into the package's gitignored ``_build/`` directory
when it is missing or older than its source, and loaded with ``ctypes``;
a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "build", "load_lib", "loaded", "load_host_lib"]

_SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = _SRC_DIR.parent / "_build"
_libs = {}
_lock = threading.RLock()


def _so_path(name):
    return BUILD_DIR / f"lib{name}.so"


def _stale(name, src):
    so = _so_path(name)
    return not so.exists() or so.stat().st_mtime < Path(src).stat().st_mtime


def build(jobs, force=False):
    """Compile the stale libraries of ``jobs`` in parallel.

    :param jobs: {name: (source path, compiler argv without ``-o`` and the
        source, or a callable returning it)}.
    :return: {name: compiler output} of the libraries built.
    """
    with _lock:
        todo = {n: (src, cmd() if callable(cmd) else cmd)
                for n, (src, cmd) in jobs.items()
                if force or _stale(n, src)}
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n, (src, cmd) in todo.items():
            tmp = BUILD_DIR / f"lib{n}.{os.getpid()}.tmp.so"
            procs[n] = tmp, subprocess.Popen(
                [*cmd, "-o", str(tmp), str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT)
        logs = {}
        for n, (tmp, proc) in procs.items():
            out = proc.communicate()[0].decode(errors="replace")
            if proc.returncode != 0:
                raise RuntimeError(f"{todo[n][1][0]} failed for {n}:\n"
                                   f"{out[-4000:]}")
            os.replace(tmp, _so_path(n))  # atomic: concurrent builds agree
            logs[n] = out
        return logs


def loaded(name):
    """The handle of an already loaded library, else None."""
    return _libs.get(name)


def load_lib(name, src, cmd, setup=None):
    """ctypes handle of ``lib<name>.so``, built from ``src`` by ``cmd``
    (see :func:`build`) when stale; ``setup(lib)`` runs once on load."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build({name: (src, cmd)})
            lib = ctypes.CDLL(str(_so_path(name)))
            if setup is not None:
                setup(lib)
            _libs[name] = lib
    return _libs[name]


def load_host_lib(name):
    """ctypes handle of the host library built from ``native/<name>.cpp``."""
    return load_lib(name, _SRC_DIR / f"{name}.cpp",
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"])
