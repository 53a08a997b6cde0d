"""Polling subprocess pool with failure propagation and cleanup.

The port's own copy of ``pcc_geo_cnn_v2_tpu/utils/parallel_process.py``
(the reference's ``src/utils/parallel_process.py``): launch up to
``parallelism`` child processes, poll round-robin, raise with the child's
log on a non-zero exit, terminate everything on the way out. The
``ev_*`` / ``mp_*`` drivers use it; their stages talk through files only.
"""

from __future__ import annotations

import shlex
import subprocess
import sys
import time

__all__ = ["Popen", "parallel_process"]


class Popen(subprocess.Popen):
    """Popen that remembers the file objects handed to stdout / stderr, so
    that the pool can read the logs back and close them."""

    def __init__(self, *args, stdout=None, stderr=None, **kwargs):
        super().__init__(*args, stdout=stdout, stderr=stderr, **kwargs)
        self.stdout_file = stdout
        self.stderr_file = stderr


def _is_file(f):
    # not None, a standard stream or a subprocess sentinel (an int)
    return (f is not None and f not in (sys.stdout, sys.stderr)
            and hasattr(f, "close"))


def _close(f):
    if _is_file(f):
        f.close()


def parallel_process(launch, params, parallelism, progress=True):
    """Run ``launch(*p)`` for every p in ``params``, at most
    ``parallelism`` at a time (taken from the end of the list).

    :param launch: callable returning a Popen (ideally the subclass above).
    :raises RuntimeError: at the first non-zero exit, with the child's log.
    """
    params = list(params)
    total = len(params)
    done = 0
    procs: list[subprocess.Popen] = []
    try:
        while params or procs:
            while len(procs) < parallelism and params:
                procs.append(launch(*params.pop()))
            finished = []
            for p in procs:
                if p.poll() is None:
                    continue
                if p.returncode != 0:
                    logs = ""
                    f = getattr(p, "stdout_file", None)
                    if _is_file(f):
                        f.flush()
                        with open(f.name) as fh:
                            logs = fh.read()
                    cmd = " ".join(shlex.quote(str(x)) for x in p.args)
                    raise RuntimeError(
                        f"{cmd} returned {p.returncode}\n{logs}")
                _close(getattr(p, "stdout_file", None))
                _close(getattr(p, "stderr_file", None))
                finished.append(p)
            for p in finished:
                procs.remove(p)
                done += 1
                if progress:
                    print(f"[parallel_process] {done}/{total} done",
                          file=sys.stderr, flush=True)
            if not finished:
                time.sleep(0.1)
    finally:
        for p in procs:
            p.terminate()
            _close(getattr(p, "stdout_file", None))
            _close(getattr(p, "stderr_file", None))
