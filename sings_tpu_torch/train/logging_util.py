"""Per-run log files (port of sings_tpu/train/logging_util.py; reference
scripts/train_avatar.py:18-52 get_logger: loguru writes the console
stream to <logdir>/{train,eval}.log).

Here: a stdout/stderr tee installed once per process; every print from
the trainer (step losses, density events, val metrics) lands in the
run's log file as well as the console.
"""
from __future__ import annotations

import os
import sys


class _Tee:
    def __init__(self, stream, fh):
        self._stream = stream
        self._fh = fh

    def write(self, data):
        self._stream.write(data)
        try:
            self._fh.write(data)
            self._fh.flush()
        except ValueError:  # closed file during interpreter shutdown
            pass
        return len(data)

    def flush(self):
        self._stream.flush()
        try:
            self._fh.flush()
        except ValueError:
            pass

    def __getattr__(self, name):
        return getattr(self._stream, name)


_installed: dict[str, bool] = {}


def install_run_log(logdir: str, mode: str = "train") -> str:
    """Tee stdout+stderr into <logdir>/<mode>.log (append). Idempotent
    per path within a process."""
    path = os.path.join(logdir, f"{mode}.log")
    if _installed.get(path):
        return path
    os.makedirs(logdir, exist_ok=True)
    fh = open(path, "a", buffering=1)
    sys.stdout = _Tee(sys.stdout, fh)
    sys.stderr = _Tee(sys.stderr, fh)
    _installed[path] = True
    return path
