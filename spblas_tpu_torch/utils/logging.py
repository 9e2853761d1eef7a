"""Logging / tracing — counterpart of ``spblas_tpu/utils/logging.py``.

A level filter from the ``SPBLAS_LOG`` env var and a ``@traced``
decorator on op entry points that opens a ``torch.profiler`` range named
``spblas.<fn>``, so device traces show the op boundaries.
"""

from __future__ import annotations

import functools
import os
import sys
import time

import torch

LEVELS = {"NONE": 0, "WARNING": 1, "INFO": 2, "TRACE": 3, "DEBUG": 4}
_level = LEVELS.get(os.environ.get("SPBLAS_LOG", "NONE").upper(), 0)


def set_level(name: str) -> None:
    global _level
    _level = LEVELS[name.upper()]


def log(level: str, msg: str) -> None:
    if LEVELS[level] <= _level:
        print(f"[{level}] spblas_tpu_torch: {msg}", file=sys.stderr)


def log_warning(msg):
    log("WARNING", msg)


def log_info(msg):
    log("INFO", msg)


def log_trace(msg):
    log("TRACE", msg)


def log_debug(msg):
    log("DEBUG", msg)


def traced(fn):
    """Entry-point tracer: log at enter/exit under TRACE, and a profiler
    range around every call."""
    name = f"spblas.{fn.__name__}"

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _level >= LEVELS["TRACE"]:
            t0 = time.perf_counter()
            log_trace(f"{fn.__qualname__} enter")
            with torch.profiler.record_function(name):
                out = fn(*args, **kwargs)
            log_trace(f"{fn.__qualname__} exit "
                      f"({(time.perf_counter() - t0) * 1e3:.3f} ms)")
            return out
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return wrapper
