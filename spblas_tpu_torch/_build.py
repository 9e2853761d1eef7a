"""Kernel loader: builds ``csrc/<name>.cu`` into a shared library with a
plain C interface and loads it with ``ctypes``.

``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` runs once per source, on first use, into
``spblas_tpu_torch/_build/`` (listed in ``.gitignore``).  The library's
file name carries a hash of its source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source or header is rebuilt and
never loaded stale; the library is written under a temporary
name and renamed into place, so processes building at once do not
collide.  Importing the package builds nothing.

Every C entry point takes pointers and the CUDA stream as ``void*`` and
sizes as ``int``, and returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
# -Xptxas=-v: the build output lists each kernel's registers and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# name -> loaded ctypes library (one per source, per process)
_libs: dict = {}
# (name, symbol) -> typed ctypes function
_fns: dict = {}
_lock = threading.Lock()


def kernel_names():
    """Every kernel source of the package, by stem."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "spblas_tpu_torch build only where the CUDA "
                           "toolkit is installed")
    return str(path)


def _target(name: str) -> tuple:
    """(source, library): the hash covers the source, every shared header
    of ``csrc/`` (a source may include one) and the flags."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return src, BUILD / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp, lib) or None when
    the library is already built."""
    src, lib = _target(name)
    if lib.exists():
        return None
    BUILD.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, lib = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, lib)
    return out


def build_all() -> dict:
    """Build every kernel source at once, one nvcc process each, all
    started together; returns the compiler output by kernel name."""
    started = {n: _start(n) for n in kernel_names()}
    outs, errors = {}, []
    for n, s in started.items():      # wait for every nvcc, then raise
        try:
            outs[n] = _finish(n, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)[1]))
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``symbol`` of ``csrc/<name>.cu``, its argument types
    set once and the function cached, so a launch costs one dict lookup."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn


def check(code: int, what: str) -> None:
    """Raise on the ``cudaGetLastError()`` code a C entry point returned
    (a refused launch never runs, and no later sync reports it)."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")
