"""The port's own copy of the C++ host inspectors the ROUTE builders call.

``src/route2_pack.cpp``, ``src/route_pack.cpp``, ``src/sort_util.cpp`` and
``src/spblas_host.cpp`` are byte-for-byte copies of the JAX package's
sources (plain C++, no framework code).  One
``g++ -O3 -march=native -shared -fPIC -std=c++17`` builds them, on first
use, into ``spblas_tpu_torch/_build/`` (listed in ``.gitignore``).  As in
``_build.py``, the library's file name carries a hash of its sources and
flags, so an edited source is rebuilt and never loaded stale, and the
library is written under a temporary name and renamed into place, so
processes building at once do not collide.  Importing the package builds
nothing.

There is no numpy fallback: if g++ is missing or fails, :func:`get_lib`
raises.  (The JAX package's python packer and its identity-ordering RCM
fallback are not carried; the machine with the card always has g++,
which nvcc needs.)

The wrappers below are those of ``spblas_tpu/native/__init__.py`` that
the builders call, with the same arguments and results.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC = Path(__file__).resolve().parent / "src"
SOURCES = ("route2_pack.cpp", "route_pack.cpp", "sort_util.cpp",
           "spblas_host.cpp")
BUILD = _PKG / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library built from ``src/`` lives (hash of sources and
    flags in the name)."""
    h = hashlib.sha1(" ".join(GXX_FLAGS).encode())
    for name in SOURCES:
        h.update((SRC / name).read_bytes())
    return BUILD / f"libroute2_host-{h.hexdigest()[:12]}.so"


def _build(lib: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: spblas_tpu_torch's ROUTE and "
                           "RCM builders need their native library "
                           "(spblas_tpu_torch/native/src)")
    BUILD.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    out = subprocess.run(
        [gxx, *GXX_FLAGS, *(str(SRC / s) for s in SOURCES), "-o", str(tmp),
         "-lpthread"], capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for spblas_tpu_torch/native:\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, lib)


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built on first use; raises when it
    cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _lib = lib
    return _lib


def _declare(lib):
    i64, i32p, i64p = (
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.spblas_ell_build.restype = i64
    lib.spblas_ell_build.argtypes = [
        i64, i64, i64, i64p, i32p, i64, i32p, i32p,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")]
    lib.spblas_route2_pack.restype = i64
    lib.spblas_route2_pack.argtypes = [
        i64, i64, i64p, i32p, i32p, i64, i64, ctypes.c_int32,
        i32p, i32p, i32p, i32p, i32p, i32p, i64p, i64p, i32p, i32p,
        i32p, i64p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, i32p]
    lib.spblas_route_pack.restype = i64
    lib.spblas_route_pack.argtypes = [
        i64, i64, i64p, i32p, i32p, i64,
        i32p, i32p, i32p, i32p, i32p, i32p, i64p, i32p, i32p, i32p,
        i64p]
    lib.spblas_route2_keys.restype = None
    lib.spblas_route2_keys.argtypes = [
        i64, i64p, i64p, ctypes.c_int32, ctypes.c_int32, i64,
        ctypes.c_void_p, i64, i64p]
    lib.spblas_argsort_i64.restype = i64
    lib.spblas_argsort_i64.argtypes = [i64, i64p, i32p, i64p]
    lib.spblas_fill_group_tiles.restype = None
    lib.spblas_fill_group_tiles.argtypes = [
        i64, i32p, i32p, f32p, i64p, i64, i32p, i64, f32p, i32p]
    lib.spblas_gather_f32.restype = None
    lib.spblas_gather_f32.argtypes = [i64, i32p, f32p, f32p]
    lib.spblas_gather_i64.restype = None
    lib.spblas_gather_i64.argtypes = [i64, i32p, i64p, i64p]
    lib.spblas_gather_tiles.restype = None
    lib.spblas_gather_tiles.argtypes = [i64, i32p, ctypes.c_void_p,
                                        ctypes.c_void_p]
    lib.spblas_gather_tiles_fill.restype = None
    lib.spblas_gather_tiles_fill.argtypes = [
        i64, i32p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.spblas_expand_rowptr.restype = None
    lib.spblas_expand_rowptr.argtypes = [i64, i64, i64p, i64p]
    lib.spblas_rcm.restype = i64
    lib.spblas_rcm.argtypes = [i64, i64, i64p, i32p, i64p]
    lib.spblas_mul_expand.restype = i64
    lib.spblas_mul_expand.argtypes = [
        i64, i64, i64p, i32p, i64, i64p, i32p, i64, i64p, i32p,
        i64, i64, i64, i64p, i64p, i64p]
    lib.spblas_route2_mul_pack.restype = i64
    lib.spblas_route2_mul_pack.argtypes = [
        i64, i64, i64p, i32p, i32p, i32p, i64, i64,
        i32p, i32p, i32p, i32p, i64p, i64p, i32p, i32p]
    lib.spblas_route_mul_pack.restype = i64
    lib.spblas_route_mul_pack.argtypes = [
        i64, i64, i64p, i32p, i32p, i32p, i64, i32p, i32p, i32p, i32p]
    lib.spblas_level_schedule.restype = i64
    lib.spblas_level_schedule.argtypes = [i64, i64, i64p, i32p,
                                          ctypes.c_int32, ctypes.c_int32,
                                          i32p, i64p]


def route2_pack(ne, ncells, cell_start, lrow, lcol, aux_windows_in=0,
                spill_only=False, spill=False, any_lane=True,
                row_window=1024, rotate=False):
    """Native ROUTE2 chunk packing (the builder's hot loop).

    Returns (nch, tiles(nch,8,128), chunk_cell, chunk_auxwin,
    chunk_group, elem_group, elem_scat, n_aux_windows, aux_slot,
    aux_lrow, aux_cell, spill_idx, chunk_rho).  With ``spill=True``,
    Poisson-tail overflow beyond each cell's deserved chunk count comes
    back as stream indices in ``spill_idx`` for window-major repacking.
    ``rotate=True`` packs with per-chunk d=2 publish-position rotations;
    chunk_rho carries rho0 | rho1 << 10 per chunk."""
    lib = get_lib()
    cell_start = np.ascontiguousarray(cell_start, np.int64)
    lrow = np.ascontiguousarray(lrow, np.int32)
    lcol = np.ascontiguousarray(lcol, np.int32)
    max_chunks = int(ne // 256 + 4 * ncells + 16)
    for _ in range(4):
        # np.empty: the packer initialises every chunk it emits and every
        # committed element's map entries (spilled entries are skipped
        # downstream via spill_idx)
        tiles = np.empty(max_chunks * 1024, np.int32)
        chunk_cell = np.empty(max_chunks, np.int32)
        chunk_auxwin = np.empty(max_chunks, np.int32)
        chunk_group = np.empty(max_chunks, np.int32)
        elem_group = np.empty(max(ne, 1), np.int32)
        elem_scat = np.empty(max(ne, 1), np.int32)
        aux_info = np.zeros(2, np.int64)
        aux_slot = np.empty(max(ne, 1), np.int64)
        aux_lrow = np.empty(max(ne, 1), np.int32)
        aux_cell = np.empty(max(ne, 1), np.int32)
        spill_out = np.empty(max(ne, 1) if spill else 1, np.int32)
        spill_n = np.zeros(1, np.int64)
        chunk_rho = np.zeros(max_chunks, np.int32)
        rc = lib.spblas_route2_pack(
            ne, ncells, cell_start, lrow, lcol, max_chunks,
            int(aux_windows_in), int(spill_only),
            tiles, chunk_cell, chunk_auxwin, chunk_group,
            elem_group, elem_scat, aux_info, aux_slot, aux_lrow,
            aux_cell, spill_out, spill_n, int(spill), int(any_lane),
            int(row_window), int(rotate), chunk_rho)
        if rc == -1:
            max_chunks *= 4
            continue
        if rc < 0:
            raise RuntimeError(f"spblas_route2_pack failed with code {rc}")
        nch = int(rc)
        na = int(aux_info[0])
        spill_idx = (spill_out[: int(spill_n[0])] if spill
                     else np.zeros(0, np.int32))
        return (nch, tiles[: nch * 1024].reshape(nch, 8, 128),
                chunk_cell[:nch], chunk_auxwin[:nch],
                chunk_group[:nch], elem_group, elem_scat,
                int(aux_info[1]), aux_slot[:na], aux_lrow[:na],
                aux_cell[:na], spill_idx, chunk_rho[:nch])
    raise RuntimeError("spblas_route2_pack: chunk buffer kept overflowing")


def route2_mul_pack(ne, ncells, cell_start, lslot, la, lb,
                    aux_windows_in=0):
    """Native ROUTE2-mul chunk packing (the mul builder's hot loop).

    Returns (nch, t1, t2, chunk_cell, chunk_auxwin, n_aux_windows,
    aux_slot, aux_lslot, aux_cell)."""
    lib = get_lib()
    cell_start = np.ascontiguousarray(cell_start, np.int64)
    lslot = np.ascontiguousarray(lslot, np.int32)
    la = np.ascontiguousarray(la, np.int32)
    lb = np.ascontiguousarray(lb, np.int32)
    max_chunks = int(ne // 256 + 4 * ncells + 16)
    for _ in range(4):
        # np.empty: see route2_pack
        t1 = np.empty(max_chunks * 1024, np.int32)
        t2 = np.empty(max_chunks * 1024, np.int32)
        chunk_cell = np.empty(max_chunks, np.int32)
        chunk_auxwin = np.empty(max_chunks, np.int32)
        aux_info = np.zeros(2, np.int64)
        aux_slot = np.empty(max(ne, 1), np.int64)
        aux_lslot = np.empty(max(ne, 1), np.int32)
        aux_cell = np.empty(max(ne, 1), np.int32)
        rc = lib.spblas_route2_mul_pack(
            ne, ncells, cell_start, lslot, la, lb, max_chunks,
            int(aux_windows_in), t1, t2, chunk_cell, chunk_auxwin,
            aux_info, aux_slot, aux_lslot, aux_cell)
        if rc == -1:
            max_chunks *= 4
            continue
        if rc < 0:
            raise RuntimeError(
                f"spblas_route2_mul_pack failed with code {rc}")
        nch = int(rc)
        na = int(aux_info[0])
        return (nch, t1[: nch * 1024].reshape(nch, 8, 128),
                t2[: nch * 1024].reshape(nch, 8, 128),
                chunk_cell[:nch], chunk_auxwin[:nch],
                int(aux_info[1]), aux_slot[:na], aux_lslot[:na],
                aux_cell[:na])
    raise RuntimeError(
        "spblas_route2_mul_pack: chunk buffer kept overflowing")


def route_mul_pack(ne, ncells, cell_start, lo, la, lb):
    """Native ROUTE v1 mul chunk packing (``kernels/route_mul.py``'s hot
    loop).  ``lo``/``la``/``lb`` are the window-local slot, src_a and
    src_b of each element of the cell-sorted SpGEMM expansion stream.

    Returns (nchunks, t1, t2, t3, chunk_cell)."""
    lib = get_lib()
    cell_start = np.ascontiguousarray(cell_start, np.int64)
    lo = np.ascontiguousarray(lo, np.int32)
    la = np.ascontiguousarray(la, np.int32)
    lb = np.ascontiguousarray(lb, np.int32)
    max_chunks = int(ne // 256 + 4 * ncells + 16)
    for _ in range(4):
        t1 = np.zeros(max_chunks * 1024, np.int32)
        t2 = np.zeros(max_chunks * 1024, np.int32)
        t3 = np.zeros(max_chunks * 1024, np.int32)
        chunk_cell = np.zeros(max_chunks, np.int32)
        rc = lib.spblas_route_mul_pack(
            ne, ncells, cell_start, lo, la, lb, max_chunks,
            t1, t2, t3, chunk_cell)
        if rc == -1:
            max_chunks *= 4
            continue
        if rc < 0:
            raise RuntimeError(
                f"spblas_route_mul_pack failed with code {rc}")
        nch = int(rc)
        return (nch,
                t1[: nch * 1024].reshape(nch, 8, 128),
                t2[: nch * 1024].reshape(nch, 8, 128),
                t3[: nch * 1024].reshape(nch, 8, 128),
                chunk_cell[:nch])
    raise RuntimeError(
        "spblas_route_mul_pack: chunk buffer kept overflowing")


def ell_geometry(m, m_pad, nnz, rowptr, colind, width=0):
    """(gather, cols, valid, w): the padded-row (ELL) plan arrays, each
    (m_pad, w), for rowptr int64[m + 1] and colind int32[*].  Width 0
    derives the longest row first (a geometry-only call), then fills."""
    lib = get_lib()
    rowptr = np.ascontiguousarray(rowptr, dtype=np.int64)
    colind = np.ascontiguousarray(colind, dtype=np.int32)
    w = width or int(lib.spblas_ell_build(
        m, m_pad, nnz, rowptr, colind, 0, np.zeros(1, np.int32),
        np.zeros(1, np.int32), np.zeros(1, np.uint8)))
    gather = np.zeros((m_pad, w), np.int32)
    cols = np.zeros((m_pad, w), np.int32)
    valid = np.zeros((m_pad, w), np.uint8)
    lib.spblas_ell_build(m, m_pad, nnz, rowptr, colind, w,
                         gather.reshape(-1), cols.reshape(-1),
                         valid.reshape(-1))
    return gather, cols, valid.astype(bool), w


def level_schedule(m, nnz, rowptr, colind, lower: bool, unit: bool):
    """Level-set analysis of a triangular matrix: (levels int32[m],
    diag int64[m] (the diagonal's entry index, -1 when absent),
    num_levels).  Raises ValueError when an explicit-diagonal row lacks
    its diagonal."""
    lib = get_lib()
    rowptr = np.ascontiguousarray(rowptr, dtype=np.int64)
    colind = np.ascontiguousarray(colind, dtype=np.int32)
    levels = np.zeros(m, np.int32)
    diag = np.full(m, -1, np.int64)
    nl = int(lib.spblas_level_schedule(
        m, nnz, rowptr, colind, int(lower), int(unit), levels, diag))
    if nl < 0:
        raise ValueError(
            "explicit-diagonal solve but a row has no diagonal entry")
    return levels, diag, nl


def mul_expand(m, a_nnz, a_rowptr, a_colind, b_nnz, b_rowptr, b_colind,
               d_nnz, d_rowptr, d_colind, a_cap, b_cap, e_total):
    """Fused SpGEMM expansion stream for the mul engine build: (slots,
    sa, sb, result_nnz) in (row, col)-sorted order, stable within a
    (row, col) group (A·B expansion entries first, then D, whose entries
    read A's constant-1 slot ``a_cap`` and B-side slot ``b_cap + t``)."""
    lib = get_lib()
    a_rowptr = np.ascontiguousarray(a_rowptr, np.int64)
    a_colind = np.ascontiguousarray(a_colind, np.int32)
    b_rowptr = np.ascontiguousarray(b_rowptr, np.int64)
    b_colind = np.ascontiguousarray(b_colind, np.int32)
    d_rowptr = np.ascontiguousarray(
        d_rowptr if d_nnz else np.zeros(1, np.int64), np.int64)
    d_colind = np.ascontiguousarray(
        d_colind if d_nnz else np.zeros(1, np.int32), np.int32)
    slots = np.zeros(max(e_total, 1), np.int64)
    sa = np.zeros(max(e_total, 1), np.int64)
    sb = np.zeros(max(e_total, 1), np.int64)
    rc = lib.spblas_mul_expand(
        m, a_nnz, a_rowptr, a_colind, b_nnz, b_rowptr, b_colind,
        d_nnz, d_rowptr, d_colind, a_cap, b_cap, e_total,
        slots, sa, sb)
    if rc < 0:
        raise RuntimeError(f"spblas_mul_expand: the expansion does not "
                           f"have {e_total} entries")
    return slots[:e_total], sa[:e_total], sb[:e_total], int(rc)


def route_pack(ne, ncells, cell_start, lrow, lcol):
    """Native ROUTE v1 chunk packing (``kernels/route_plan.py``'s hot
    loop, the edge colouring included).

    Returns (nchunks, elem_chunk, elem_gatpos, t1, t3, chunk_cell,
    chunk_auxwin, aux_n, aux_slot, aux_lrow, aux_cell)."""
    lib = get_lib()
    cell_start = np.ascontiguousarray(cell_start, np.int64)
    lrow = np.ascontiguousarray(lrow, np.int32)
    lcol = np.ascontiguousarray(lcol, np.int32)
    max_chunks = int(ne // 1024 + 4 * ncells + 16)
    for _ in range(4):
        elem_chunk = np.zeros(max(ne, 1), np.int32)
        elem_gatpos = np.zeros(max(ne, 1), np.int32)
        t1 = np.zeros(max_chunks * 1024, np.int32)
        t3 = np.zeros(max_chunks * 1024, np.int32)
        chunk_cell = np.zeros(max_chunks, np.int32)
        chunk_auxwin = np.zeros(max_chunks, np.int32)
        aux_n = np.zeros(1, np.int64)
        aux_slot = np.zeros(max(ne, 1), np.int32)
        aux_lrow = np.zeros(max(ne, 1), np.int32)
        aux_cell = np.zeros(max(ne, 1), np.int32)
        aux_cnt = np.zeros(1, np.int64)
        rc = lib.spblas_route_pack(
            ne, ncells, cell_start, lrow, lcol, max_chunks,
            elem_chunk, elem_gatpos, t1, t3, chunk_cell, chunk_auxwin,
            aux_n, aux_slot, aux_lrow, aux_cell, aux_cnt)
        if rc == -1:
            max_chunks *= 4
            continue
        if rc < 0:
            raise RuntimeError(f"spblas_route_pack failed with code {rc}")
        nch = int(rc)
        na = int(aux_cnt[0])
        return (nch, elem_chunk, elem_gatpos,
                t1[: nch * 1024].reshape(nch, 8, 128),
                t3[: nch * 1024].reshape(nch, 8, 128),
                chunk_cell[:nch], chunk_auxwin[:nch], int(aux_n[0]),
                aux_slot[:na], aux_lrow[:na], aux_cell[:na])
    raise RuntimeError("spblas_route_pack: chunk buffer kept overflowing")


def route2_keys(rows, cols, rw_bits, w_bits, ncellc, lvl=None,
                lvl_mult=0):
    """Packed ROUTE2 sort key: ``(cell_id << (15+rw_bits)) | (lrow << 15)
    | lcol``, the cell id optionally level-augmented (threaded)."""
    lib = get_lib()
    n = len(rows)
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    key = np.empty(n, np.int64)
    lvl_p = None
    if lvl is not None:
        lvl = np.ascontiguousarray(lvl, np.int64)
        lvl_p = lvl.ctypes.data_as(ctypes.c_void_p)
    lib.spblas_route2_keys(n, rows, cols, int(rw_bits), int(w_bits),
                           int(ncellc), lvl_p, int(lvl_mult), key)
    return key


def argsort_i64(key):
    """Stable parallel radix argsort of non-negative int64 keys.

    Returns ``(order int32, sorted_key int64)`` — identical order to
    ``np.argsort(key, kind="stable")`` — or None when n >= 2^31 (the
    int32 order cannot hold it)."""
    lib = get_lib()
    key = np.ascontiguousarray(key, np.int64)
    n = len(key)
    order = np.empty(n, np.int32)
    sorted_key = np.empty(n, np.int64)
    if lib.spblas_argsort_i64(n, key, order, sorted_key) < 0:
        return None
    return order, sorted_key


def fill_group_tiles(ngroup, elem_group, elem_scat, vals, ent,
                     spill_idx=None):
    """Parallel group val/src tile fill: ``vt[g, scat] = val``,
    ``st[g, scat] = ent or -1``, skipping spilled stream indices.
    Returns ``(vt, st)`` shaped ``(max(ngroup, 1), 8, 128)``."""
    lib = get_lib()
    ne = len(elem_group)
    elem_group = np.ascontiguousarray(elem_group, np.int32)
    elem_scat = np.ascontiguousarray(elem_scat, np.int32)
    vals = np.ascontiguousarray(vals, np.float32)
    ent = np.ascontiguousarray(ent, np.int64)
    ng = max(ngroup, 1)
    vt = np.empty((ng, 8, 128), np.float32)
    st = np.empty((ng, 8, 128), np.int32)
    if spill_idx is not None and len(spill_idx):
        spill_idx = np.ascontiguousarray(spill_idx, np.int32)
        n_spill = len(spill_idx)
    else:
        spill_idx, n_spill = np.zeros(1, np.int32), 0
    lib.spblas_fill_group_tiles(ne, elem_group, elem_scat, vals, ent,
                                n_spill, spill_idx, ng, vt.reshape(-1),
                                st.reshape(-1))
    return vt, st


def gather(idx, src):
    """Threaded ``src[idx]`` for f32/int64 1-D arrays and (k, 8, 128)
    tile stacks of 4-byte items; None for any other array (the caller
    indexes with numpy)."""
    lib = get_lib()
    idx = np.ascontiguousarray(idx, np.int32)
    n = len(idx)
    if src.ndim == 3 and src.shape[1:] == (8, 128) and src.itemsize == 4:
        src = np.ascontiguousarray(src)
        dst = np.empty((n, 8, 128), src.dtype)
        lib.spblas_gather_tiles(n, idx, src.ctypes.data_as(
            ctypes.c_void_p), dst.ctypes.data_as(ctypes.c_void_p))
        return dst
    if src.dtype == np.float32:
        src = np.ascontiguousarray(src)
        dst = np.empty(n, np.float32)
        lib.spblas_gather_f32(n, idx, src, dst)
        return dst
    if src.dtype == np.int64:
        src = np.ascontiguousarray(src)
        dst = np.empty(n, np.int64)
        lib.spblas_gather_i64(n, idx, src, dst)
        return dst
    return None


def gather_tiles_fill(idx, src, fill_tile):
    """Pad-aware (8, 128) tile gather of 4-byte items: ``out[i] =
    src[idx[i]]``, or ``fill_tile`` where ``idx[i] < 0``."""
    lib = get_lib()
    idx = np.ascontiguousarray(idx, np.int32)
    src = np.ascontiguousarray(src)
    if src.itemsize != 4 or src.shape[1:] != (8, 128):
        raise ValueError(f"gather_tiles_fill takes (k, 8, 128) tiles of "
                         f"4-byte items, got {src.dtype} {src.shape}")
    fill_tile = np.ascontiguousarray(fill_tile, src.dtype)
    n = len(idx)
    dst = np.empty((n, 8, 128), src.dtype)
    lib.spblas_gather_tiles_fill(
        n, idx, src.ctypes.data_as(ctypes.c_void_p),
        fill_tile.ctypes.data_as(ctypes.c_void_p),
        dst.ctypes.data_as(ctypes.c_void_p))
    return dst


def expand_rowptr(m, nnz, rowptr):
    """``np.repeat(np.arange(m), np.diff(rowptr))`` (int64), threaded."""
    lib = get_lib()
    rowptr = np.ascontiguousarray(rowptr, np.int64)
    rows = np.empty(nnz, np.int64)
    lib.spblas_expand_rowptr(m, nnz, rowptr, rows)
    return rows


def rcm(m, nnz, rowptr, colind):
    """Reverse Cuthill-McKee ordering on A + A^T.

    Returns (perm, halfwidth): perm[i] = old row id at new position i
    (int64), and the permuted matrix's band half-width.  Raises when the
    native library cannot be built (no identity-ordering fallback)."""
    lib = get_lib()
    rowptr = np.ascontiguousarray(rowptr, dtype=np.int64)
    colind = np.ascontiguousarray(colind, dtype=np.int32)
    perm = np.zeros(m, np.int64)
    h = int(lib.spblas_rcm(int(m), int(nnz), rowptr, colind, perm))
    return perm, h
