"""Sort-based sparse building blocks — counterpart of
``spblas_tpu/backend/engine.py``.

The expand → sort → compress (ESC) formulation of the SpGEMM structure
pass, as torch ops on the operands' device: a stable sort, cumulative
sums and segment reductions in place of the reference's scatter-style
accumulators.  Invalid or padded entries carry a sentinel row ``m`` that
sorts after every live entry and is dropped by the reductions.

One difference from the JAX module: :func:`lexsort_coo` is one stable
``torch.sort`` on the packed key ``row * (n + 1) + col``.  The JAX
``lax.sort(..., num_keys=2)`` is not declared stable, so the structure
(rowptr, colind, slot numbering) is the same on both sides, while the
order of the payload inside one (row, col) group may differ.
"""

from __future__ import annotations

from typing import Tuple

import torch

from spblas_tpu_torch import types as _t


def lexsort_coo(rows, cols, n: int, *payload) -> Tuple[torch.Tensor, ...]:
    """Stable lexicographic sort of COO triples by (row, col), for
    columns in [0, n).  Invalid entries must already carry a sentinel
    row >= m so they sink to the tail.  Returns (rows, cols, *payload)
    sorted."""
    key = rows.long() * (n + 1) + cols.long()
    _, order = torch.sort(key, stable=True)
    return tuple(t[order] for t in (rows, cols) + tuple(payload))


def head_flags(rows_sorted, cols_sorted, valid_sorted) -> torch.Tensor:
    """True at the first entry of each (row, col) group among live
    entries."""
    prev_r = torch.cat([rows_sorted[:1] - 1, rows_sorted[:-1]])
    prev_c = torch.cat([cols_sorted[:1] - 1, cols_sorted[:-1]])
    new_group = (rows_sorted != prev_r) | (cols_sorted != prev_c)
    return new_group & valid_sorted


def coalesce_sorted(rows_sorted, cols_sorted, valid_sorted, m: int):
    """(heads, slots, nnz, rowptr) for a (row, col)-sorted stream; nnz is
    a 0-d tensor."""
    heads = head_flags(rows_sorted, cols_sorted, valid_sorted)
    slots = torch.cumsum(heads.to(_t.offset_dtype), 0,
                         dtype=_t.offset_dtype) - 1
    nnz = heads.sum().to(torch.int32)
    rowptr = rowptr_from_counts(row_counts(rows_sorted, heads, m), m)
    return heads, slots, nnz, rowptr


def compress(rows_sorted, cols_sorted, vals_sorted, valid_sorted,
             m: int, out_capacity: int):
    """Coalesce sorted COO entries: sum duplicates, emit the unique
    structure.  Returns (out_vals, out_rows, out_cols, rowptr, nnz);
    entries beyond ``out_capacity`` are dropped (callers check nnz)."""
    heads = head_flags(rows_sorted, cols_sorted, valid_sorted)
    slots = torch.cumsum(heads.to(_t.offset_dtype), 0,
                         dtype=_t.offset_dtype) - 1
    nnz = heads.sum().to(torch.int32)
    drop = out_capacity
    slot_or_drop = torch.where(valid_sorted, slots, drop).clamp(max=drop)
    zero = torch.zeros((), dtype=vals_sorted.dtype,
                       device=vals_sorted.device)
    out_vals = torch.zeros(out_capacity + 1, dtype=vals_sorted.dtype,
                           device=vals_sorted.device).index_add_(
        0, slot_or_drop.long(), torch.where(valid_sorted, vals_sorted,
                                            zero))[:out_capacity]
    head_slot = torch.where(heads, slots, drop).clamp(max=drop).long()
    out_cols = scatter_set(head_slot, cols_sorted, out_capacity)
    out_rows = scatter_set(head_slot, rows_sorted, out_capacity)
    rowptr = rowptr_from_counts(row_counts(rows_sorted, heads, m), m)
    return out_vals, out_rows, out_cols, rowptr, nnz


def scatter_set(slot, values, capacity: int) -> torch.Tensor:
    """out[slot] = values over (capacity,) int32 zeros; slot == capacity
    drops.  The slots below capacity must be unique (group heads)."""
    out = torch.zeros(capacity + 1, dtype=_t.index_dtype,
                      device=values.device)
    out[slot] = values.to(_t.index_dtype)
    return out[:capacity]


def symbolic_compress(rows_sorted, cols_sorted, valid_sorted, m: int):
    """Structure-only pass: (rowptr, nnz) of the unique entries."""
    heads = head_flags(rows_sorted, cols_sorted, valid_sorted)
    counts = row_counts(rows_sorted, heads, m)
    return rowptr_from_counts(counts, m), heads.sum().to(torch.int32)


def row_counts(rows, weights, m: int) -> torch.Tensor:
    """Per-row count of entries with True/1 weight; rows >= m dropped."""
    out = torch.zeros(m + 1, dtype=_t.offset_dtype, device=rows.device)
    out.index_add_(0, rows.long().clamp(0, m), weights.to(_t.offset_dtype))
    return out[:m]


def rowptr_from_counts(counts, m: int) -> torch.Tensor:
    out = torch.zeros(m + 1, dtype=_t.offset_dtype, device=counts.device)
    out[1:] = torch.cumsum(counts, 0)
    return out


def segment_ids_from_ptr(ptr, capacity: int) -> torch.Tensor:
    """Inverse of rowptr: per-entry segment id; padded entries map past
    the last segment (ptr has len m + 1)."""
    e = torch.arange(capacity, dtype=ptr.dtype, device=ptr.device)
    return torch.searchsorted(ptr[1:], e, right=True).to(_t.index_dtype)


def expansion_maps(a_rowptr, a_colind, a_mask, b_rowptr, a_capacity: int,
                   b_capacity: int, e_capacity: int, m: int):
    """Gather maps of the SpGEMM expansion: for each live A entry t =
    (i, k), every entry of B row k.  Returns per-expanded-entry arrays of
    shape (e_capacity,): a_idx (source A entry), b_idx (source B entry,
    clamped in bounds), rows (output row, sentinel m when invalid) and
    valid — Gustavson's flop enumeration as pure gathers."""
    dev = a_colind.device
    b_len = (b_rowptr[1:] - b_rowptr[:-1]).long()
    counts = torch.where(a_mask, b_len[a_colind.long()], 0)
    ends = torch.cumsum(counts, 0)                      # inclusive, int64
    total = ends[-1] if a_capacity > 0 else torch.zeros(
        (), dtype=torch.int64, device=dev)
    e = torch.arange(e_capacity, dtype=torch.int64, device=dev)
    t = torch.searchsorted(ends, e, right=True)
    valid = (e < total) & (t < a_capacity)
    t_c = t.clamp(max=max(a_capacity - 1, 0))
    starts = ends[t_c] - counts[t_c]
    local = e - starts
    k = a_colind[t_c].long()
    b_idx = (b_rowptr[k].long() + local).clamp(0, max(b_capacity - 1, 0))
    a_rows = segment_ids_from_ptr(a_rowptr, a_capacity)
    rows = torch.where(valid, a_rows[t_c], m).to(_t.index_dtype)
    return (t_c.to(_t.offset_dtype), b_idx.to(_t.offset_dtype), rows,
            valid)
