"""Lazy views: scaled / conjugated / transposed / optimized.

Counterpart of ``spblas_tpu/views.py``.  The wrappers are small
dataclasses carrying (alpha, conj-flag) that ops fold into their kernels;
``OptimizedMatrix`` caches per-op plans (the ``matrix_opt`` handle).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from spblas_tpu_torch.formats.bsr import BSR
from spblas_tpu_torch.formats.csr import CSR
from spblas_tpu_torch.formats.csc import CSC
from spblas_tpu_torch.formats.coo import COO
from spblas_tpu_torch.formats.dcsr import DCSR


@dataclasses.dataclass(frozen=True)
class ScaledView:
    """Lazy alpha * base.  ``alpha`` is a 0-d tensor, so it combines with
    tensors on any device and promotes like a scalar."""
    alpha: torch.Tensor
    base: Any

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return torch.result_type(self.alpha, _probe(self.base))


@dataclasses.dataclass(frozen=True)
class ConjugatedView:
    """Lazy conj(base)."""
    base: Any

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype


def _probe(t) -> torch.Tensor:
    """A one-element tensor of ``t``'s dtype, for dtype promotion."""
    return torch.empty(1, dtype=t.dtype)


def scaled(alpha, tensor):
    """Lazy alpha-scaling view."""
    return ScaledView(alpha=torch.as_tensor(alpha), base=tensor)


def conjugated(tensor):
    """Lazy conjugation; identity for real tensors."""
    if tensor.dtype.is_complex:
        if isinstance(tensor, ConjugatedView):
            return tensor.base  # conj(conj(x)) == x
        return ConjugatedView(base=tensor)
    return tensor


def transposed(tensor):
    """Zero-cost lazy transpose: CSR(m, n) is reinterpreted as CSC(n, m)
    over the same arrays, and vice versa."""
    if isinstance(tensor, ScaledView):
        return ScaledView(alpha=tensor.alpha, base=transposed(tensor.base))
    if isinstance(tensor, ConjugatedView):
        return ConjugatedView(base=transposed(tensor.base))
    if isinstance(tensor, OptimizedMatrix):
        # stay optimized through the flip, with a plan cache of its own
        # (the cached plans describe the untransposed orientation); the
        # flipped handle is kept, so a second flip inspects nothing anew
        return tensor.flipped()
    if isinstance(tensor, CSR):
        m, n = tensor.shape
        return CSC(values=tensor.values, colptr=tensor.rowptr,
                   rowind=tensor.colind, nnz=tensor.nnz, shape=(n, m))
    if isinstance(tensor, CSC):
        m, n = tensor.shape
        return CSR(values=tensor.values, rowptr=tensor.colptr,
                   colind=tensor.rowind, nnz=tensor.nnz, shape=(n, m))
    if isinstance(tensor, COO):
        raise TypeError("transposed(COO) would break row-major sorting; "
                        "use a materialized transpose")
    return tensor.transpose(-1, -2)


class OptimizedMatrix:
    """Opaque optimized-matrix wrapper — the ``matrix_opt`` analogue.
    Caches per-op plans keyed by plan name."""

    def __init__(self, base):
        self.base = base
        self._plans = {}
        self._flipped = None

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    def flipped(self) -> "OptimizedMatrix":
        """The transposed matrix's handle, made on first use and kept
        (both ways), so dense·sparse products reuse its plans."""
        if self._flipped is None:
            self._flipped = OptimizedMatrix(transposed(self.base))
            self._flipped._flipped = self
        return self._flipped

    def get_plan(self, key, builder):
        """Return the cached plan for ``key``, building it on first use."""
        if key not in self._plans:
            self._plans[key] = builder(self.base)
        return self._plans[key]


def matrix_opt(tensor) -> OptimizedMatrix:
    if isinstance(tensor, OptimizedMatrix):
        return tensor
    return OptimizedMatrix(tensor)


# --------------------------------------------------------------------- #
# runtime view inspection
# --------------------------------------------------------------------- #

_WRAPPERS = (ScaledView, ConjugatedView, OptimizedMatrix)


def get_ultimate_base(t):
    """Walk wrapper chains to the underlying container or tensor."""
    while isinstance(t, _WRAPPERS):
        t = t.base
    return t


def get_scaling_factor(t, dtype=None):
    """Product of all nested scaling factors; a scaling inside an odd
    number of conjugation views is itself conjugated."""
    alpha = None
    conj_depth = 0
    while isinstance(t, _WRAPPERS):
        if isinstance(t, ConjugatedView):
            conj_depth += 1
        if isinstance(t, ScaledView):
            a = t.alpha.conj() if conj_depth % 2 else t.alpha
            alpha = a if alpha is None else alpha * a
        t = t.base
    if alpha is None:
        dt = dtype or getattr(t, "dtype", None)
        # a numpy operand's dtype is no torch dtype: the default float
        # then acts as a weak scalar under promotion
        return torch.ones((), dtype=dt if isinstance(dt, torch.dtype)
                          else None)
    return alpha


def is_conjugated(t) -> bool:
    """Parity of nested conjugation views."""
    conj = False
    while isinstance(t, _WRAPPERS):
        if isinstance(t, ConjugatedView):
            conj = not conj
        t = t.base
    return conj


def has_matrix_opt(t) -> bool:
    return get_matrix_opt(t) is not None


def get_matrix_opt(t):
    while isinstance(t, (ScaledView, ConjugatedView)):
        t = t.base
    return t if isinstance(t, OptimizedMatrix) else None


def fold(t):
    """Collapse a view chain to (base, alpha, conj_flag)."""
    return get_ultimate_base(t), get_scaling_factor(t), is_conjugated(t)


def fold_values(values, alpha, conj: bool):
    """Apply a folded (alpha, conj) to an entry-value tensor: conjugate
    first, then scale."""
    if conj:
        values = values.conj()
    return values * alpha


def is_csr(t) -> bool:
    return isinstance(get_ultimate_base(t), CSR)


def is_csc(t) -> bool:
    return isinstance(get_ultimate_base(t), CSC)


def is_coo(t) -> bool:
    return isinstance(get_ultimate_base(t), COO)


def is_sparse(t) -> bool:
    return isinstance(get_ultimate_base(t), (CSR, CSC, COO, BSR, DCSR))


def is_dense_matrix(t) -> bool:
    b = get_ultimate_base(t)
    return hasattr(b, "ndim") and not is_sparse(t) and b.ndim == 2


def is_vector(t) -> bool:
    b = get_ultimate_base(t)
    return hasattr(b, "ndim") and not is_sparse(t) and b.ndim == 1
