"""Iterative solvers on top of the sparse ops — counterpart of
``spblas_tpu/solvers.py``.

Every solver takes an operator that ``spmv`` accepts (a container, a
``matrix_opt`` handle, a view over either) or a matvec callable.  On the
card each SpMV of a ``matrix_opt`` operator launches its plan's kernel
(``band_spmv`` on a band, ``dia_spmv`` on a stencil, ``route2_spmv`` on
unstructured matrices).

The JAX package runs each loop as one ``lax.while_loop`` or
``fori_loop``, with no host sync an iteration.  Here the loops run
eagerly with their state on the operands' device: ``power_method`` and
``jacobi`` have fixed trip counts and read nothing back until the caller
reads the result; ``cg`` freezes its state once converged (``torch.where``
on a device flag, the iteration count kept on the device) and reads the
flag to the host once every :data:`CHECK_EVERY` iterations, so it returns
what a loop that tests every step returns after at most
``CHECK_EVERY - 1`` frozen iterations past convergence.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from spblas_tpu_torch import types as _t
from spblas_tpu_torch import views as _v
from spblas_tpu_torch.ops.spmv import spmv

# cg's iterations between two host reads of its convergence flag
CHECK_EVERY = 32


def _as_matvec(a) -> Callable:
    if callable(a) and not hasattr(a, "shape"):
        return a
    return lambda v: spmv(a, v)


def _host_flag(flag: torch.Tensor) -> bool:
    """The one host read of ``cg``'s convergence flag (a device bool),
    once every :data:`CHECK_EVERY` iterations; a function of its own so
    that the reads can be counted."""
    return bool(flag)


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor
    residual_norm: torch.Tensor


def cg(a, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       tol: float = 1e-6, maxiter: int = 1000) -> CGResult:
    """Conjugate gradients for SPD A (matrix container, optimized plan
    via matrix_opt, or a matvec callable).  Iterates while ||r||^2 >
    tol^2 ||b||^2 and fewer than ``maxiter`` steps ran; ``iterations``
    and ``residual_norm`` are device scalars."""
    mv = _as_matvec(a)
    b = torch.as_tensor(b)
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0)
    r = b - mv(x)
    p = r
    rs = torch.vdot(r, r).real
    tol2 = torch.tensor(tol, dtype=rs.dtype, device=rs.device) ** 2 \
        * torch.vdot(b, b).real
    k = torch.zeros((), dtype=torch.int32, device=rs.device)
    done = rs <= tol2
    for it in range(maxiter):
        if it % CHECK_EVERY == 0 and _host_flag(done):
            break
        ap = mv(p)
        alpha = rs / torch.vdot(p, ap).real
        x_n = x + alpha * p
        r_n = r - alpha * ap
        rs_n = torch.vdot(r_n, r_n).real
        p_n = r_n + (rs_n / rs) * p
        # a converged state stays as it was (JAX's loop has stopped)
        x = torch.where(done, x, x_n)
        r = torch.where(done, r, r_n)
        p = torch.where(done, p, p_n)
        rs = torch.where(done, rs, rs_n)
        k = k + (~done).to(k.dtype)
        done = done | (rs <= tol2)
    return CGResult(x=x, iterations=k, residual_norm=torch.sqrt(rs))


class PowerResult(NamedTuple):
    eigenvalue: torch.Tensor
    eigenvector: torch.Tensor


def _operator_device(a, generator) -> torch.device:
    base = _v.get_ultimate_base(a) if hasattr(a, "shape") else None
    dev = getattr(base, "device", None)
    if dev is None and generator is not None:
        dev = generator.device
    return _t.resolve_device(dev)


def power_method(a, n: int, iters: int = 100,
                 generator: Optional[torch.Generator] = None
                 ) -> PowerResult:
    """Dominant eigenpair by power iteration (normalized each step).  v0
    is standard normal from ``generator`` (a fresh one seeded 0 when
    None), in the operator's dtype; JAX's PRNG key has no torch
    counterpart that gives the same bits."""
    mv = _as_matvec(a)
    dev = _operator_device(a, generator)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    # iterate in the operator's dtype (JAX's rule: a complex operator
    # draws a real v0 and casts it)
    op_dtype = getattr(a, "dtype", torch.float32)
    if not isinstance(op_dtype, torch.dtype):
        op_dtype = torch.float32
    real = op_dtype if op_dtype.is_floating_point else torch.float32
    v0 = torch.randn(n, generator=generator, dtype=real,
                     device=generator.device).to(device=dev, dtype=op_dtype)
    v = v0 / torch.linalg.norm(v0)
    for _ in range(iters):
        w = mv(v)
        v = w / torch.clamp(torch.linalg.norm(w), min=1e-30)
    lam = torch.vdot(v, mv(v)).real
    return PowerResult(eigenvalue=lam, eigenvector=v)


def jacobi(a, b: torch.Tensor, diag: torch.Tensor,
           x0: Optional[torch.Tensor] = None, iters: int = 50,
           omega: float = 1.0) -> torch.Tensor:
    """(Weighted) Jacobi smoother: x <- x + omega D^-1 (b - A x).

    ``diag`` is A's diagonal (the caller extracts it once; the framework
    stores matrices by structure plans, not by element access)."""
    mv = _as_matvec(a)
    b = torch.as_tensor(b)
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0)
    inv_d = torch.tensor(omega, dtype=b.dtype, device=b.device) / diag
    for _ in range(iters):
        x = x + inv_d * (b - mv(x))
    return x
