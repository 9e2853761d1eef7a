"""Rank tasks of the port's distributed tests (``test_torch_parallel.py``,
``test_torch_dist_spgemm.py``).

The ranks of a ``spblas_tpu_torch.parallel.launch.World`` import this
module to run them, so it imports numpy, torch and the port only, never
JAX or a test module.  Each task builds its seeded operands with the
port's generators (the JAX package's numbers, bit for bit) and returns
the rank's plan arrays and results as numpy, which the test holds to the
JAX package's.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from spblas_tpu_torch import parallel as par
from spblas_tpu_torch.formats.csr import CSR
from spblas_tpu_torch.utils import generate as gen
from spblas_tpu_torch.utils import interop


def _np(t):
    return t.detach().cpu().numpy()


def operand(shape, seed):
    """The seeded standard-normal f32 operand both sides use."""
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# a diagonal with one entry 4,000 columns off it: half-width 4000
WIDE = 4096


def wide_arrays(m=WIDE):
    """(values, rowptr, colind, shape) of the wide-band matrix."""
    rowptr = np.arange(m + 1) + (np.arange(m + 1) > 0)
    cols = np.concatenate([[0, m - 96], np.arange(1, m)])
    return np.ones(m + 1, np.float32), rowptr, cols, (m, m)


def _csr(kind, args):
    if kind == "wide":
        return CSR.from_arrays(*wide_arrays(args), device="cpu")
    if kind == "banded":
        m, bw, seed = args
        return gen.generate_banded_csr(m, m, bw, seed=seed, device="cpu")
    if kind == "triangular":
        m, seed, lower = args
        return gen.generate_triangular_csr(m, seed=seed, lower=lower,
                                           device="cpu")
    m, n, nnz, seed = args
    return gen.generate_csr(m, n, nnz, seed=seed, device="cpu")


def _fields(obj, names):
    return {k: _np(getattr(obj, k)) for k in names}


# ------------------------------------------------------------------ #

def csr_task(mesh, args, k, xseed):
    a = _csr("uniform", args)
    d = par.partition_csr(a, mesh)
    n = a.shape[1]
    x = par.partition_vector(torch.from_numpy(operand(n, xseed)), d, mesh)
    b = par.partition_vector(torch.from_numpy(operand((n, k), xseed + 1)),
                             d, mesh)
    back = par.to_local_csr(d, mesh)
    return dict(
        plan=_fields(d, ("values", "rowloc", "colloc")), nnz=d.nnz,
        mloc=d.mloc, nloc=d.nloc,
        y_ring=_np(par.gather_result(
            par.dist_spmv(d, x, mesh, strategy="ring"), d, mesh)),
        y_all=_np(par.gather_result(
            par.dist_spmv(d, x, mesh, strategy="allgather"), d, mesh)),
        c=_np(par.gather_result(par.dist_spmm(d, b, mesh), d, mesh)),
        back=_fields(back, ("values", "rowptr", "colind")),
        back_nnz=back.nnz)


def rowblock_task(mesh, args):
    a = _csr("uniform", args)
    rb = par.partition_rowblock(a, mesh)
    back = par.assemble_csr(rb, mesh)
    return dict(plan=_fields(rb, ("values", "colind", "rowptr")),
                nnz=rb.nnz, back=_fields(back, ("values", "rowptr",
                                                "colind")),
                back_nnz=back.nnz)


def band_task(mesh, args, k, xseed):
    a = _csr("banded", args)
    plan = par.partition_band(a, mesh)
    m = a.shape[0]
    x = par.partition_band_vector(torch.from_numpy(operand(m, xseed)),
                                  plan, mesh)
    b = par.partition_band_vector(
        torch.from_numpy(operand((m, k), xseed + 1)), plan, mesh)
    return dict(panels=_np(plan.panels), h=plan.h, mloc=plan.mloc,
                y=_np(mesh.all_gather(par.dist_band_spmv(plan, x, mesh))),
                c=_np(mesh.all_gather(par.dist_band_spmm(plan, b, mesh))))


def error_task(mesh, what, args):
    """The message of the ValueError an inspector or executor raises."""
    try:
        if what == "wide_band":
            par.partition_band(_csr("wide", args), mesh)
        elif what == "mesh_size":
            d = par.partition_csr(_csr("uniform", args), mesh)
            small = dataclasses.replace(mesh, size=mesh.size // 2)
            par.dist_spmv(d, torch.zeros(d.nloc), small)
    except ValueError as e:
        return str(e)
    return None


def collectives_task(mesh):
    """The mesh's collectives with JAX's semantics, on both meshes (plain
    and staged through the host)."""
    out = {}
    staged = par.make_row_mesh(device="cpu", stage_through_host=True)
    for name, m_ in (("plain", mesh), ("staged", staged)):
        r, p = m_.rank, m_.size
        t = torch.arange(3, dtype=torch.float32) + 10 * r
        out[name] = dict(
            # rank r+1 gets rank r's t; rank 0 gets zeros (no sender)
            shift=_np(m_.ppermute(t, [(i, i + 1) for i in range(p - 1)])),
            ring=_np(m_.ppermute(t, par.ring_perm(p))),
            self_pair=_np(m_.ppermute(t, [(i, i) for i in range(p)])),
            gathered=_np(m_.all_gather(t)),
            summed=_np(m_.psum(t)),
            from_last=_np(m_.broadcast(t, p - 1)),
            maxed=m_.reduce_ints([r, -r], "max"),
            total=m_.reduce_ints([r, 1], "sum"))
    out["imported"] = sorted({"jax", "spblas_tpu"} & set(sys.modules))
    return out


def sleep_task(mesh, seconds):
    """A rank that hangs (for the world's wall-clock limit)."""
    import time
    time.sleep(seconds)


ROUTE_FIELDS = ("tile", "val", "slab_base", "y_base", "src_flag")
ROUTE_STATIC = ("g", "x_rows", "out_rows", "has_aux", "dist_max",
                "any_lane", "row_window_mult", "mloc", "nloc")


def route_task(mesh, args, xseed, carried=None):
    a = _csr("uniform", args)
    plan = par.partition_route(a, mesh)
    n = a.shape[1]
    x = torch.from_numpy(operand(n, xseed))
    xl = par.partition_spmv_vector(("route", plan), x, mesh)
    out = dict(plan=_fields(plan, ROUTE_FIELDS),
               static={k: getattr(plan, k) for k in ROUTE_STATIC},
               launch_starts=plan.route.launch_starts,
               y=_np(mesh.all_gather(par.dist_route_spmv(plan, xl, mesh))))
    if carried is not None:
        cp = interop.dist_route_plan_from_numpy(*carried, mesh.rank,
                                                device="cpu")
        out["y_carried"] = _np(mesh.all_gather(
            par.dist_route_spmv(cp, xl, mesh)))
    return out


def sell_task(mesh, args, k, xseed):
    a = _csr("uniform", args)
    plan = par.partition_sell(a, mesh)
    b = par.partition_spmm_operand(
        ("sell", plan), torch.from_numpy(operand((a.shape[1], k), xseed)),
        mesh)
    return dict(values=[_np(v) for v in plan.bucket_values],
                cols=[_np(c) for c in plan.bucket_cols], pos=_np(plan.pos),
                c=_np(mesh.all_gather(par.dist_sell_spmm(plan, b, mesh))))


ADD_FIELDS = ("slot_a", "slot_b", "c_rowptr", "c_colind")


def add_task(mesh, args_a, args_b, scales, carried=None):
    a = par.partition_rowblock(_csr("uniform", args_a), mesh)
    b = par.partition_rowblock(_csr("uniform", args_b), mesh)
    plan = par.dist_add_compute(a, b, mesh)
    a2 = dataclasses.replace(a, values=a.values * 2.0)
    out = dict(plan=_fields(plan, ADD_FIELDS), c_nnz=plan.c_nnz,
               c=_np(par.dist_add_numeric(plan, a, b, mesh).values),
               c2=_np(par.dist_add_numeric(plan, a2, b, mesh,
                                           *scales).values))
    if carried is not None:
        cp = interop.dist_add_plan_from_numpy(*carried, mesh.rank,
                                              device="cpu")
        out["c2_carried"] = _np(par.dist_add_numeric(cp, a2, b, mesh,
                                                     *scales).values)
    return out


TRSV_FIELDS = ("rows", "eidx", "evalid", "cols", "ldiag", "lvals", "ovals",
               "ocols", "orows")


def trsv_task(mesh, args, uplo, xseed):
    a = _csr("triangular", args)
    plan = par.dist_triangular_solve_inspect(a, mesh, uplo=uplo)
    b = par.partition_vector(torch.from_numpy(operand(a.shape[0], xseed)),
                             plan, mesh, axis="rows")
    x = par.dist_triangular_solve(plan, b, mesh)
    return dict(plan=_fields(plan, TRSV_FIELDS), mloc=plan.mloc,
                x=_np(mesh.all_gather(x)))


def staging_task(mesh, band_args, route_args, xseed):
    """The band halo, the ring and the route all-gather on a mesh over
    the same group that stages through the host: the same bits as the
    plain mesh, and the bytes counted."""
    staged = par.make_row_mesh(device="cpu", stage_through_host=True)
    out = {}
    for name, m_ in (("plain", mesh), ("staged", staged)):
        a = _csr("banded", band_args)
        plan = par.partition_band(a, m_)
        x = par.partition_band_vector(
            torch.from_numpy(operand(a.shape[0], xseed)), plan, m_)
        u = _csr("uniform", route_args)
        rp = par.partition_route(u, m_)
        d = par.partition_csr(u, m_)
        xu = torch.from_numpy(operand(u.shape[1], xseed + 1))
        out[name] = dict(
            band=_np(par.dist_band_spmv(plan, x, m_)),
            route=_np(par.dist_route_spmv(
                rp, par.partition_spmv_vector(("route", rp), xu, m_), m_)),
            ring=_np(par.dist_spmv(d, par.partition_vector(xu, d, m_), m_)),
            tri=_np(par.dist_triangular_solve(
                par.dist_triangular_solve_inspect(
                    _csr("triangular", (512, 3, True)), m_),
                torch.ones(128), m_)))
    out["staged_bytes"] = staged.staged_bytes
    out["plain_bytes"] = mesh.staged_bytes
    return out


def chooser_task(mesh, band_args, args):
    """The choosers' kinds on a CPU mesh, and each forced kind's result."""
    a, u = _csr("banded", band_args), _csr("uniform", args)
    out = {"auto_spmv": par.partition_spmv(u, mesh)[0],
           "auto_spmm": par.partition_spmm(a, mesh)[0]}
    for kind, mat in (("band", a), ("route", u), ("csr", u)):
        kp = par.partition_spmv(mat, mesh, prefer=kind)
        x = par.partition_spmv_vector(kp, torch.ones(mat.shape[1]), mesh)
        out[f"spmv_{kind}"] = _np(mesh.all_gather(
            par.dist_plan_spmv(kp, x, mesh)).reshape(-1)[:mat.shape[0]])
    for kind, mat in (("band", a), ("sell", u), ("csr", u)):
        kp = par.partition_spmm(mat, mesh, prefer=kind)
        b = par.partition_spmm_operand(kp, torch.ones(mat.shape[1], 3),
                                       mesh)
        out[f"spmm_{kind}"] = _np(mesh.all_gather(
            par.dist_plan_spmm(kp, b, mesh)).reshape(-1, 3)[:mat.shape[0]])
    return out


# ------------------------------------------------------------------ #
# SpGEMM
# ------------------------------------------------------------------ #

SPGEMM_FIELDS = ("src_a", "src_b", "valid", "slot", "c_rowptr", "c_colind")
PANEL_FIELDS = ("t1", "t2", "ab", "bb", "yb", "fl", "eva", "evb", "evw",
                "evs")


def spgemm_task(mesh, args_a, args_b, engine, panel_slots=None,
                carried=None):
    """The rank's plan (and engine) and its C block: one numeric, then a
    reuse on A's values doubled."""
    env = {"SPBLAS_FORCE_ROUTE_SPGEMM": "1" if engine else None,
           "SPBLAS_DIST_MUL_PANEL_SLOTS": panel_slots}
    old = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        a = par.partition_rowblock(_csr("uniform", args_a), mesh)
        b = par.partition_rowblock(_csr("uniform", args_b), mesh)
        plan = par.dist_spgemm_compute(a, b, mesh)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    a2 = dataclasses.replace(a, values=a.values * 2.0)
    out = dict(plan=_fields(plan, SPGEMM_FIELDS), c_nnz=plan.c_nnz,
               result_nnz=plan.result_nnz,
               c=_np(par.dist_spgemm_numeric(plan, a, b, mesh).values),
               c2=_np(par.dist_spgemm_numeric(plan, a2, b, mesh).values),
               engine=None)
    eng = plan.engine
    if eng is not None:
        out["engine"] = dict(
            panels=[dict(_fields(p, PANEL_FIELDS), slots=p.slots,
                         out_rows=p.out_rows, has_aux=p.has_aux,
                         dist_max=p.dist_max) for p in eng.panels],
            static={k: getattr(eng, k) for k in (
                "g_a", "g_b", "a_rows", "b_rows_pad", "pane_rows",
                "capacity")},
            stream=_np(eng.expansion.run_start))
    if carried is not None:
        arrays, static, *engine_np = carried
        cp = interop.dist_spgemm_plan_from_numpy(
            arrays, static, mesh.rank,
            engine=engine_np[0] if engine_np else None, device="cpu")
        out["c2_carried"] = _np(par.dist_spgemm_numeric(cp, a2, b,
                                                        mesh).values)
    return out


def one_shot_task(mesh, args_a, args_b):
    c = par.dist_spgemm(_csr("uniform", args_a), _csr("uniform", args_b),
                        mesh)
    back = par.assemble_csr(c, mesh)
    return dict(back=_fields(back, ("values", "rowptr", "colind")),
                nnz=back.nnz)
