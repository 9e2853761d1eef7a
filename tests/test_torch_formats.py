"""spblas_tpu_torch containers, conversions, device rule and isolation,
held to the JAX package on the same seeded numpy inputs."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import spblas_tpu as sp
from spblas_tpu import types as jtypes
from spblas_tpu.formats.convert import to_csr as jax_to_csr
from spblas_tpu.utils import generate as gen

import spblas_tpu_torch as tsp
from spblas_tpu_torch import types as ttypes
from spblas_tpu_torch.formats.convert import to_csr as port_to_csr
from spblas_tpu_torch.formats.dcsr import DCSR
from spblas_tpu_torch.utils import generate as tgen
from spblas_tpu_torch.utils import interop

from tests.torch_util import (  # noqa: F401
    port_csr, to_np, one_torch_thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _csr_arrays(m=60, n=50, nnz=300, seed=0):
    return gen.generate_csr_arrays(m, n, nnz, seed=seed)


@pytest.mark.parametrize("capacity", [None, 512, 1000])
def test_csr_from_arrays_padding_matches_jax(capacity):
    vals, rowptr, cols = _csr_arrays()
    a = sp.CSR.from_arrays(vals, rowptr, cols, (60, 50), nnz=300,
                           capacity=capacity)
    b = tsp.CSR.from_arrays(vals, rowptr, cols, (60, 50), nnz=300,
                            capacity=capacity, device="cpu")
    assert b.capacity == a.capacity and b.nnz == int(a.nnz)
    np.testing.assert_array_equal(to_np(b.values), np.asarray(a.values))
    np.testing.assert_array_equal(to_np(b.colind), np.asarray(a.colind))
    np.testing.assert_array_equal(to_np(b.rowptr), np.asarray(a.rowptr))
    assert b.colind.dtype == torch.int32 and b.rowptr.dtype == torch.int32


def test_csr_oversized_buffer_is_made_canonical():
    vals, rowptr, cols = _csr_arrays()
    stale_v = np.concatenate([vals, np.full(20, 7.0, np.float32)])
    stale_c = np.concatenate([cols, np.full(20, 3)])
    a = sp.CSR.from_arrays(stale_v, rowptr, stale_c, (60, 50), nnz=300)
    b = tsp.CSR.from_arrays(stale_v, rowptr, stale_c, (60, 50), nnz=300,
                            device="cpu")
    np.testing.assert_array_equal(to_np(b.values), np.asarray(a.values))
    np.testing.assert_array_equal(to_np(b.colind), np.asarray(a.colind))
    b.validate()


def test_row_ids_map_padding_to_m():
    a = gen.generate_csr(40, 30, 200, seed=3, capacity=256)
    b = port_csr(a)
    np.testing.assert_array_equal(to_np(b.row_ids()), np.asarray(a.row_ids()))
    assert int(b.row_ids()[-1]) == 40


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo"])
def test_todense_matches_jax(fmt):
    m, n, nnz = 45, 70, 400
    if fmt == "csr":
        a = gen.generate_csr(m, n, nnz, seed=4, capacity=512)
        b = port_csr(a)
    elif fmt == "csc":
        a = gen.generate_csc(m, n, nnz, seed=4, capacity=512)
        b = tsp.CSC.from_arrays(np.asarray(a.values), np.asarray(a.colptr),
                                np.asarray(a.rowind), a.shape, nnz=nnz,
                                capacity=512, device="cpu")
    else:
        a = gen.generate_coo(m, n, nnz, seed=4, capacity=512)
        b = tsp.COO.from_arrays(np.asarray(a.values), np.asarray(a.rowind),
                                np.asarray(a.colind), a.shape, nnz=nnz,
                                capacity=512, device="cpu")
    np.testing.assert_array_equal(to_np(b.todense()), np.asarray(a.todense()))


def test_csr_from_dense_matches_jax():
    rng = np.random.default_rng(12)
    dense = rng.uniform(-1, 1, (40, 33)).astype(np.float32)
    dense[np.abs(dense) < 0.7] = 0
    a = sp.CSR.from_dense(dense)
    for src in (dense, torch.from_numpy(dense)):
        b = tsp.CSR.from_dense(src, device="cpu")
        for t, j in ((b.values, a.values), (b.rowptr, a.rowptr),
                     (b.colind, a.colind)):
            np.testing.assert_array_equal(to_np(t), np.asarray(j))
        np.testing.assert_array_equal(to_np(b.todense()), dense)


@pytest.mark.parametrize("src", ["coo", "csc"])
def test_to_csr_matches_jax(src):
    if src == "coo":
        a = gen.generate_coo(50, 40, 300, seed=5, capacity=512)
        b = tsp.COO.from_arrays(np.asarray(a.values), np.asarray(a.rowind),
                                np.asarray(a.colind), a.shape, nnz=300,
                                capacity=512, device="cpu")
    else:
        a = gen.generate_csc(50, 40, 300, seed=5, capacity=512)
        b = tsp.CSC.from_arrays(np.asarray(a.values), np.asarray(a.colptr),
                                np.asarray(a.rowind), a.shape, nnz=300,
                                capacity=512, device="cpu")
    ja, tb = jax_to_csr(a), port_to_csr(b)
    tb.validate()
    np.testing.assert_array_equal(to_np(tb.rowptr), np.asarray(ja.rowptr))
    np.testing.assert_array_equal(to_np(tb.todense()),
                                  np.asarray(ja.todense()))


@pytest.mark.parametrize("fault", ["rowptr_end", "colind_range",
                                   "padding"])
def test_validate_raises_like_jax(fault):
    vals, rowptr, cols = _csr_arrays()
    rowptr, cols = rowptr.copy(), cols.copy()
    if fault == "rowptr_end":
        rowptr[-1] = 299
    elif fault == "colind_range":
        cols[5] = 50
    a = sp.CSR.from_arrays(vals, rowptr, cols, (60, 50), nnz=300)
    b = tsp.CSR.from_arrays(vals, rowptr, cols, (60, 50), nnz=300,
                            device="cpu")
    if fault == "padding":
        # break the canonical zero padding behind the constructor's back
        b.values[-1] = 1.0
        a = a.update(a.values.at[-1].set(1.0))
    with pytest.raises(ValueError):
        a.validate()
    with pytest.raises(ValueError):
        b.validate()


def test_interop_keeps_bits():
    a = gen.generate_banded_csr(300, 320, 9, seed=6, capacity=4096)
    b = port_csr(a)
    assert b.capacity == 4096 and b.shape == (300, 320)
    for t, j in ((b.values, a.values), (b.rowptr, a.rowptr),
                 (b.colind, a.colind)):
        np.testing.assert_array_equal(to_np(t), np.asarray(j))


@pytest.mark.parametrize("nnz", [0, 1, 5, 1000, 1024, 1025])
def test_quantize_capacity_matches_jax(nnz):
    assert ttypes.quantize_capacity(nnz) == jtypes.quantize_capacity(nnz)


@pytest.mark.parametrize("ctor", ["csr", "csc", "coo", "bsr",
                                  "generate_csr", "generate_vector",
                                  "band_plan", "dia_plan",
                                  "permuted_band_plan", "csc_from_dense",
                                  "generate_dcsr", "dcsr_from_csr"])
def test_default_device_raises_without_cuda(ctor, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vals, rowptr, cols = _csr_arrays()
    calls = {
        "csr": lambda: tsp.CSR.from_arrays(vals, rowptr, cols, (60, 50)),
        "csc": lambda: tsp.CSC.from_arrays(vals, rowptr, cols, (50, 60)),
        "coo": lambda: tsp.COO.from_arrays(vals, cols, cols, (60, 50)),
        "bsr": lambda: tsp.BSR.from_dense(np.eye(16, dtype=np.float32),
                                          (8, 8)),
        "generate_csr": lambda: tgen.generate_csr(20, 20, 40),
        "generate_vector": lambda: tgen.generate_vector(20),
        "band_plan": lambda: interop.band_plan_from_numpy(
            np.zeros((1024, 136), np.float32), 4, (1000, 1000)),
        "dia_plan": lambda: interop.dia_plan_from_numpy(
            np.zeros((1, 256, 128), np.float32), (0,), (100, 100)),
        "permuted_band_plan": lambda: interop.permuted_band_plan_from_numpy(
            np.zeros((1024, 136), np.float32), 4, (1000, 1000),
            np.arange(1024), np.arange(1024)),
        "csc_from_dense": lambda: tsp.CSC.from_dense(
            np.eye(8, dtype=np.float32)),
        "generate_dcsr": lambda: tgen.generate_dcsr(100, 50, 120),
        # the DCSR lives on its CSR's device: a CSR made without a
        # device raises before it
        "dcsr_from_csr": lambda: DCSR.from_csr(
            tsp.CSR.from_dense(np.eye(8, dtype=np.float32))),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[ctor]()


def test_public_surface_matches_jax():
    """The port exports every name of the JAX package's ``__all__``, and
    its ``solvers`` module (not listed there) with the same solvers."""
    assert set(sp.__all__) <= set(tsp.__all__), \
        set(sp.__all__) - set(tsp.__all__)
    for name in sp.__all__:
        assert getattr(tsp, name) is not None
    for name in ("cg", "power_method", "jacobi", "CGResult", "PowerResult"):
        assert hasattr(sp.solvers, name) and hasattr(tsp.solvers, name)


def test_parallel_surface_matches_jax():
    """``spblas_tpu_torch.parallel`` exports every name of the JAX
    package's ``parallel.__all__`` but ``row_sharding`` and
    ``replicated``, which name JAX placements of a global array (ROADMAP
    item 17)."""
    import spblas_tpu.parallel as jpar
    import spblas_tpu_torch.parallel as tpar
    missing = set(jpar.__all__) - set(tpar.__all__)
    assert missing == {"row_sharding", "replicated"}, missing
    for name in set(jpar.__all__) - missing:
        assert getattr(tpar, name) is not None


def test_generators_match_jax_arrays():
    """The port's generators draw the JAX package's numbers."""
    cases = [
        (gen.generate_csr(80, 90, 500, seed=7),
         tgen.generate_csr(80, 90, 500, seed=7, device="cpu")),
        (gen.generate_banded_csr(200, 180, 11, seed=8),
         tgen.generate_banded_csr(200, 180, 11, seed=8, device="cpu")),
        (gen.generate_stencil_csr((7, 8, 9), seed=9),
         tgen.generate_stencil_csr((7, 8, 9), seed=9, device="cpu")),
        (gen.generate_fem_graph_csr(12, 15, seed=10),
         tgen.generate_fem_graph_csr(12, 15, seed=10, device="cpu")),
    ]
    for a, b in cases:
        for t, j in ((b.values, a.values), (b.rowptr, a.rowptr),
                     (b.colind, a.colind)):
            np.testing.assert_array_equal(to_np(t), np.asarray(j))
    np.testing.assert_array_equal(
        to_np(tgen.generate_vector(33, seed=11, device="cpu")),
        gen.generate_vector(33, seed=11))


def test_traced_opens_profiler_range():
    a = tgen.generate_csr(30, 30, 90, seed=1, device="cpu")
    x = tgen.generate_vector(30, seed=2, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tsp.multiply(a, x)
    names = {e.key for e in prof.key_averages()}
    assert {"spblas.multiply", "spblas.spmv"} <= names


def test_port_imports_neither_jax_nor_spblas_tpu():
    """With jax and spblas_tpu made unimportable, every module of the
    port imports and the CPU main path runs."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["spblas_tpu"] = None
        import importlib, pkgutil
        import spblas_tpu_torch as sp
        seen = set()
        for mod in pkgutil.walk_packages(sp.__path__, "spblas_tpu_torch."):
            importlib.import_module(mod.name)
            seen.add(mod.name)
        assert {"spblas_tpu_torch.native", "spblas_tpu_torch.kernels.route2",
                "spblas_tpu_torch.kernels.route2_kernel",
                "spblas_tpu_torch.kernels.route_plan",
                "spblas_tpu_torch.kernels.route_spmv",
                "spblas_tpu_torch.kernels.route_paned",
                "spblas_tpu_torch.kernels.bsr_kernels",
                "spblas_tpu_torch.formats.bsr",
                "spblas_tpu_torch.ops.spmm",
                "spblas_tpu_torch.ops.spgemm",
                "spblas_tpu_torch.backend.engine",
                "spblas_tpu_torch.kernels.route_mul_paned",
                "spblas_tpu_torch.kernels.mul_fill",
                "spblas_tpu_torch.kernels.bsr_spgemm",
                "spblas_tpu_torch.kernels.route_mul",
                "spblas_tpu_torch.kernels.route_mul_kernel",
                "spblas_tpu_torch.ops.triangular_solve",
                "spblas_tpu_torch.ops.add",
                "spblas_tpu_torch.ops.transpose",
                "spblas_tpu_torch.ops.scale",
                "spblas_tpu_torch.formats.dcsr",
                "spblas_tpu_torch.kernels.ell",
                "spblas_tpu_torch.solvers",
                "spblas_tpu_torch.utils.io",
                "spblas_tpu_torch.utils.serialize",
                "spblas_tpu_torch.utils.profiling",
                "spblas_tpu_torch.utils.interop",
                "spblas_tpu_torch.parallel",
                "spblas_tpu_torch.parallel.launch",
                "spblas_tpu_torch.parallel.dryrun"} <= seen, seen
        from spblas_tpu_torch.kernels import plans
        from spblas_tpu_torch.utils import generate as gen
        a = gen.generate_banded_csr(500, 500, 9, seed=0, device="cpu")
        x = gen.generate_vector(500, seed=1, device="cpu")
        y = sp.multiply(sp.scaled(2.0, sp.matrix_opt(a)), x)
        assert y.shape == (500,) and bool(y.isfinite().all())
        # the ROUTE2 rung (native packer, plain kernel version) as well
        plans._on_cuda = lambda t: True
        a = gen.generate_csr(800, 800, 6400, seed=2, device="cpu")
        opt = sp.matrix_opt(a)
        y = sp.multiply(sp.scaled(2.0, opt),
                        gen.generate_vector(800, seed=3, device="cpu"))
        assert opt._plans["matvec"][0] == "route"
        assert y.shape == (800,) and bool(y.isfinite().all())
        # a hub-heavy matrix takes the ROUTE v1 rung
        a = gen.generate_rmat_csr(2048, 2048 * 16, seed=5, device="cpu")
        opt = sp.matrix_opt(a)
        y = sp.multiply(sp.scaled(2.0, opt),
                        gen.generate_vector(2048, seed=4, device="cpu"))
        assert opt._plans["matvec"][0] == "route1"
        assert y.shape == (2048,) and bool(y.isfinite().all())
        # SpMM on a block-dense matrix (the BSR rung) and on a permuted
        # band (the RCM rung, native RCM), and dense·sparse
        import numpy as np
        d = np.zeros((64, 512), np.float32)
        d[8:16, 128:256] = 1.0
        opt = sp.matrix_opt(sp.CSR.from_dense(d, device="cpu"))
        c = sp.multiply(opt, gen.generate_dense(512, 3, seed=6,
                                                device="cpu"))
        assert opt._plans["matmul"][0] == "bsr" and c.shape == (64, 3)
        a = gen.generate_banded_csr(1000, 1000, 9, seed=7, device="cpu")
        p = np.random.default_rng(8).permutation(1000)
        pa = sp.CSR.from_dense(a.todense()[p][:, p], device="cpu")
        opt = sp.matrix_opt(pa)
        c = sp.multiply(gen.generate_dense(2, 1000, seed=9, device="cpu"),
                        opt)
        assert opt.flipped()._plans["matmul"][0] == "band_perm"
        assert c.shape == (2, 1000) and bool(c.isfinite().all())
        # two-phase SpGEMM on the forced resident and paned engines
        # (native expander and packer, plain kernel versions), and the
        # block SpGEMM
        import os
        os.environ["SPBLAS_FORCE_ROUTE_SPGEMM"] = "1"
        a = gen.generate_csr(300, 300, 2400, seed=10, device="cpu")
        for paned in ("0", "1"):
            os.environ["SPBLAS_FORCE_PANED_SPGEMM"] = paned
            info = sp.multiply_compute(a, a)
            assert info.plan.route is not None
            c = sp.multiply_fill(info, sp.scaled(2.0, a), a)
            assert c.nnz == info.result_nnz
            assert bool(c.values.isfinite().all())
        b = sp.BSR.from_dense(d, (8, 128), device="cpu")
        bt = sp.BSR.from_dense(d.T.copy(), (128, 8), device="cpu")
        assert isinstance(sp.multiply(b, bt), sp.BSR)
        # the ROUTE v1 SpGEMM engine, the ROUTE2 triangular solve (native
        # level schedule and packer, plain kernel version) and the band
        # power iterations
        os.environ["SPBLAS_FORCE_PANED_SPGEMM"] = "0"
        os.environ["SPBLAS_ROUTE_SPGEMM"] = "1"
        info = sp.multiply_compute(a, a)
        assert type(info.plan.route).__name__ == "RouteMulPlan"
        c = sp.multiply_fill(info, sp.scaled(2.0, a), a)
        assert bool(c.values.isfinite().all())
        os.environ["SPBLAS_FORCE_ROUTE_TRSV"] = "1"
        L = gen.generate_triangular_csr(500, seed=11, device="cpu")
        info = sp.triangular_solve_inspect(L)
        assert info.plan.route is not None
        x = sp.triangular_solve(sp.scaled(2.0, L),
                                gen.generate_vector(500, seed=12,
                                                    device="cpu"),
                                info=info)
        assert x.shape == (500,) and bool(x.isfinite().all())
        import torch
        from spblas_tpu_torch.kernels import banded
        offs = tuple(range(-3, 4))
        p = banded.band_plan_from_diags(torch.rand(7, 600), offs,
                                        (600, 600))
        y = banded.band_power_iterations(p, torch.ones(600), 3)
        assert y.shape == (600,) and bool(y.isfinite().all())
        # the solvers, the Matrix Market reader (native) and a plan file
        a = gen.generate_banded_csr(400, 400, 9, seed=13, device="cpu")
        r = sp.solvers.cg(sp.matrix_opt(sp.add(a, sp.transpose(a))),
                          torch.ones(400), maxiter=3)
        assert int(r.iterations) == 3
        from spblas_tpu_torch.utils import interop, io, serialize
        a = io.load_matrix_market("data/fem2d_128.mtx.gz", device="cpu")
        assert a.shape == (16384, 16384)
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            plan = banded.build_band_plan(interop.from_scipy(
                interop.to_scipy(L), device="cpu"))
            serialize.save_plan(tmp + "/p.npz", plan)
            back = serialize.load_plan(tmp + "/p.npz", device="cpu")
            assert torch.equal(back.panels, plan.panels)
        # the distribution layer's dry run on a local world of 2 ranks,
        # each of which reports that it imported neither package
        from spblas_tpu_torch.parallel.dryrun import dryrun_multichip
        ranks = dryrun_multichip(2)
        assert [r["no_jax"] for r in ranks] == [True, True], ranks
        assert "jax" not in sys.modules or sys.modules["jax"] is None
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_native_library_is_built_from_the_ports_sources():
    """The packer the port loads is its own build of
    ``spblas_tpu_torch/native/src`` (byte copies of the JAX package's
    sources), named by a hash of those sources and the flags, under the
    port's ``_build/``."""
    import ctypes
    import hashlib
    from pathlib import Path
    from spblas_tpu_torch import native

    src = Path(REPO) / "spblas_tpu_torch" / "native" / "src"
    assert native.SRC == src
    h = hashlib.sha1(" ".join(native.GXX_FLAGS).encode())
    assert native.SOURCES == ("route2_pack.cpp", "route_pack.cpp",
                              "sort_util.cpp", "spblas_host.cpp")
    for name in native.SOURCES:
        body = (src / name).read_bytes()
        assert body == (Path(REPO) / "spblas_tpu" / "native" / "src"
                        / name).read_bytes()
        h.update(body)
    want = (Path(REPO) / "spblas_tpu_torch" / "_build"
            / f"libroute2_host-{h.hexdigest()[:12]}.so")
    lib = native.get_lib()
    assert isinstance(lib, ctypes.CDLL)
    assert native.library_path() == want and Path(lib._name) == want
    assert want.exists()
