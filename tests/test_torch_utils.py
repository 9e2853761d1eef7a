"""spblas_tpu_torch.utils held to spblas_tpu.utils: the cost models give
the JAX package's numbers; the generators it lacked until now give its
arrays bit for bit from the same seed; the scipy and torch.sparse
bridges round-trip; the profiling timers and the inspection phases work
on the CPU; the logging levels filter as JAX's do."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from spblas_tpu.utils import generate as jgen
from spblas_tpu.utils import profiling as jprof

import spblas_tpu_torch as tsp
from spblas_tpu_torch.utils import generate as tgen
from spblas_tpu_torch.utils import interop, logging as tlog
from spblas_tpu_torch.utils import profiling as tprof

from tests.torch_util import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name, args", [
    ("spmv_cost", (1000, 300, 400)),
    ("spmv_cost", (1000, 300, 400, 8, 8)),
    ("dia_spmv_cost", (900, 300, 300, 3)),
    ("spmm_cost", (1000, 300, 400, 64)),
    ("spgemm_cost", (5000, 1000, 1200, 3000))])
def test_costs_equal_jax(name, args):
    got, want = getattr(tprof, name)(*args), getattr(jprof, name)(*args)
    assert (got.flops, got.bytes, got.label) == (want.flops, want.bytes,
                                                 want.label)
    assert got.roofline_seconds(1000.0) == want.roofline_seconds(1000.0)
    assert got.fraction(1e-3, 1000.0) == want.fraction(1e-3, 1000.0)


def _arrays(c):
    for f in ("values", "rowptr", "colptr", "rowind", "colind"):
        if hasattr(c, f):
            yield f, np.asarray(getattr(c, f))


@pytest.mark.parametrize("name, args, kw", [
    ("generate_coo", (30, 40, 200), dict(seed=3)),
    ("generate_coo", (30, 40, 200), dict(seed=3, complex_=True)),
    ("generate_csr_sorted", (30, 40, 200), dict(seed=4)),
    ("generate_csc", (30, 40, 200), dict(seed=5)),
    ("generate_csc_sorted", (30, 40, 200), dict(seed=6)),
    ("generate_gaussian", (30, 40), dict(seed=7)),
    ("generate_powerlaw_cluster_csr", (600,), dict(attach=4, p_tri=0.5,
                                                   seed=8))])
def test_generators_bit_equal(name, args, kw):
    want = getattr(jgen, name)(*args, **kw)
    got = getattr(tgen, name)(*args, **kw, device="cpu")
    if isinstance(got, torch.Tensor):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.float32
        return
    assert got.shape == want.shape and got.nnz == int(want.nnz)
    for (fg, g), (fw, w) in zip(_arrays(got), _arrays(want)):
        assert fg == fw and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_scipy_round_trip():
    a = tgen.generate_csr(50, 40, 300, seed=9, device="cpu")
    s = interop.to_scipy(a)
    assert isinstance(s, sps.csr_matrix) and s.nnz == a.nnz
    np.testing.assert_array_equal(s.toarray(), a.todense().numpy())
    b = interop.from_scipy(sps.coo_matrix(s), capacity=512, device="cpu")
    assert b.capacity == 512
    np.testing.assert_array_equal(b.todense().numpy(), s.toarray())


@pytest.mark.parametrize("layout", [torch.sparse_coo, torch.sparse_csr],
                         ids=["coo", "csr"])
def test_torch_sparse_round_trip(layout):
    a = tgen.generate_csr(50, 40, 300, seed=10, device="cpu")
    t = interop.to_torch_sparse(a, layout=layout)
    assert t.layout == layout and t.device == a.values.device
    np.testing.assert_array_equal(t.to_dense().numpy(), a.todense().numpy())
    b = interop.from_torch_sparse(t)
    np.testing.assert_array_equal(b.todense().numpy(), a.todense().numpy())
    # rows come back sorted by column, as JAX's from_bcoo sorts them
    nnz = b.nnz
    rp = b.rowptr.numpy()
    cols = b.colind.numpy()[:nnz]
    for i in range(b.shape[0]):
        assert (np.diff(cols[rp[i]:rp[i + 1]]) > 0).all()
    # an uncoalesced COO tensor keeps its duplicates as two entries
    idx = torch.tensor([[0, 0, 1], [2, 2, 0]])
    dup = torch.sparse_coo_tensor(idx, torch.tensor([1.0, 2.0, 3.0]),
                                  (2, 3))
    c = interop.from_torch_sparse(dup)
    assert c.nnz == 3
    np.testing.assert_array_equal(c.todense().numpy(),
                                  [[0, 0, 3], [3, 0, 0]])


def test_profiling_timers_and_phases_on_the_cpu(monkeypatch):
    x = torch.ones(1000)
    t = tprof.time_chained(lambda v: v * 1.0001, x, iters=5, reps=2)
    assert 0 < t < 1
    assert 0 < tprof.time_fn(torch.add, x, x, reps=2) < 1
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        tprof.device_hbm_gbps()          # no card here
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert tprof.device_hbm_gbps() == 3350.0
    assert tprof.spmv_cost(10, 4, 4).roofline_seconds() == \
        tprof.spmv_cost(10, 4, 4).bytes / 3.35e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 PCIe")
    assert tprof.device_hbm_gbps() == 2000.0
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="A100"):
        tprof.device_hbm_gbps()
    # the inspection phases of SpTRSV and of the SpGEMM engine build
    L = tgen.generate_triangular_csr(300, seed=1, device="cpu")
    tsp.triangular_solve_inspect(L)
    assert set(tprof.inspect_phases("trsv_inspect")) == {
        "pull_s", "schedule_s", "ragged_pack_s"}
    monkeypatch.setenv("SPBLAS_FORCE_ROUTE_SPGEMM", "1")
    a = tgen.generate_csr(200, 200, 1600, seed=2, device="cpu")
    tsp.multiply_compute(a, a)
    assert {"expansion_s", "pack_s", "build_s"} <= set(
        tprof.inspect_phases("spgemm_engine"))


def test_logging_levels(capsys):
    saved = tlog._level
    try:
        tlog.set_level("info")
        tlog.log_warning("w")
        tlog.log_info("i")
        tlog.log_trace("t")
        tlog.log_debug("d")
        err = capsys.readouterr().err
        assert "[WARNING] spblas_tpu_torch: w" in err
        assert "[INFO] spblas_tpu_torch: i" in err
        assert "TRACE" not in err and "DEBUG" not in err
        tlog.set_level("DEBUG")
        tlog.log_debug("d")
        assert "[DEBUG] spblas_tpu_torch: d" in capsys.readouterr().err
        tlog.set_level("none")
        tlog.log_warning("w")
        assert capsys.readouterr().err == ""
        with pytest.raises(KeyError):
            tlog.set_level("verbose")
    finally:
        tlog._level = saved
