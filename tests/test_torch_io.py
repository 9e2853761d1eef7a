"""spblas_tpu_torch.utils.io held to spblas_tpu.utils.io: the five
checked-in Matrix Market files (data/*.mtx.gz) load bit-equal to the JAX
package's loader and to the port's own generators (the files are their
exports), and ``save_matrix_market`` round-trips real and complex
containers bit for bit (values written with 17 significant digits)."""

import importlib.util
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from spblas_tpu.utils.io import load_matrix_market as jax_load

import spblas_tpu_torch as tsp
from spblas_tpu_torch import native
from spblas_tpu_torch.utils import generate as tgen
from spblas_tpu_torch.utils import io

from tests.torch_util import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")
GENERATORS = {
    "fem2d_128": lambda: tgen.generate_fem_graph_csr(128, 128, seed=9,
                                                     device="cpu"),
    "stencil3d_32": lambda: tgen.generate_stencil_csr((32, 32, 32),
                                                      device="cpu"),
    "rmat_32k": lambda: tgen.generate_rmat_csr(32768, 32768 * 16, seed=5,
                                               device="cpu"),
    "fem2d_512": lambda: tgen.generate_fem_graph_csr(512, 512, seed=7,
                                                     device="cpu"),
    "powerlaw_64k": lambda: tgen.generate_powerlaw_cluster_csr(
        65_536, attach=8, p_tri=0.5, seed=7, device="cpu"),
}


def _live(a):
    m = a.shape[0]
    nnz = int(a.nnz)
    return (np.asarray(a.rowptr)[: m + 1], np.asarray(a.colind)[:nnz],
            np.asarray(a.values)[:nnz])


@pytest.mark.parametrize("name", list(GENERATORS))
def test_data_file_loads_as_jax_and_as_its_generator(name):
    path = os.path.join(DATA, name + ".mtx.gz")
    got = io.load_matrix_market(path, device="cpu")
    want = jax_load(path)
    assert got.shape == want.shape and got.nnz == int(want.nnz)
    for g, w in zip(_live(got), _live(want)):
        np.testing.assert_array_equal(g, w)
    assert got.values.dtype == torch.float32
    gen = GENERATORS[name]()
    assert gen.nnz == got.nnz
    np.testing.assert_array_equal(_live(gen)[0], _live(got)[0])
    np.testing.assert_array_equal(_live(gen)[1], _live(got)[1])
    np.testing.assert_allclose(_live(gen)[2], _live(got)[2], rtol=1e-6)


def test_save_matrix_market_round_trips(tmp_path):
    a = tgen.generate_csr(40, 30, 200, seed=1, device="cpu")
    p = str(tmp_path / "a.mtx")
    io.save_matrix_market(p, a)
    b = io.load_matrix_market(p, device="cpu")
    np.testing.assert_array_equal(a.todense().numpy(), b.todense().numpy())
    # complex values take the complex field, parsed outside the native
    # reader (which is real-only)
    c = tgen.generate_csr(20, 25, 90, seed=2, complex_=True, device="cpu")
    pc = str(tmp_path / "c.mtx")
    io.save_matrix_market(pc, c)
    with pytest.raises(ValueError, match="complex"):
        native.mm_read(pc)
    d = io.load_matrix_market(pc, device="cpu")
    assert d.values.dtype == torch.complex64
    np.testing.assert_array_equal(c.todense().numpy(), d.todense().numpy())


def test_symmetric_storage_expands_and_duplicates_sum(tmp_path):
    p = str(tmp_path / "s.mtx")
    with open(p, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real symmetric\n"
                "% a comment\n3 3 4\n1 1 2.0\n2 1 -1.5\n3 2 4.0\n"
                "2 1 0.5\n")
    a = io.load_matrix_market(p, device="cpu")
    want = np.array([[2.0, -1.0, 0.0], [-1.0, 0.0, 4.0], [0.0, 4.0, 0.0]])
    np.testing.assert_array_equal(a.todense().numpy(), want)
    np.testing.assert_array_equal(np.asarray(a.todense()),
                                  np.asarray(jax_load(p).todense()))
    # the loaded file through the chooser, as any other matrix
    y = tsp.multiply(tsp.matrix_opt(a), torch.ones(3))
    np.testing.assert_allclose(y.numpy(), want.sum(1))


@pytest.mark.parametrize("name", ["fem2d_128", "stencil3d_32"])
def test_make_data_torch_regenerates_the_data_file(name, tmp_path):
    """``scripts/make_data_torch.py`` (the port's recipes, no JAX) writes
    a file that loads bit-equal to the checked-in one, and skips a file
    that exists."""
    spec = importlib.util.spec_from_file_location(
        "make_data_torch", os.path.join(os.path.dirname(DATA), "scripts",
                                        "make_data_torch.py"))
    make = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make)
    out = str(tmp_path / f"{name}.mtx.gz")
    assert make.write_missing(str(tmp_path), [name]) == [out]
    assert make.write_missing(str(tmp_path), [name]) == []
    got = io.load_matrix_market(out, device="cpu")
    want = io.load_matrix_market(os.path.join(DATA, name + ".mtx.gz"),
                                 device="cpu")
    assert got.shape == want.shape and got.nnz == want.nnz
    for g, w in zip(_live(got), _live(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_make_data_torch_imports_no_jax(tmp_path):
    """The script writes a file with ``jax`` and ``spblas_tpu`` made
    unimportable."""
    script = os.path.join(os.path.dirname(DATA), "scripts",
                          "make_data_torch.py")
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["spblas_tpu"] = None
        import runpy
        sys.argv = [{script!r}, "--out", {str(tmp_path)!r}, "fem2d_128"]
        runpy.run_path({script!r}, run_name="__main__")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         env=dict(os.environ, OMP_NUM_THREADS="1"),
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "fem2d_128.mtx.gz").exists()
