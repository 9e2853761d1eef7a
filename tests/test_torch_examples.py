"""The port's examples (``examples/torch/``) on the CPU, each held to its
dense oracle and closing line, and to its JAX twin (``examples/*.py``).

Every port example runs with ``--device cpu``: the twelve single-process
ones in this process through ``runpy`` (``sys.argv``, ``sys.path`` and
``os.environ`` put back after each, since a script may set
``SPBLAS_FORCE_*``), the two distributed ones as subprocesses on a gloo
world of 2 CPU ranks.  Without ``--device`` each raises where no card
is.  One subprocess runs all fourteen with ``jax`` and ``spblas_tpu``
unimportable, which proves they import neither.

Twin comparison: each single-process twin that runs in about 10 s in
one process on an 8-core CPU is run the same way, and the port's final
arrays (the globals both scripts leave) are held to the twin's at the
port's row tolerance, |y - y_twin|_i <= 64 * eps_f32 * |scale| *
(|A| . |x|)_i, per entry for matrix results (``tests/torch_util.py``).  A solve's x is held
in product form (A x against A x_twin, per row, with |A| . |x_twin|),
since the two substitutions sum in different orders.  The eigenvalue of
``iterative_solvers`` is the one exception: the two power methods start
from different v0 (JAX's PRNG key has no torch twin), and each script
holds its own within 1e-2 of the float64 eigenvalue, so the two are held
within 2e-2 of each other, not at 64 eps.

Twins not run, with their wall time in one process on an 8-core CPU
(JAX already imported, 8 faked devices): ``unstructured_tour`` 20.3 s
(its ROUTE kernels in Pallas interpret mode), and the distributed twins
``distributed_spmv`` (not done after 200 s: its ``prefer="route"``
section interprets the ROUTE2 kernel on every shard) and
``distributed_ops`` (43.0 s), whose operations
``test_torch_parallel.py`` and ``test_torch_dist_spgemm.py`` hold to
JAX.  The slowest twin that runs is ``complex_ops``, 6.9 s.
"""

import contextlib
import io
import os
import runpy
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tests.torch_util import (EPS32, abs_dot, abs_matmul,  # noqa: F401
                              one_torch_thread, to_np)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "examples", "torch")
TWINS = os.path.join(REPO, "examples")

# example -> closing line
SINGLE = {
    "simple_spmv": "ok", "spmm": "ok", "matrix_opt_example": "ok",
    "simple_spgemm": "ok", "spgemm_reuse": "ok", "simple_sptrsv": "ok",
    "iterative_solvers": "ok", "mesh_matrices": "mesh_matrices example ok",
    "bsr_blocks": "ok", "real_matrix_io": "ok", "unstructured_tour": "ok",
    "complex_ops": "complex_ops: all oracles passed",
}
DIST = {"distributed_spmv": "ok", "distributed_ops": "dist spgemm engine ok"}
DIST_RANKS = 2
DIST_LIMIT = 300


def one_thread_env():
    """The environment of a subprocess: one torch thread a process, as
    the suite's workers run (several at once)."""
    return dict(os.environ, OMP_NUM_THREADS="1")


def test_every_twin_has_a_port_example():
    twins = {f for f in os.listdir(TWINS) if f.endswith(".py")}
    port = {f for f in os.listdir(PORT) if f.endswith(".py")}
    assert port == twins == {f"{n}.py" for n in (*SINGLE, *DIST)}


@pytest.fixture
def script_env(monkeypatch):
    """``sys.path`` and ``os.environ`` as they were, after the test."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    saved = dict(os.environ)
    yield monkeypatch
    os.environ.clear()
    os.environ.update(saved)


def run_script(monkeypatch, path, *argv):
    """``python path argv`` in this process: (its globals, its stdout
    lines)."""
    monkeypatch.setattr(sys, "argv", [path, *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        g = runpy.run_path(path, run_name="__main__")
    return g, buf.getvalue().splitlines()


# ------------------------------------------------------------------ #
# the comparisons with the twins
# ------------------------------------------------------------------ #

def _dense(v):
    """A result or operand as a numpy array: tensors, JAX arrays and
    either package's containers (densified)."""
    if hasattr(v, "todense"):
        v = v.todense()
    return to_np(v)


def _rows(name, a="a", x="x", scale=1.0):
    """y = scale * A x, per row (per entry for a matrix X); A a JAX CSR
    (its live entries) or any container or array (densified)."""
    def check(port, twin):
        ta, tx = twin[a], _dense(twin[x])
        if hasattr(ta, "rowptr"):
            bound = abs_matmul(ta, tx) if tx.ndim == 2 else abs_dot(ta, tx)
        else:
            bound = (np.abs(_dense(ta)).astype(np.float64)
                     @ np.abs(tx).astype(np.float64))
        _close(port[name], twin[name], abs(scale) * bound, name)
    return check


def _solve(name, a, get=None):
    """A solve's x (``get`` of the globals, default the global ``name``)
    in product form: A x against A x_twin."""
    get = get or (lambda g: g[name])

    def check(port, twin):
        dense = _dense(twin[a]).astype(np.float64)
        x, xt = (_dense(get(g)).astype(np.float64) for g in (port, twin))
        _close(dense @ x, dense @ xt, np.abs(dense) @ np.abs(xt), name)
    return check


def _close(got, want, absdot, what):
    got = _dense(got).astype(np.complex128)
    want = _dense(want).astype(np.complex128)
    assert got.shape == want.shape, f"{what}: {got.shape} vs {want.shape}"
    bound = 64 * EPS32 * absdot
    err = np.abs(got - want)
    bad = err > bound
    worst = np.unravel_index(int(np.argmax(err - bound)), err.shape)
    assert not bad.any(), (f"{what}: {bad.sum()} out of bound; worst "
                           f"{worst}: err {err[worst]}, bound {bound[worst]}")


def _fused(port, twin):
    """c4 = 2 A B + 3 D, per entry of (2 |A| |B| + 3 |D|)."""
    bound = (2 * abs_matmul(twin["a"], _dense(twin["b"]))
             + 3 * np.abs(_dense(twin["d"])))
    _close(port["c4"], twin["c4"], bound, "c4")


def _eigenvalue(port, twin):
    # different v0 (module docstring): each within 1e-2 of float64's
    assert abs(float(port["eig"].eigenvalue)
               - float(twin["eig"].eigenvalue)) < 2e-2


CHECKS = {
    "simple_spmv": [_rows("y", scale=2.0)],
    "spmm": [_rows("c", "a_csr", "b"), _rows("c2", "a_csc", "b")],
    "matrix_opt_example": [_rows("y1"), _rows("y2")],
    "simple_spgemm": [_rows("c", "a", "b")],
    # the last numeric of the reuse loop, C = A_new B, and the fused form
    "spgemm_reuse": [_rows("c", "a_new", "b"), _fused],
    "simple_sptrsv": [_solve("x", "L"), _solve("x2", "L")],
    "iterative_solvers": [_solve("res.x", "dense", lambda g: g["res"].x),
                          _eigenvalue, _solve("x_j", "dense")],
    "mesh_matrices": [_rows("y"), _rows("y2"), _rows("y3", "a3", "x3"),
                      _rows("yf", "af", "xf"), _rows("C", "af", "B")],
    "bsr_blocks": [_rows("y", "da"), _rows("c", "da", "b"),
                   _rows("c1", "da", "db")],
    "real_matrix_io": [_rows("y")],
    "complex_ops": [_rows("y", "ac"), _rows("yb", "ab"),
                    _rows("y2", "ac", scale=2.0), _rows("c", "bc", "bc")],
}


@pytest.mark.parametrize("name", [*SINGLE, *DIST])
def test_example_runs_on_the_cpu(name, script_env):
    """The port example passes its dense oracle with ``--device cpu`` and
    prints its closing line; a single-process one whose twin runs here
    agrees with the twin."""
    path = os.path.join(PORT, f"{name}.py")
    if name in DIST:
        out = subprocess.run(
            [sys.executable, path, "--device", "cpu", "--ranks",
             str(DIST_RANKS)], cwd=REPO, env=one_thread_env(),
            capture_output=True, text=True, timeout=DIST_LIMIT)
        assert out.returncode == 0, out.stderr[-4000:]
        assert out.stdout.splitlines()[-1] == DIST[name], out.stdout
        return
    port, lines = run_script(script_env, path, "--device", "cpu")
    assert lines[-1] == SINGLE[name], lines
    if name not in CHECKS:
        return
    twin, tlines = run_script(script_env, os.path.join(TWINS, f"{name}.py"))
    assert tlines[-1] == SINGLE[name], tlines
    for check in CHECKS[name]:
        check(port, twin)


def test_distributed_example_as_a_torchrun_rank():
    """Under torchrun's environment (``LOCAL_RANK`` set) a distributed
    example runs its tour as that one rank of torchrun's world, here a
    world of one CPU rank (``launch.run_tour``)."""
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    env = dict(one_thread_env(), LOCAL_RANK="0", RANK="0", WORLD_SIZE="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    out = subprocess.run(
        [sys.executable, os.path.join(PORT, "distributed_spmv.py"),
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=DIST_LIMIT)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    assert "size=1" in lines[0] and "backend='gloo'" in lines[0], lines
    assert lines[-1] == DIST["distributed_spmv"], lines


@pytest.mark.parametrize("name", [*SINGLE, *DIST])
def test_example_raises_without_a_card(name, script_env):
    """With no ``--device`` an example goes to the card, and where there
    is none it raises rather than carry on on the CPU."""
    script_env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_script(script_env, os.path.join(PORT, f"{name}.py"))


def test_examples_import_neither_jax_nor_spblas_tpu():
    """Every port example passes with ``jax`` and ``spblas_tpu`` made
    unimportable (the distributed ones on 2 gloo CPU ranks)."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["spblas_tpu"] = None
        import os, runpy
        for name in {[*SINGLE, *DIST]!r}:
            path = os.path.join({PORT!r}, name + ".py")
            sys.argv = [path, "--device", "cpu"]
            if name in {list(DIST)!r}:
                sys.argv += ["--ranks", "{DIST_RANKS}"]
            print("== " + name, flush=True)
            runpy.run_path(path, run_name="__main__")
            sys.stdout.flush()
        assert sys.modules["jax"] is None and sys.modules["spblas_tpu"] is None
        print("== end")
    """)
    out = subprocess.run([sys.executable, "-u", "-c", code], cwd=REPO,
                         env=one_thread_env(), capture_output=True,
                         text=True, timeout=DIST_LIMIT)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    marks = [i for i, ln in enumerate(lines) if ln.startswith("== ")]
    assert [lines[i][3:] for i in marks] == [*SINGLE, *DIST, "end"], lines
    for i, j in zip(marks, marks[1:]):
        name = lines[i][3:]
        assert lines[j - 1] == {**SINGLE, **DIST}[name], (name,
                                                          lines[i:j])
