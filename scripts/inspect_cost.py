#!/usr/bin/env python3
"""Time the host-side parts of spblas_tpu_torch's structured-plan
inspection on general square matrices (the rungs that run before the
ROUTE rung on CUDA): the band half-width, the BSR block count
(``plans._try_bsr``), the DIA fill (``dia.dia_fill_fraction``), the copy
of rowptr and colind to the host, the native RCM, and the whole
``plans._structured_plan``.  The matrices live on the card, as on the
main path.

    python3 scripts/inspect_cost.py

Needs one CUDA device; prints one line per matrix.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from spblas_tpu_torch import native  # noqa: E402
from spblas_tpu_torch import types as _t  # noqa: E402
from spblas_tpu_torch.kernels import banded, dia, plans  # noqa: E402
from spblas_tpu_torch.utils import generate as gen  # noqa: E402

# the bench's uniform degree-10 matrices (bench.py:145, :606, seed 3)
MATRICES = (("uniform_300k", 300_000, 3_000_000),
            ("uniform_4m", 4_000_000, 40_000_000))


def main():
    if not torch.cuda.is_available():
        print("inspect_cost: no CUDA device", file=sys.stderr)
        return 2
    native.get_lib()
    for name, m, nnz in MATRICES:
        a = gen.generate_csr(m, m, nnz, seed=3)
        torch.cuda.synchronize()
        out = {}

        def timed(key, fn):
            t0 = time.perf_counter()
            r = fn()
            out[key] = round(time.perf_counter() - t0, 3)
            return r

        h = timed("band_halfwidth", lambda: banded.band_halfwidth(a))
        timed("try_bsr", lambda: plans._try_bsr(a))
        timed("dia_fill_fraction", lambda: dia.dia_fill_fraction(a))
        rp, ci = timed("host_copies", lambda: (
            _t.to_numpy(a.rowptr).astype(np.int64), _t.to_numpy(a.colind)))
        timed("native_rcm", lambda: native.rcm(m, a.nnz, rp, ci))
        timed("structured_plan_total",
              lambda: plans._structured_plan(a, m, m, h))
        print(name, out, flush=True)
        del a
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
