"""Regenerate the checked-in benchmark matrices under data/ with the
PyTorch port, no JAX imported: the port's copy of scripts/make_data.py.

The same five recipes and seeds (the port's generators give the JAX
package's arrays bit for bit), written by the port's Matrix Market writer
and gzipped.  Only missing files are written — delete one to regenerate
it.  Everything runs on the CPU.

    python scripts/make_data_torch.py                      # into data/
    python scripts/make_data_torch.py --out DIR fem2d_128  # some, elsewhere
"""

import argparse
import gzip
import os
import shutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from spblas_tpu_torch.utils import generate as gen
from spblas_tpu_torch.utils.io import save_matrix_market

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "data")

RECIPES = {
    # mesh family (FEM triangulation graphs + 3D stencil) — seeds must
    # match tests/test_data_matrices.py, which asserts file == generator
    "fem2d_128": lambda: gen.generate_fem_graph_csr(128, 128, seed=9,
                                                    device="cpu"),
    "fem2d_512": lambda: gen.generate_fem_graph_csr(512, 512, seed=7,
                                                    device="cpu"),
    "stencil3d_32": lambda: gen.generate_stencil_csr((32, 32, 32),
                                                     device="cpu"),
    # power-law web-graph stand-in
    "rmat_32k": lambda: gen.generate_rmat_csr(32_768, 32_768 * 16, seed=5,
                                              device="cpu"),
    # scale-free + clustered (Holme-Kim): non-mesh, non-RMAT structure
    "powerlaw_64k": lambda: gen.generate_powerlaw_cluster_csr(
        65_536, attach=8, p_tri=0.5, seed=7, device="cpu"),
}


def write_missing(out_dir=DATA, names=None) -> list:
    """Write ``<out_dir>/<name>.mtx.gz`` for each recipe in ``names``
    (default: all) whose file is missing; returns the paths written."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for name in names or RECIPES:
        out = os.path.join(out_dir, name + ".mtx.gz")
        if os.path.exists(out):
            print(f"{name}: exists, skipping")
            continue
        a = RECIPES[name]()
        tmp = out[:-3]
        save_matrix_market(tmp, a)
        with open(tmp, "rb") as src, gzip.open(out, "wb") as dst:
            shutil.copyfileobj(src, dst)
        os.unlink(tmp)
        print(f"{name}: wrote {out} ({a.nnz} nnz)")
        written.append(out)
    return written


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("names", nargs="*",
                        help=f"recipes to write (default: all of "
                             f"{', '.join(RECIPES)})")
    parser.add_argument("--out", default=DATA,
                        help="directory of the files (default: data/)")
    args = parser.parse_args()
    unknown = set(args.names) - set(RECIPES)
    if unknown:
        parser.error(f"no recipe {sorted(unknown)}")
    write_missing(args.out, args.names)


if __name__ == "__main__":
    main()
