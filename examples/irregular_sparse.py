"""Irregular-sparsity eigensolve through ``from_scipy(format='auto')``:
a FEM-class matrix with no usable diagonal structure goes to the gather
formats (ELL/HYB); the panel-tiled one-hot PSELL form (ops/psell.py) is
pure XLA and can be requested explicitly with ``format='psell'``.

The reference analog is a user feeding an arbitrary CSR matrix through
the ido loop (TESTS/dnsimp.f:192-194) or
arpackSolver's Eigen SpMV (EXAMPLES/MATRIX_MARKET/arpackSolver.hpp:233).

Run:  python examples/irregular_sparse.py [n]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import scipy.sparse.linalg as sla

import arpack_ng_tpu as at
from arpack_ng_tpu.models import corpus
from arpack_ng_tpu.ops.sparse import from_scipy


def main(n=20_000):
    a = corpus.fem_triangulation(n).tocsr()
    a = ((a + a.T) * 0.5).tocsr()
    # explicit 'psell' so the example exercises the path on any backend
    op = from_scipy(a.astype(np.float32), hermitian=True,
                    format="psell")
    print(f"n = {a.shape[0]}, nnz = {a.nnz}, format = {op.format}")
    vals, vecs = at.eigsh(op, k=4, which="LA", ncv=20, tol=1e-4,
                          maxiter=2000)
    ref = sla.eigsh(a.astype(np.float64), k=4, which="LA", tol=1e-8,
                    return_eigenvectors=False)
    print(f"values:    {np.round(np.sort(vals), 5)}")
    print(f"reference: {np.round(np.sort(ref), 5)}")
    err = np.max(np.abs(np.sort(vals) - np.sort(ref))
                 / np.abs(np.sort(ref)))
    res = max(np.linalg.norm(a @ vecs[:, i] - vals[i] * vecs[:, i])
              / abs(vals[i]) for i in range(4))
    print(f"max value relerr {err:.1e}, max residual {res:.1e}")
    assert err < 1e-3 and res < 1e-3
    print("OK")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 20_000)
