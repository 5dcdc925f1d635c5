"""Structured-matrix corpus sweep for the sparse auto-import heuristics.

The reference ships five .mtx matrices and sweeps solver configs over them
(EXAMPLES/MATRIX_MARKET/arpackmm.sh); SuiteSparse-style variety is left to
users.  This corpus generates the structure classes that matter for the
import policy (dense / DIA / RCM+DIA / gather-ELL / HYB) and checks, for
each: (a) the auto-chosen structure is the expected one, (b) converged
eigenpairs pass the independent scipy-matvec residual oracle
(arpackSolver.hpp:297-323 strategy).
"""
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # sweep tier: run with -m slow (or -m "")
import scipy.sparse as sp

import arpack_ng_tpu as at
from arpack_ng_tpu.ops import sparse as ops_sparse


def _residuals(a, vals, vecs):
    return [
        np.linalg.norm(a @ vecs[:, i] - vals[i] * vecs[:, i])
        / max(abs(vals[i]), 1.0)
        for i in range(len(vals))
    ]


def _laplacian_3d(nx):
    t = sp.diags([-np.ones(nx - 1), 2 * np.ones(nx), -np.ones(nx - 1)],
                 [-1, 0, 1])
    eye = sp.identity(nx)
    return (sp.kron(sp.kron(eye, eye), t) + sp.kron(sp.kron(eye, t), eye)
            + sp.kron(sp.kron(t, eye), eye)).tocsr()


class TestCorpus:
    def test_banded_symmetric_sweep(self, rng):
        """Random symmetric banded matrices at several bandwidths -> DIA."""
        n = 4000
        for bw in (1, 5, 30):
            rows = rng.standard_normal((bw, n))
            a = sp.diags([rows[i][: n - (i + 1)] for i in range(bw)],
                         [i + 1 for i in range(bw)], shape=(n, n))
            a = (a + a.T + sp.diags(4.0 * bw + rng.standard_normal(n))).tocsr()
            op = ops_sparse.from_scipy(a, hermitian=True)
            assert op.perm is None  # already banded: no RCM needed
            vals, vecs = at.eigsh(op, k=4, which="LA", tol=1e-10)
            assert max(_residuals(a, vals, vecs)) < 1e-8

    def test_laplacian_3d_natural(self):
        """3-D 7-point Laplacian: 7 structural diagonals -> direct DIA."""
        a = _laplacian_3d(16)  # n = 4096
        op = ops_sparse.from_scipy(a, hermitian=True)
        assert op.perm is None
        vals, vecs = at.eigsh(op, k=4, which="SA", tol=1e-10, maxiter=2000)
        assert max(_residuals(a, vals, vecs)) < 1e-8
        ref = [2 * 3 * (1 - np.cos(np.pi * k / 17)) for k in (1,)]
        assert abs(vals[0] - 3 * 2 * (1 - np.cos(np.pi / 17))) < 1e-8

    def test_permuted_mesh_recovers_banding(self, rng):
        """Randomly permuted 2-D mesh: scattered diagonals, but RCM must
        recover a banded form -> DIA on the permuted problem, with the
        permutation unwound on extraction (values/vectors in user order)."""
        from arpack_ng_tpu import models
        _, a = models.laplacian_2d(60, dtype=np.float64)  # n = 3600
        p = rng.permutation(a.shape[0])
        P = sp.identity(a.shape[0], format="csr")[p]
        ash = (P @ a @ P.T).tocsr()
        op = ops_sparse.from_scipy(ash, hermitian=True)
        assert op.perm is not None  # RCM engaged
        vals, vecs = at.eigsh(op, k=4, which="LA", tol=1e-10)
        assert max(_residuals(ash, vals, vecs)) < 1e-8

    def test_random_graph_falls_back_to_ell(self, rng):
        """Erdos-Renyi graph Laplacian: no diagonal structure even after
        RCM -> gather-ELL fallback; results still correct."""
        n = 2500
        density = 0.004
        g = sp.random(n, n, density=density, random_state=42,
                      data_rvs=lambda k: np.ones(k))
        adj = ((g + g.T) > 0).astype(np.float64)
        deg = np.asarray(adj.sum(axis=1)).ravel()
        a = (sp.diags(deg) - adj).tocsr()
        op = ops_sparse.from_scipy(a, hermitian=True)
        vals, vecs = at.eigsh(op, k=3, which="LA", tol=1e-8, maxiter=2000)
        assert max(_residuals(a, vals, vecs)) < 1e-6

    def test_block_tridiagonal(self, rng):
        """Block-tridiagonal (bandwidth = 2*block) -> DIA."""
        nb, b = 120, 6
        n = nb * b
        diag = rng.standard_normal((nb, b, b))
        off = rng.standard_normal((nb - 1, b, b))
        a = sp.lil_matrix((n, n))
        for i in range(nb):
            blk = diag[i] + diag[i].T + 8 * b * np.eye(b)
            a[i * b:(i + 1) * b, i * b:(i + 1) * b] = blk
            if i < nb - 1:
                a[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = off[i]
                a[(i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] = off[i].T
        a = a.tocsr()
        op = ops_sparse.from_scipy(a, hermitian=True)
        assert op.perm is None
        vals, vecs = at.eigsh(op, k=3, which="LA", tol=1e-10)
        assert max(_residuals(a, vals, vecs)) < 1e-8

    def test_complex_hermitian_banded(self, rng):
        n = 3000
        d1 = rng.standard_normal(n - 1) + 1j * rng.standard_normal(n - 1)
        a = (sp.diags(d1, 1) + sp.diags(d1.conj(), -1)
             + sp.diags(4.0 + rng.standard_normal(n))).tocsr()
        op = ops_sparse.from_scipy(a, hermitian=True)
        vals, vecs = at.eigsh(op, k=3, which="LA", tol=1e-10)
        assert np.max(np.abs(vals.imag)) < 1e-12
        assert max(_residuals(a, vals, vecs)) < 1e-8

    def test_nonsymmetric_directed_banded(self, rng):
        """Non-symmetric banded (convection-like): DIA + eigs driver."""
        n = 3000
        a = (sp.diags(2.0 + rng.standard_normal(n))
             + sp.diags(-1.5 * np.ones(n - 1), 1)
             + sp.diags(-0.5 * np.ones(n - 1), -1)
             + sp.diags(0.1 * rng.standard_normal(n - 2), 2)).tocsr()
        op = ops_sparse.from_scipy(a, hermitian=False)
        assert op.perm is None
        vals, vecs = at.eigs(op, k=3, which="LM", tol=1e-10, ncv=40,
                             maxiter=2000)
        for i in range(3):
            r = np.linalg.norm(a @ vecs[:, i] - vals[i] * vecs[:, i])
            assert r < 1e-7 * abs(vals[i])

    def test_mtx_roundtrip_solve(self, tmp_path, rng):
        """MatrixMarket write/read -> auto import -> solve (the arpackmm
        file-driven flow on a corpus matrix)."""
        from arpack_ng_tpu.io import matrix_market as mm
        n = 2600
        d1 = rng.standard_normal(n - 1)
        a = (sp.diags(d1, 1) + sp.diags(d1, -1)
             + sp.diags(6.0 + rng.standard_normal(n))).tocsr()
        f = tmp_path / "corpus.mtx"
        mm.write_matrix(str(f), a)
        a2 = mm.read_matrix(str(f))
        op = ops_sparse.from_scipy(a2.tocsr(), hermitian=True)
        vals, vecs = at.eigsh(op, k=3, which="LA", tol=1e-10)
        assert max(_residuals(a, vals, vecs)) < 1e-8


class TestIrregularCorpus:
    """SuiteSparse-class irregular structures (round-3 verdict #5):
    generated FEM / power-law / saddle-point matrices through
    from_scipy(format='auto'), asserting the chosen execution structure
    per class + the independent residual oracle.  Full-scale (n >= 1e5)
    on-chip throughput per class lives in benchmarks/bench_corpus.py."""

    def test_fem_triangulation_routes_ell(self):
        from arpack_ng_tpu.models import corpus
        a = corpus.fem_triangulation(12000)
        op = ops_sparse.from_scipy(a, hermitian=True)
        # unstructured mesh: RCM still leaves >192 diagonals, bounded
        # row degrees -> plain gather-ELL
        assert op.format == "ell"
        vals, vecs = at.eigsh(op, k=3, which="LA", tol=1e-8, ncv=32,
                              maxiter=3000)
        assert max(_residuals(a, vals, vecs)) < 1e-7

    def test_powerlaw_routes_hybrid(self):
        from arpack_ng_tpu.models import corpus
        a = corpus.powerlaw_graph(12000)
        deg = np.diff(a.indptr)
        assert deg.max() > 3 * np.percentile(deg, 95)  # genuine hubs
        op = ops_sparse.from_scipy(a, hermitian=True)
        # hub rows must NOT pad every row to the hub degree
        assert op.format == "hyb"
        vals, vecs = at.eigsh(op, k=3, which="LA", tol=1e-8, ncv=32,
                              maxiter=3000)
        assert max(_residuals(a, vals, vecs)) < 1e-7

    def test_saddle_point_routes_dia(self):
        from arpack_ng_tpu.models import corpus
        a = corpus.saddle_point(70)  # n = 9800, indefinite KKT
        op = ops_sparse.from_scipy(a, hermitian=True)
        assert op.format == "dia"
        vals, vecs = at.eigsh(op, k=3, which="LM", tol=1e-8, ncv=32,
                              maxiter=3000)
        assert max(_residuals(a, vals, vecs)) < 1e-7
        # indefinite: the small end is negative (LM must straddle zero
        # magnitudes correctly)
        vals_sa = at.eigsh(op, k=2, which="SA", tol=1e-6, ncv=32,
                           maxiter=4000, return_eigenvectors=False)
        assert vals_sa.min() < 0

    def test_hyb_matvec_matches_scipy(self, rng):
        """The hybrid split itself (ELL body + COO tail) is exact."""
        from arpack_ng_tpu.models import corpus
        import jax.numpy as jnp
        a = corpus.powerlaw_graph(5000, seed=3)
        op = ops_sparse.from_scipy(a, hermitian=True, format="hyb")
        x = rng.standard_normal(a.shape[0])
        xp = np.zeros(op.n_pad)
        xp[:op.n] = x
        y = np.asarray(op.a_apply(jnp.asarray(xp)))[:op.n]
        np.testing.assert_allclose(y, a @ x, rtol=1e-12, atol=1e-12)
