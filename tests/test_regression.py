"""Regression behaviors ported from the reference's TESTS/ tier
(SURVEY §4: bug_142 restart-in-range-of-OP, user-shift protocol, BE
parity, mode-3/4 complex shifts in real arithmetic, stats/debug
subsystems, sweep-style CLI coverage)."""
import io
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as sla

import arpack_ng_tpu as at
from arpack_ng_tpu import models
from arpack_ng_tpu.config import IRAMConfig
from arpack_ng_tpu.core.iram import IRAMSolver
from arpack_ng_tpu.core.extract import extract
from arpack_ng_tpu.utils.stats import Timers

from conftest import residual


class TestBug142RestartInRangeOfOp:
    """bug_142/bug_142_gen: restart vectors must lie in the range of OP
    (TESTS/bug_142.f:3-9); dgetv0 forces this by applying OP to every
    fresh random start (SRC/dgetv0.f:233-246)."""

    def test_rank_deficient_operator(self):
        # OP is a projector onto the first 50 coordinates composed with a
        # diagonal: anything outside range(OP) must never contaminate the
        # Krylov space, and converged vectors must lie in the range.
        n = 120
        r = 50
        d = np.concatenate([np.linspace(5, 10, r), np.zeros(n - r)])
        op = at.from_diagonal(d, n_pad=at.pad_dim(n))
        vals, vecs = at.eigsh(op, k=3, which="LM", ncv=12, tol=1e-10,
                              maxiter=300)
        np.testing.assert_allclose(np.sort(vals), [9.79591837, 9.89795918,
                                                   10.0], rtol=1e-6)
        # eigenvectors supported entirely inside the range
        assert np.abs(vecs[r:, :]).max() < 1e-8


class TestUserShifts:
    """ishift=0 / ido=3 protocol: caller supplies the shifts
    (SRC/dsaup2.f:700-724)."""

    def test_exact_shift_callback_matches_builtin(self):
        n = 200
        d = np.linspace(1, 60, n)
        op = at.from_diagonal(d, n_pad=at.pad_dim(n))
        calls = []

        def shift_fn(ritz_unwanted, bounds_unwanted):
            calls.append(len(ritz_unwanted))
            # supply exact shifts sorted like dsgets would
            order = np.argsort(-np.abs(bounds_unwanted))
            return ritz_unwanted[order]

        cfg = IRAMConfig(n=n, nev=4, ncv=14, which="LA", symmetric=True,
                         dtype=np.float64, n_pad=op.n_pad, tol=1e-10,
                         max_iter=500, exact_shifts=False)
        solver = IRAMSolver(op, cfg, shift_fn=shift_fn)
        res = solver.solve()
        assert res.nconv >= 4
        assert len(calls) >= 1
        out = extract(op, cfg, res)
        np.testing.assert_allclose(np.sort(out.values),
                                   np.sort(d)[-4:], rtol=1e-9)

    def test_requires_shift_fn(self):
        op = at.from_diagonal(np.arange(1.0, 101.0))
        cfg = IRAMConfig(n=100, nev=3, ncv=10, which="LA", symmetric=True,
                         dtype=np.float64, n_pad=op.n_pad,
                         exact_shifts=False)
        with pytest.raises(ValueError, match="shift_fn"):
            IRAMSolver(op, cfg)

    def test_fused_driver_user_shifts(self):
        """ishift=0 through the FUSED symmetric driver: two dispatches
        per cycle around the host shift_fn (dsaup2.f:700-724 parity,
        round-3 verdict item)."""
        from arpack_ng_tpu.core.device_sym import FusedSymSolver
        n = 200
        d = np.linspace(1, 60, n)
        op = at.from_diagonal(d, n_pad=at.pad_dim(n))
        calls = []

        def shift_fn(ritz_unwanted, bounds_unwanted):
            calls.append(len(ritz_unwanted))
            order = np.argsort(-np.abs(bounds_unwanted))
            return ritz_unwanted[order]

        cfg = IRAMConfig(n=n, nev=4, ncv=14, which="LA", symmetric=True,
                         dtype=np.float64, n_pad=op.n_pad, tol=1e-10,
                         max_iter=500, exact_shifts=False)
        solver = FusedSymSolver(op, cfg, shift_fn=shift_fn)
        res = solver.solve()
        assert res.nconv >= 4
        assert len(calls) >= 1
        out = extract(op, cfg, res)
        np.testing.assert_allclose(np.sort(out.values),
                                   np.sort(d)[-4:], rtol=1e-9)

    def test_eigsh_shift_fn_runs_fused(self):
        """eigsh(shift_fn=...) + strategy='auto' solves through the fused
        driver (no silent hybrid fallback)."""
        n = 150
        d = np.linspace(2, 30, n)

        def shift_fn(ritz_unwanted, bounds_unwanted):
            return ritz_unwanted

        vals, vecs = at.eigsh(at.from_diagonal(d, n_pad=at.pad_dim(n)),
                              k=3, which="LA", ncv=12, tol=1e-8,
                              maxiter=400, dtype=np.float64,
                              shift_fn=shift_fn)
        np.testing.assert_allclose(np.sort(vals), np.sort(d)[-3:],
                                   rtol=1e-7)

    def test_fused_exact_shifts_reject_shift_fn(self):
        from arpack_ng_tpu.core.device_sym import FusedSymSolver
        op = at.from_diagonal(np.arange(1.0, 101.0))
        cfg = IRAMConfig(n=100, nev=3, ncv=10, which="LA", symmetric=True,
                         dtype=np.float64, n_pad=op.n_pad)
        with pytest.raises(ValueError, match="exact_shifts"):
            FusedSymSolver(op, cfg, shift_fn=lambda r, b: r)


class TestThickSelective:
    """Since round 5 the thick restart re-tridiagonalizes the kept block
    (core/device_sym._retridiagonalize), so reorth='auto' resolves to
    'selective' for BOTH restart schemes and thick+selective neither
    warns nor degenerates (the round-3 2.8x arrowhead measurement
    predates the re-tridiagonalization)."""

    def test_auto_resolution(self):
        from arpack_ng_tpu.api import _resolve_sym_reorth
        assert _resolve_sym_reorth("auto", "implicit") == "selective"
        assert _resolve_sym_reorth("auto", "thick") == "selective"
        assert _resolve_sym_reorth("dgks", "thick") == "dgks"
        assert _resolve_sym_reorth("selective", "implicit") == "selective"

    def test_selective_thick_no_warning_and_converges(self):
        import warnings
        d = np.linspace(1, 20, 80)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            vals = at.eigsh(at.from_diagonal(d, n_pad=at.pad_dim(80)),
                            k=3, which="LA", ncv=10, tol=1e-6,
                            maxiter=300, dtype=np.float64,
                            restart="thick", reorth="selective",
                            return_eigenvectors=False)
        np.testing.assert_allclose(np.sort(vals), np.sort(d)[-3:],
                                   rtol=1e-5)

    def test_thick_selective_event_rate_stays_low(self):
        # the round-3 arrowhead degeneration fired a reorth event EVERY
        # step; re-tridiagonalization must keep the selective schedule's
        # event rate comparable to the implicit restart's
        import jax as _jax
        from arpack_ng_tpu import models
        from arpack_ng_tpu.config import IRAMConfig
        from arpack_ng_tpu.core.device_sym import FusedSymSolver
        nx = 16
        op, _ = models.laplacian_2d(nx, dtype=np.float64)
        rates = {}
        for restart in ("implicit", "thick"):
            cfg = IRAMConfig(n=nx * nx, nev=4, ncv=20, which="LA",
                             symmetric=True, dtype=np.dtype(np.float64),
                             n_pad=op.n_pad, tol=1e-10, max_iter=500,
                             reorth="selective", restart=restart)
            res = FusedSymSolver(op, cfg).solve()
            assert res.nconv >= 4
            c = _jax.device_get(res.state.counts)
            rates[restart] = int(c.nrorth) / max(int(c.nopx), 1)
        assert rates["thick"] < 0.9  # NOT one event per step
        assert rates["thick"] <= rates["implicit"] * 2.0 + 0.2

    def test_thick_selective_basis_defect_bounded(self):
        from arpack_ng_tpu import models
        from arpack_ng_tpu.config import IRAMConfig
        from arpack_ng_tpu.core.device_sym import FusedSymSolver
        from arpack_ng_tpu.utils import dtypes as _dt
        import jax as _jax
        nx = 16
        for dtype in (np.float32, np.float64):
            op, _ = models.laplacian_2d(nx, dtype=dtype)
            cfg = IRAMConfig(n=nx * nx, nev=4, ncv=24, which="LA",
                             symmetric=True, dtype=np.dtype(dtype),
                             n_pad=op.n_pad, tol=1e-30, max_iter=30,
                             reorth="selective", restart="thick")
            res = FusedSymSolver(op, cfg).solve()
            V = np.asarray(_jax.device_get(res.state.V), np.float64)
            V = V.reshape(V.shape[0], -1)
            defect = np.max(np.abs(V @ V.T - np.eye(cfg.ncv)))
            assert defect < 64 * np.sqrt(_dt.eps(dtype))


class TestComplexShiftRealArithmetic:
    """dndrv5/dndrv6-class: complex sigma on a real problem, modes 3/4
    (OP = Re/Im[inv(A - sigma M) M]) with Rayleigh-quotient eigenvalue
    recovery (SRC/dnaupd.f:20-36)."""

    def test_mode3_real_part(self, rng):
        n = 100
        a = rng.standard_normal((n, n)) / np.sqrt(n)
        sigma = 0.2 + 0.35j
        vals, vecs = at.eigs(a, k=4, sigma=sigma, which="LM", tol=1e-10,
                             maxiter=600)
        w = np.linalg.eigvals(a)
        # real-arithmetic OP treats sigma and conj(sigma) symmetrically
        # (dndrv5 semantics): every returned value is a TRUE eigenvalue,
        # and the closest-to-sigma one is found.
        for v in vals:
            assert np.min(np.abs(w - v)) < 1e-6
        closest = w[np.argmin(np.abs(w - sigma))]
        assert np.min(np.abs(vals - closest)) < 1e-6
        assert residual(a, vals, vecs).max() < 1e-6

    def test_mode4_imag_part(self, rng):
        from arpack_ng_tpu.ops import transforms
        n = 100
        a = rng.standard_normal((n, n)) / np.sqrt(n)
        sigma = 0.2 + 0.35j
        op = transforms.build_nonsym_operator(a, M=np.eye(n), sigma=sigma,
                                              part="imag")
        assert op.mode == 4
        vals, vecs = at.eigs(op, k=4, which="LM", tol=1e-10, maxiter=600)
        assert residual(a, vals, vecs).max() < 1e-6


class TestStatsAndDebug:
    def test_stats_summary_format(self):
        op, _ = models.laplacian_2d(8, dtype=np.float64)
        vals, vecs, out = at.eigsh(op, k=3, ncv=12, which="LA", tol=1e-8,
                                   maxiter=300, return_stats=True)
        s = out.stats.summary()
        for key in ("OP*x operations", "reorthogonalization",
                    "update iterations", "restart steps"):
            assert key in s
        assert out.stats.nopx > 0

    def test_debug_trace_emits(self, capsys):
        from arpack_ng_tpu.utils.debug import debug
        old = debug.maup2
        debug.maup2 = 1
        try:
            import sys
            debug.logfil = sys.stdout
            at.eigsh(at.from_diagonal(np.arange(1.0, 101.0)), k=2,
                     which="LA", tol=1e-8, maxiter=200, strategy="hybrid",
                     return_eigenvectors=False)
        finally:
            debug.maup2 = old
            debug.logfil = None
        outerr = capsys.readouterr()
        assert "_aup2" in outerr.out

    def test_debug_trace_emits_fused(self, capfd):
        # msglvl>0 must produce per-cycle dumps from the FUSED drivers
        # too (SRC/dsaup2.f:404-413): the device_trace hooks lower to
        # jax.debug.print host callbacks inside the on-device loop.
        from arpack_ng_tpu.utils.debug import debug
        old = (debug.maup2, debug.meigt)
        debug.maup2 = 2
        debug.meigt = 1
        try:
            at.eigsh(at.from_diagonal(np.arange(1.0, 101.0)), k=2,
                     which="LA", tol=1e-8, maxiter=200, strategy="fused",
                     return_eigenvectors=False)
        finally:
            debug.maup2, debug.meigt = old
        out = capfd.readouterr().out
        assert "_sym_cycle: iter" in out and "nconv=" in out
        assert "ritz (wanted last)" in out
        assert "eigenvalues of T" in out

    def test_debug_trace_emits_fused_realnonsym(self, capfd):
        from arpack_ng_tpu.utils.debug import debug
        old = debug.maup2
        debug.maup2 = 1
        try:
            op, _ = models.convection_diffusion_2d(8, dtype=np.float64)
            at.eigs(op, k=2, ncv=8, which="LM", tol=1e-6, maxiter=300,
                    strategy="fused_real", return_eigenvectors=False)
        finally:
            debug.maup2 = old
        out = capfd.readouterr().out
        assert "_realnonsym_cycle: iter" in out

    def test_counters_parity_fused_vs_hybrid(self):
        # nopx must agree between strategies for the same trajectory
        n = 150
        d = np.linspace(1, 40, n)
        op = at.from_diagonal(d, n_pad=at.pad_dim(n))
        v0 = np.ones(n)
        kw = dict(k=3, which="LA", ncv=12, tol=1e-10, maxiter=400, v0=v0,
                  return_stats=True, return_eigenvectors=False)
        _, s_f = at.eigsh(op, strategy="fused", **kw)
        _, s_h = at.eigsh(op, strategy="hybrid", **kw)
        assert s_f.stats.nopx == s_h.stats.nopx
        assert s_f.stats.n_iter == s_h.stats.n_iter


class TestSweep:
    """Miniature arpackmm.sh-style combinatorial sweep
    (EXAMPLES/MATRIX_MARKET/arpackmm.sh:10-50) through the Python API."""

    @pytest.mark.parametrize("sym", [True, False])
    @pytest.mark.parametrize("shift", [None, 0.5])
    @pytest.mark.parametrize("gen", [False, True])
    def test_combo(self, sym, shift, gen, rng):
        n = 80
        if sym:
            a = sp.diags([-np.ones(n - 1), 2.2 * np.ones(n),
                          -np.ones(n - 1)], [-1, 0, 1]).toarray()
        else:
            _, a_sp = models.convection_diffusion_1d(n, rho=8.0,
                                                     dtype=np.float64)
            a = a_sp.toarray()
        m = None
        if gen:
            m = (sp.diags([np.ones(n - 1), 4 * np.ones(n),
                           np.ones(n - 1)], [-1, 0, 1]) / 6.0).toarray()
        fn = at.eigsh if sym else at.eigs
        vals, vecs = fn(a, k=3, M=m, sigma=shift, which="LM", tol=1e-9,
                        maxiter=800)
        assert residual(a, vals, vecs,
                        m if m is not None else None).max() < 1e-6


class TestSafeNorms:
    """pdnorm2-analog overflow-safe two-phase norms
    (PARPACK/SRC/MPI/pdnorm2.f:70-80)."""

    def test_extreme_scale_f32(self):
        # entries ~1e25: |x|^2 overflows f32 (max ~3.4e38); the scaled
        # two-phase norm survives where the plain vdot would inf out
        import jax.numpy as jnp
        from arpack_ng_tpu.config import IRAMConfig
        from arpack_ng_tpu.core.arnoldi import make_bnorm
        n = 256
        op = at.from_diagonal(np.ones(n, np.float32))
        cfg = IRAMConfig(n=n, nev=2, ncv=8, which="LA", symmetric=True,
                         dtype=np.float32, n_pad=n, safe_norms=True)
        bnorm = make_bnorm(op, cfg)
        x = jnp.full((n,), 1e25, jnp.float32)
        nrm = float(bnorm(x, x))
        assert np.isfinite(nrm)
        np.testing.assert_allclose(nrm, 1e25 * np.sqrt(n), rtol=1e-5)
        # plain norm overflows
        plain = float(jnp.sqrt(jnp.abs(jnp.vdot(x, x))))
        assert not np.isfinite(plain)

    def test_solve_with_safe_norms(self):
        from arpack_ng_tpu.config import IRAMConfig
        from arpack_ng_tpu.core.device_sym import FusedSymSolver
        from arpack_ng_tpu.core.extract import extract
        n = 200
        d = np.linspace(1, 50, n)
        op = at.from_diagonal(d, n_pad=at.pad_dim(n))
        cfg = IRAMConfig(n=n, nev=3, ncv=12, which="LA", symmetric=True,
                         dtype=np.float64, n_pad=op.n_pad, tol=1e-10,
                         max_iter=400, safe_norms=True)
        res = FusedSymSolver(op, cfg).solve()
        out = extract(op, cfg, res)
        np.testing.assert_allclose(np.sort(out.values), np.sort(d)[-3:],
                                   rtol=1e-9)


class TestMatmulPrecisionPinning:
    """Ghost-Ritz guard (utils/precision.py): solver contractions MUST
    trace under 'highest' matmul precision — a reduced-precision f32 dot
    (TF32 on a GPU) silently de-orthogonalizes the basis.  These tests
    pin the wiring (the numeric failure itself shows only on an
    accelerator; chip_smoke.py checks it there)."""

    def test_level_is_not_default(self):
        from arpack_ng_tpu.utils import precision
        assert precision.LEVEL == "highest"

    def test_builders_are_wrapped(self):
        import jax
        from arpack_ng_tpu import models
        from arpack_ng_tpu.config import IRAMConfig
        from arpack_ng_tpu.core import arnoldi, device_sym

        op, _ = models.laplacian_2d(8, dtype=np.float64)
        cfg = IRAMConfig(n=op.n, nev=2, ncv=8, which="LA", symmetric=True,
                         dtype=np.float64, n_pad=op.n_pad)
        for fn in (arnoldi.make_init(op, cfg),
                   arnoldi.make_extend(op, cfg),
                   device_sym.make_sym_head(op, cfg),
                   device_sym.make_sym_tail(op, cfg)):
            # hiprec preserves identity via functools.wraps
            assert getattr(fn, "__wrapped__", None) is not None, fn

    def test_hiprec_context_applies(self):
        import jax
        from arpack_ng_tpu.utils.precision import hiprec
        seen = {}

        def probe():
            seen["prec"] = jax.config.jax_default_matmul_precision
            return 0

        hiprec(probe)()
        assert seen["prec"] == "highest"
