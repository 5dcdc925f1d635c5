"""High-level solver API: the user-facing equivalent of the reference's
driver pairs ``[sd]saupd/[sd]seupd`` (symmetric), ``[sd]naupd/[sd]neupd``
(non-symmetric) and ``[cz]naupd/[cz]neupd`` (complex) — with the reverse
communication loop replaced by operator callables and the s/d/c/z
quadruplication replaced by a dtype argument.

Function names follow the scipy.sparse.linalg convention (``eigsh``/
``eigs``/``svds``), since scipy wraps this exact reference library — making
signature compatibility a free parity test surface.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np

from .config import IRAMConfig, default_ncv, pad_dim
from .core.extract import EigenResult, extract
from .core.iram import IRAMResult, IRAMSolver
from .ops import operator as op_mod
from .ops.operator import Operator
from .utils import dtypes as _dt


def _as_operator(A, dtype=None, hermitian=False) -> Operator:
    """Coerce a user input (Operator | dense array | scipy sparse) into an
    :class:`Operator` (standard problem, mode 1)."""
    if isinstance(A, Operator):
        return A
    if hasattr(A, "tocsr"):  # scipy sparse
        from .ops.sparse import from_scipy
        return from_scipy(A, dtype=dtype, hermitian=hermitian)
    a = np.asarray(A)
    if a.ndim == 2:
        if dtype is not None:
            a = a.astype(dtype)
        return op_mod.from_dense(a, n_pad=pad_dim(a.shape[0]),
                                 hermitian=hermitian)
    raise TypeError(f"cannot build an Operator from {type(A)!r}")


def _solve(op: Operator, cfg: IRAMConfig, v0, return_eigenvectors,
           return_stats, shift_fn=None, mesh=None, strategy="auto",
           select=None, validate=None, raw_A=None, raw_M=None):
    solver = _make_solver(op, cfg, shift_fn, mesh, strategy)
    res = solver.solve(v0=v0)
    if res.info < 0:
        raise ArpackError(res.info)
    out = extract(op, cfg, res,
                  rvec=return_eigenvectors or validate is not None,
                  howmny="S" if select is not None else "A", select=select)
    if validate is not None:
        if callable(validate):
            out.validation = _f64_validate(None, None, out, cfg,
                                           matvec64=validate)
        elif validate == "f64":
            if raw_A is None or isinstance(raw_A, Operator):
                raise ValueError(
                    "validate='f64' needs a concrete matrix input; for "
                    "a matrix-free Operator pass validate=<f64 matvec "
                    "callable> instead")
            out.validation = _f64_validate(raw_A, raw_M, out, cfg)
        else:
            raise ValueError("validate must be None, 'f64', or a "
                             "float64 matvec callable")
        if not return_eigenvectors:
            out.vectors = None
    if res.info in (1, 2) and select is None and out.nconv < cfg.nev:
        raise ArpackNoConvergence(out, cfg)
    if return_eigenvectors:
        ret = (out.values, out.vectors)
    else:
        ret = out.values
    if return_stats:
        return ret + (out,) if return_eigenvectors else (ret, out)
    return ret


def _resolve_storage(storage_dtype, dtype, tol, pro_active=False):
    """Resolve ``storage_dtype='auto'``: bfloat16 basis storage when the
    requested tolerance permits it.

    bf16 storage halves the dominant HBM-traffic term of the full-CGS
    paths (V streams) at an accuracy floor of ~0.8% relative
    (~2*eps(bf16)*||A||) — so it is enabled automatically
    only for real float32 problems whose tol is comfortably above that
    floor.  When partial-reorthogonalization Lanczos is active
    (``pro_active``) the basis is no longer streamed every step, so narrow
    storage buys almost nothing while raising the omega noise floor —
    auto keeps full precision there.  Pass ``storage_dtype=None`` to force
    full-precision storage, or an explicit dtype to force narrow storage
    regardless of tol.
    """
    if not (isinstance(storage_dtype, str) and storage_dtype == "auto"):
        return storage_dtype
    if pro_active or np.dtype(dtype) != np.dtype(np.float32):
        return None
    if tol is not None and tol >= 1e-2:
        import jax.numpy as jnp
        return jnp.bfloat16
    return None


def _resolve_sym_reorth(reorth: str, restart: str) -> str:
    """Resolve ``reorth='auto'`` for the symmetric/Hermitian path.

    Symmetric problems run Lanczos, where semi-orthogonality provably
    preserves eps-level Ritz accuracy (Simon 1984) — partial
    reorthogonalization ('selective') is the default and removes the
    dominant V-traffic term.  This holds for ``restart='thick'`` too:
    the fused tail re-tridiagonalizes the kept block
    (core/device_sym._retridiagonalize), so the three-term omega
    recurrence stays valid across thick restarts."""
    if reorth == "auto":
        return "selective"
    return reorth


def _make_solver(op, cfg, shift_fn=None, mesh=None, strategy="auto"):
    """Pick the execution strategy.

    'fused'  — entire restart cycle as one XLA computation (device
               reduced space); symmetric/Hermitian, all which selectors
               incl. 'BE'.  User shifts (ishift=0) run fused too, as two
               dispatches per cycle around the host shift_fn callback
               (the ido=3 protocol, SRC/dsaup2.f:700-724).
    'hybrid' — host float64 reduced space (the PARPACK-like split).
    """
    use_fused = (strategy == "fused") or (
        strategy == "auto" and cfg.symmetric)
    if use_fused:
        from .core.device_sym import FusedSymSolver
        return FusedSymSolver(op, cfg, mesh=mesh, shift_fn=shift_fn)
    return IRAMSolver(op, cfg, shift_fn=shift_fn, mesh=mesh)


class PseudospectrumWarning(UserWarning):
    """Single-precision non-normal eigenproblem caveat:
    residual-converged Ritz values of a non-normal operator
    solved in f32 may lie in the operator's eps_f32-pseudospectrum —
    up to ~``eta*||A||`` OUTSIDE the true spectrum — while genuinely
    satisfying their residual bound (which is all any Krylov method can
    certify; the reference's snaupd shares the property)."""


@dataclasses.dataclass
class F64Validation:
    """Report of ``eigs(..., validate='f64')``: the converged pairs
    re-applied through a float64 operator (see
    :class:`PseudospectrumWarning`)."""

    residuals: np.ndarray      # ||A v - lambda (M) v||_2 per pair, f64
    rel_residuals: np.ndarray  # scaled by max(eps23, |lambda|) (dsconv)
    tol_bar: float             # the solve's effective tolerance
    passed: bool               # all rel_residuals <= tol_bar
    nonnormality: float        # probe estimate of ||(A*A'-A'*A)z||/||A'Az||


def _f64_validate(A_raw, M_raw, out, cfg, matvec64=None):
    """Re-apply converged pairs through a float64 (complex128) operator
    and estimate non-normality.  ``matvec64``: optional caller-supplied
    f64 matvec for matrix-free problems (then non-normality is probed
    with transpose unavailable and reported as nan)."""
    vals = np.asarray(out.values)
    vecs = out.vectors
    if vecs is None or out.nconv == 0:
        return None
    cplx = np.iscomplexobj(vals) or np.iscomplexobj(vecs)
    wdt = np.complex128 if cplx else np.float64
    V = np.asarray(vecs, dtype=wdt)

    if matvec64 is not None:
        AV = np.stack([np.asarray(matvec64(V[:, j]), dtype=wdt)
                       for j in range(V.shape[1])], axis=1)
        nonnorm = float("nan")
    else:
        if hasattr(A_raw, "tocsr"):
            A64 = A_raw.tocsr().astype(wdt)
        else:
            A64 = np.asarray(A_raw, dtype=wdt)
        AV = A64 @ V
        # stochastic non-normality probe: z -> ||(A A^H - A^H A) z|| /
        # ||A^H A z|| over a few unit probes (exactly 0 for normal A)
        rng = np.random.default_rng(0)
        nonnorm = 0.0
        AH = A64.conj().T
        for _ in range(3):
            z = rng.standard_normal(V.shape[0])
            if cplx:
                z = z + 1j * rng.standard_normal(V.shape[0])
            z = z.astype(wdt) / np.linalg.norm(z)
            aaz = AH @ (A64 @ z)
            num = np.linalg.norm(A64 @ (AH @ z) - aaz)
            den = max(np.linalg.norm(aaz), 1e-300)
            nonnorm = max(nonnorm, float(num / den))
    if M_raw is not None:
        if hasattr(M_raw, "tocsr"):
            M64 = M_raw.tocsr().astype(wdt)
        else:
            M64 = np.asarray(M_raw, dtype=wdt)
        R = AV - (M64 @ V) * vals[None, :].astype(wdt)
    else:
        R = AV - V * vals[None, :].astype(wdt)
    res = np.linalg.norm(R, axis=0) / np.maximum(
        np.linalg.norm(V, axis=0), 1e-300)
    eps23 = cfg.eps23
    rel = res / np.maximum(np.abs(vals), eps23)
    tol_bar = cfg.tol_effective
    passed = bool(np.all(rel <= tol_bar))
    rep = F64Validation(residuals=res, rel_residuals=rel,
                        tol_bar=float(tol_bar), passed=passed,
                        nonnormality=nonnorm)
    single = np.dtype(cfg.dtype).itemsize <= (8 if cplx else 4)
    import warnings
    if not passed:
        warnings.warn(
            "f64 validation: converged pairs do not meet the requested "
            f"tolerance under a float64 operator (max relative residual "
            f"{float(np.max(rel)):.3e} > tol {tol_bar:.1e}); the f32 "
            "matvec's backward error placed them in the operator's "
            "eps_f32-pseudospectrum — re-solve with an f64 operator",
            PseudospectrumWarning, stacklevel=4)
    elif single and not (nonnorm != nonnorm) and nonnorm > 1e-6:
        warnings.warn(
            "operator is non-normal (probe "
            f"{nonnorm:.2e}) and was solved in single precision: "
            "residual-converged Ritz values may lie up to ~eta*||A|| "
            "OUTSIDE the spectrum (eps_f32-pseudospectrum; max f64 "
            f"relative residual {float(np.max(rel)):.3e}).  Interpret "
            "f32 results as pseudospectral or re-solve with an f64 "
            "operator",
            PseudospectrumWarning, stacklevel=4)
    return rep


class ArpackError(RuntimeError):
    """Solver error with the reference's info-code catalog
    (SRC/dsaupd.f:247-276)."""

    _CODES = {
        -1: "n must be positive",
        -2: "nev must be positive",
        -3: "ncv out of range (need nev < ncv <= n)",
        -4: "max_iter must be positive",
        -5: "invalid which",
        -6: "invalid bmat",
        -7: "work array too small (not applicable)",
        -8: "reduced-space eigensolver failed",
        -9: "starting vector is zero",
        -9999: "could not build an Arnoldi factorization",
        -13: "nev and which='BE' incompatible",
        -14: "did not find enough converged eigenvalues on extraction",
    }

    def __init__(self, info: int):
        self.info = info
        super().__init__(
            f"ARPACK error {info}: {self._CODES.get(info, 'unknown')}")


class ArpackNoConvergence(ArpackError):
    """Max restarts reached with fewer than nev converged (info = 1)."""

    def __init__(self, partial: EigenResult, cfg: IRAMConfig):
        self.eigenvalues = partial.values
        self.eigenvectors = partial.vectors
        self.info = 1
        RuntimeError.__init__(
            self,
            f"ARPACK error 1: no convergence ({partial.nconv}/{cfg.nev} "
            f"eigenvalues converged in {cfg.max_iter} restart iterations)")


def eigsh(
    A,
    k: int = 6,
    *,
    M=None,
    sigma: Optional[float] = None,
    which: str = "LM",
    v0=None,
    ncv: Optional[int] = None,
    maxiter: Optional[int] = None,
    tol: float = 0.0,
    mode: str = "normal",
    return_eigenvectors: bool = True,
    return_stats: bool = False,
    dtype=None,
    seed: int = 0,
    mesh=None,
    strategy: str = "auto",
    storage_dtype="auto",
    restart: str = "implicit",
    reorth: str = "auto",
    select=None,
    shift_fn=None,
    validate=None,
):
    """Symmetric/Hermitian eigensolver (dsaupd/dseupd equivalent).

    ``validate='f64'`` (or a float64 matvec callable): re-apply the
    converged pairs through a float64 operator and attach an
    :class:`F64Validation` report (see :func:`eigs`; for symmetric —
    i.e. normal — operators there is no pseudospectrum hazard, so this
    is a pure backward-error report).

    ``shift_fn(ritz_unwanted, bounds_unwanted) -> shifts``: caller-
    supplied implicit shifts (the reference's ishift=0 / ido=3 protocol,
    SRC/dsaup2.f:700-724).  Runs through the fused device driver as two
    dispatches per cycle around the host callback; nev stagnation
    inflation is disabled exactly as in the reference (dsaup2.f:673).

    Modes (reference iparam(7), SRC/dsaupd.f:30-48):

    * ``sigma is None, M is None``   -> mode 1 (regular)
    * ``sigma is None, M given``     -> mode 2 (regular inverse: inv(M)*A)
    * ``sigma, mode='normal'``       -> mode 3 (shift-invert)
    * ``sigma, mode='buckling'``     -> mode 4
    * ``sigma, mode='cayley'``       -> mode 5

    ``select``: length-ncv boolean mask enabling the documented (but
    never-implemented) reference ``howmny='S'`` semantics
    (SRC/dseupd.f:62-66): vectors/values are returned only for Ritz
    values flagged True (positionally over the final factorization's
    Ritz values, converged entries only).
    """
    if sigma is not None or mode != "normal" or M is not None:
        from .ops import transforms
        op = transforms.build_sym_operator(A, M=M, sigma=sigma, mode=mode,
                                           dtype=dtype)
    else:
        op = _as_operator(A, dtype=dtype, hermitian=True)
    n = op.n
    ncv = ncv if ncv is not None else default_ncv(n, k, symmetric=True)
    if shift_fn is not None and restart == "thick":
        raise ValueError("shift_fn requires restart='implicit' "
                         "(a thick restart applies no shifts)")
    reorth = _resolve_sym_reorth(reorth, restart)
    pro_active = (reorth == "selective" and restart == "implicit")
    storage_dtype = _resolve_storage(storage_dtype, op.dtype, tol,
                                     pro_active=pro_active)
    cfg = IRAMConfig(
        n=n, nev=k, ncv=min(ncv, n), which=which, bmat=op.bmat, mode=op.mode,
        tol=tol, max_iter=maxiter if maxiter is not None else 10 * n,
        symmetric=True, dtype=np.dtype(op.dtype), n_pad=op.n_pad, seed=seed,
        exact_shifts=shift_fn is None, storage_dtype=storage_dtype,
        restart=restart, reorth=reorth)
    return _solve(op, cfg, v0, return_eigenvectors, return_stats,
                  shift_fn=shift_fn, mesh=mesh, strategy=strategy,
                  select=select, validate=validate,
                  raw_A=None if isinstance(A, Operator) else A,
                  raw_M=M)


def eigs(
    A,
    k: int = 6,
    *,
    M=None,
    sigma: Optional[complex] = None,
    which: str = "LM",
    v0=None,
    ncv: Optional[int] = None,
    maxiter: Optional[int] = None,
    tol: float = 0.0,
    return_eigenvectors: bool = True,
    return_stats: bool = False,
    return_schur: bool = False,
    dtype=None,
    seed: int = 0,
    mesh=None,
    strategy: str = "auto",
    reorth: str = "auto",
    select=None,
    validate=None,
):
    """Non-symmetric / complex eigensolver (dnaupd/dneupd, znaupd/zneupd).

    ``validate='f64'``: re-apply the converged pairs through a float64
    operator, attach an :class:`F64Validation` report to the result
    (``return_stats``), and emit a :class:`PseudospectrumWarning` when
    the pairs miss the requested tolerance at f64 fidelity or the
    operator is detectably non-normal in a single-precision solve — the
    productized form of the finding that f32
    residual-converged values of non-normal operators can sit
    ~eta*||A|| outside the spectrum.  Requires a concrete matrix input
    (dense / scipy sparse); for matrix-free problems pass a callable
    ``validate=matvec64`` evaluating ``A @ v`` in float64.

    ``select``: length-ncv boolean mask — the documented dneupd/zneupd
    ``howmny='S'`` semantics (SRC/dneupd.f:60-66; the reference returns
    info=-12 'not yet implemented'): only flagged, converged Ritz values
    get vectors, with complex-conjugate partners auto-completed in real
    arithmetic.

    ``strategy='fused'`` runs the whole restart loop on device (complex
    arithmetic; real problems are complexified — the 2x-flops trade for
    zero host round trips).  ``strategy='fused_real'`` (real problems
    only) keeps the fused loop in REAL arithmetic: device real Schur via
    explicit double-shift QR, pair-preserving shift selection — single
    matvec cost and runs on complex-incapable backends
    (core/device_realnonsym.py); the 'auto' default for real problems.
    Its reduced space runs in the PROBLEM dtype — float32 solves match
    the reference's single-precision (snaupd) semantics; pass
    ``strategy='hybrid'`` for the host-float64 reduced space (stronger
    than snaupd) if an ill-conditioned f32 problem stalls.  ``'hybrid'``
    remains the 'auto' default for complex dtypes."""
    if sigma is not None or M is not None:
        from .ops import transforms
        op = transforms.build_nonsym_operator(A, M=M, sigma=sigma,
                                              dtype=dtype)
    else:
        op = _as_operator(A, dtype=dtype, hermitian=False)
    n = op.n
    ncv = ncv if ncv is not None else default_ncv(n, k, symmetric=False)
    if reorth == "auto":
        # Arnoldi (non-symmetric) keeps the reference's DGKS trigger: the
        # semi-orthogonality argument behind 'selective' is a Lanczos
        # result; pass reorth='selective' explicitly to opt in.
        reorth = "dgks"
    cfg = IRAMConfig(
        n=n, nev=k, ncv=min(ncv, n), which=which, bmat=op.bmat, mode=op.mode,
        tol=tol, max_iter=maxiter if maxiter is not None else 10 * n,
        symmetric=False, dtype=np.dtype(op.dtype), n_pad=op.n_pad, seed=seed,
        reorth=reorth)
    if (strategy == "auto"
            and not np.issubdtype(np.dtype(op.dtype), np.complexfloating)):
        # real problems default to the fused real-arithmetic device loop
        # (no host round trip per cycle, real arithmetic only); validated
        # identical to the hybrid on standard, generalized and
        # shift-invert problems.  Complex dtypes keep the
        # reference-faithful hybrid by default.
        strategy = "fused_real"
    if strategy == "fused":
        from .core.device_nonsym import (FusedNonsymSolver,
                                         complexify_operator)
        op = complexify_operator(op)
        # preserve every other config field
        cfg = dataclasses.replace(cfg, dtype=np.dtype(op.dtype))
        solver = FusedNonsymSolver(op, cfg, mesh=mesh)
    elif strategy == "fused_real":
        if np.issubdtype(np.dtype(op.dtype), np.complexfloating):
            raise ValueError("strategy='fused_real' is for real problems; "
                             "use strategy='fused' for complex dtypes")
        from .core.device_realnonsym import FusedRealNonsymSolver
        solver = FusedRealNonsymSolver(op, cfg, mesh=mesh)
    else:
        solver = IRAMSolver(op, cfg, mesh=mesh)
    res = solver.solve(v0=v0)
    if res.info < 0:
        raise ArpackError(res.info)
    out = extract(op, cfg, res, rvec=return_eigenvectors or return_schur
                  or validate is not None,
                  howmny="P" if return_schur
                  else ("S" if select is not None else "A"),
                  select=select)
    if validate is not None and not return_schur:
        if callable(validate):
            out.validation = _f64_validate(None, None, out, cfg,
                                           matvec64=validate)
        elif validate == "f64":
            if isinstance(A, Operator):
                raise ValueError(
                    "validate='f64' needs a concrete matrix input; for "
                    "a matrix-free Operator pass validate=<f64 matvec "
                    "callable> instead")
            out.validation = _f64_validate(A, M, out, cfg)
        else:
            raise ValueError("validate must be None, 'f64', or a "
                             "float64 matvec callable")
        if not return_eigenvectors:
            out.vectors = None
    if res.info in (1, 2) and select is None and out.nconv < cfg.nev:
        raise ArpackNoConvergence(out, cfg)
    if return_eigenvectors or return_schur:
        ret = (out.values, out.vectors)
    else:
        ret = out.values
    if return_stats:
        return ret + (out,) if (return_eigenvectors or return_schur) \
            else (ret, out)
    return ret
