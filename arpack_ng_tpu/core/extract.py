"""Eigenpair extraction and back-transformation: the dseupd / dneupd /
zneupd equivalent.

Responsibilities (mirroring SRC/dseupd.f and SRC/dneupd.f):

* re-derive the reduced-space eigensystem from the final H and re-apply the
  eps^(2/3) convergence test (dseupd re-solves with dsteqr at :536; count
  mismatch with the iteration phase is reference info = -14),
* select the converged wanted subset per ``which``,
* form Ritz (or Schur) vectors by rotating the Lanczos/Arnoldi basis —
  the O(n*ncv*nconv) GEMM runs on device,
* untransform eigenvalues for spectral-transform modes:
  SHIFTI ``lambda = sigma + 1/theta``, BUCKLE ``lambda = sigma*theta/
  (theta-1)``, CAYLEY ``lambda = sigma*(theta+1)/(theta-1)``
  (SRC/dseupd.f:656-683); non-symmetric shift-invert ``lambda = sigma +
  1/theta`` (SRC/dneupd.f), optionally replaced by device Rayleigh
  quotients when the raw operator is available (the reference tells users
  to do exactly this for complex shifts in real arithmetic, dndrv5/6),
* Ritz-vector purification for generalized modes 3/4/5: one formal step of
  inverse subspace iteration, ``z += resid * (last_comp/theta)`` (SHIFTI/
  CAYLEY) or ``/(theta-1)`` (BUCKLE) (SRC/dseupd.f:817-843, dger at :843).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg as sla

from ..config import IRAMConfig
from ..ops.operator import Operator
from ..utils import dtypes as _dt
from . import reduced
from .iram import IRAMResult


@dataclasses.dataclass
class EigenResult:
    """User-facing solve output (dseupd/dneupd outputs d, z + iparam info)."""

    values: np.ndarray            # (nconv,) eigenvalues of the ORIGINAL problem
    vectors: Optional[np.ndarray]  # (n, nconv) or None if rvec=False
    nconv: int
    info: int
    bounds: np.ndarray            # Ritz estimates in the original system
    n_iter: int
    stats: object
    validation: object = None     # optional f64 back-substitution report
    #   (api._F64Validation) attached by eigs(..., validate='f64')


def _untransform(theta: np.ndarray, mode: int, sigma: complex,
                 symmetric: bool) -> np.ndarray:
    if mode in (1, 2):
        return theta.copy()
    if mode == 3:
        return sigma + 1.0 / theta
    if mode == 4 and symmetric:    # buckling
        return sigma * theta / (theta - 1.0)
    if mode == 5 and symmetric:    # Cayley
        return sigma * (theta + 1.0) / (theta - 1.0)
    # non-symmetric modes 3/4 with complex sigma in real arithmetic: caller
    # should use Rayleigh quotients (handled in extract()); fall back to
    # shift-invert relation.
    return sigma + 1.0 / theta


def _untransform_bounds(bounds: np.ndarray, theta: np.ndarray, mode: int,
                        sigma: complex, symmetric: bool) -> np.ndarray:
    """Ritz-estimate transformation to the original system
    (SRC/dseupd.f:762-790)."""
    if mode in (1, 2):
        return bounds.copy()
    if mode == 3:
        return np.abs(bounds) / np.abs(theta) ** 2
    if mode == 4 and symmetric:
        return np.abs(sigma) * np.abs(bounds) / np.abs(theta - 1.0) ** 2
    if mode == 5 and symmetric:
        return np.abs(bounds / theta * (theta - 1.0))
    return np.abs(bounds) / np.abs(theta) ** 2


def extract(op: Operator, cfg: IRAMConfig, result: IRAMResult,
            rvec: bool = True, howmny: str = "A",
            select: Optional[np.ndarray] = None,
            use_rayleigh: Optional[bool] = None) -> EigenResult:
    state = result.state
    kplusp = cfg.ncv
    sym = cfg.symmetric
    is_cplx = _dt.is_complex(cfg.dtype)
    host_dtype = np.complex128 if is_cplx else np.float64
    tol, eps23 = cfg.tol_effective, cfg.eps23
    rnorm = float(state.rnorm)
    info = result.info if result.info in (1, 2) else 0

    H = np.asarray(jax.device_get(state.H)).astype(host_dtype)

    # ---- reduced eigensystem from the final factorization ----
    if sym:
        if getattr(cfg, "restart", "implicit") == "thick":
            # thick restarts re-tridiagonalize the kept block
            # (device_sym._retridiagonalize), but the full-CGS (dgks)
            # extension writes full upper-column projections into H, so
            # the safe general read is the full projected matrix from
            # the upper triangle (the lower subdiagonal holds Lanczos-
            # convention beta writes)
            Tfull = np.triu(H.real) + np.triu(H.real, 1).T
            theta_all, Sr = np.linalg.eigh(Tfull)
            bounds_all = np.abs(rnorm * Sr[-1, :])
            S = Sr.astype(host_dtype)
        else:
            alpha = np.diag(H).real.copy()
            beta = np.diag(H, -1).real.copy() if kplusp > 1 else np.zeros(0)
            theta_all, bounds_all, S = reduced.sym_eigt(alpha, beta, rnorm)
            S = S.astype(host_dtype)
    else:
        theta_all, bounds_all, S = reduced.nonsym_eigt(H, rnorm)

    # ---- converged subset (dseupd re-test; mismatch -> info=-14) ----
    convm = reduced.conv_mask(theta_all, bounds_all, tol, eps23)
    idx_conv = np.where(convm)[0]
    nconv = result.nconv
    if len(idx_conv) < nconv:
        info = -14
        nconv = len(idx_conv)
    if nconv == 0:
        return EigenResult(values=np.zeros(0, host_dtype),
                           vectors=None, nconv=0, info=info,
                           bounds=np.zeros(0), n_iter=result.n_iter,
                           stats=result.stats)

    # most-wanted nconv among the converged, per `which`
    real_pairs = (not sym) and (not is_cplx)
    if howmny == "S":
        # Faithful select-mask semantics (SRC/dseupd.f:62-66, dneupd.f:60-66
        # — documented but returning info=-16/-12 'not yet implemented' in
        # the reference): SELECT(j) refers to the j-th Ritz value of the
        # final factorization in the aupd exit ordering (the reference's
        # workl/D layout, here ``result.ritz``).  Vectors are computed for
        # entries that are BOTH selected and converged; selections of
        # unconverged Ritz values are dropped.  In real arithmetic a
        # selected member of a complex-conjugate pair brings its partner
        # (real storage needs both halves, dneupd.f packed-pair remark).
        if select is None:
            raise ValueError("howmny='S' requires a select mask")
        select_m = np.asarray(select, bool).ravel()
        ritz_iter = np.asarray(result.ritz)
        if select_m.shape[0] != len(ritz_iter):
            raise ValueError(
                f"select must have length ncv={len(ritz_iter)} "
                "(one flag per Ritz value of the final factorization)")
        wanted_vals = ritz_iter[select_m]
        # map each selected iteration-Ritz value onto the re-solved
        # spectrum (theta_all), restricted to converged entries
        gate = max(np.sqrt(eps23), 1e-8)
        avail = list(idx_conv)
        sel_list = []
        for w in wanted_vals:
            if not avail:
                break
            j = min(avail, key=lambda t: abs(theta_all[t] - w))
            if abs(theta_all[j] - w) <= gate * max(1.0, abs(w)):
                sel_list.append(j)
                avail.remove(j)
        if real_pairs:
            for j in list(sel_list):
                tj = theta_all[j]
                if tj.imag == 0:
                    continue
                have = any(np.isclose(theta_all[p], np.conj(tj))
                           for p in sel_list if p != j)
                if not have:
                    cand = [p for p in avail
                            if np.isclose(theta_all[p], np.conj(tj))]
                    if cand:
                        sel_list.append(cand[0])
                        avail.remove(cand[0])
        sel = np.sort(np.array(sel_list, dtype=int))
        nconv = len(sel)
        if nconv == 0:
            return EigenResult(values=np.zeros(0, host_dtype),
                               vectors=None, nconv=0, info=info,
                               bounds=np.zeros(0), n_iter=result.n_iter,
                               stats=result.stats)
    elif sym and cfg.which == "BE":
        # both ends: nconv//2 from the low end, nconv - nconv//2 from the
        # high end — the dsgets/dsaup2 split convention (dsgets.f:166-171;
        # verified against the library for odd counts)
        order = np.argsort(theta_all[idx_conv], kind="stable")
        half_lo = nconv // 2
        half_hi = nconv - half_lo
        pick = np.concatenate([order[:half_lo],
                               order[len(order) - half_hi:]])
    else:
        key = reduced.sort_key(cfg.which, theta_all[idx_conv], real_pairs)
        pick = np.argsort(key, kind="stable")[len(idx_conv) - nconv:]
    if howmny != "S":
        sel = idx_conv[np.sort(pick)]
        if real_pairs:
            # dneupd may return nev+1 eigenvalues to avoid splitting a
            # conjugate pair at the selection boundary (SRC/dneupd.f
            # remarks; scipy allocates k+1 slots for exactly this).
            selset = set(sel.tolist())
            for i in sel:
                ti = theta_all[i]
                if ti.imag == 0:
                    continue
                partner = np.where(
                    np.isclose(theta_all[idx_conv], np.conj(ti)))[0]
                if len(partner) and idx_conv[partner[0]] not in selset:
                    sel = np.sort(np.append(sel, idx_conv[partner[0]]))
                    nconv += 1
                    break

    theta = theta_all[sel]
    bounds_sel = bounds_all[sel]

    # ---- eigenvalue back-transformation ----
    sigma = op.sigma
    lam = _untransform(theta, op.mode, sigma, sym)
    lam_bounds = _untransform_bounds(bounds_sel, theta, op.mode, sigma, sym)
    if sym:
        lam = lam.real

    # output ordering: ascending for symmetric (dseupd's final dsortr 'LA',
    # SRC/dseupd.f:697-707); 'which'-wanted-first for non-symmetric
    # (scipy-compatible: dneupd returns wanted ordering).
    if sym:
        order_out = np.argsort(lam, kind="stable")
    else:
        order_out = np.argsort(
            -reduced.sort_key(cfg.which, lam, real_pairs), kind="stable")
    theta, lam, lam_bounds, sel = (theta[order_out], lam[order_out],
                                   lam_bounds[order_out], sel[order_out])

    vectors = None
    if rvec:
        if howmny == "P" and not sym:
            # Schur basis of the wanted invariant subspace (dneupd
            # howmny='P', ICB/arpack.hpp:39-48): reorder the real/complex
            # Schur form so the selected eigenvalues lead, take the first
            # nconv Schur vectors.
            wanted_set = set(sel.tolist())
            flags = np.zeros(kplusp, dtype=bool)
            flags[list(wanted_set)] = True
            # scipy.schur sort callable works on eigenvalues; mark by value
            wanted_vals = theta_all[sel]

            def _sort(w_r, w_i=None):
                w = complex(w_r) if w_i is None else complex(w_r) \
                    + 1j * complex(w_i)
                return bool(np.min(np.abs(wanted_vals - w))
                            < 1e-8 * max(1.0, abs(w)))

            TT, QQ, sdim = sla.schur(
                H, output="complex" if is_cplx else "real", sort=_sort)
            Scols = QQ[:, :nconv].astype(host_dtype)
        else:
            Scols = S[:, sel]
            if not sym:
                # normalize Ritz vectors to unit 2-norm in the small system
                # (basis is orthonormal, so Z columns inherit unit norm;
                # dneupd normalizes via dtrevc + dscal)
                Scols = Scols / np.linalg.norm(Scols, axis=0, keepdims=True)

        V = state.V  # basis on device (either layout; contract dim 0)
        from ..utils.precision import hiprec
        gemm = jax.jit(hiprec(lambda s, v: jax.lax.dot_general(
            s, v.astype(s.dtype), (((1,), (0,)), ((), ())))))
        if (not _dt.is_complex(cfg.dtype)) and np.iscomplexobj(Scols):
            # real basis, complex reduced eigenvectors (conjugate pairs):
            # one real GEMM over the stacked [Re; Im] coefficients — the
            # device-friendly form of dneupd's packed real/imag pair
            # storage (ICB/arpack.h:13).
            Sstk = np.concatenate([Scols.real.T, Scols.imag.T], axis=0)
            Zstk = np.asarray(jax.device_get(
                gemm(jnp.asarray(Sstk.astype(cfg.dtype)), V)))
            Zstk = Zstk.reshape(Zstk.shape[0], -1)
            Zc = Zstk[: Scols.shape[1]] + 1j * Zstk[Scols.shape[1]:]
            Zh_rows = Zc.astype(np.complex128)
        else:
            Sdev = jnp.asarray(Scols.T.astype(cfg.dtype))  # (nconv, ncv)
            Zh_rows = np.asarray(jax.device_get(gemm(Sdev, V))).astype(
                host_dtype)
            Zh_rows = Zh_rows.reshape(Zh_rows.shape[0], -1)

        # ---- purification (generalized modes; SRC/dseupd.f:817-843) ----
        if op.mode in (3, 4, 5) and op.bmat == "G" and (howmny != "P"):
            last = Scols[-1, :]
            if op.mode in (3, 5):
                coef = last / theta
            else:  # buckling
                coef = last / (theta - 1.0)
            resid_h = np.asarray(jax.device_get(state.resid)).astype(
                host_dtype)
            Zh_rows = Zh_rows + coef[:, None] * resid_h[None, :]

        # Rayleigh-quotient eigenvalue recovery (non-symmetric complex-shift
        # modes in real arithmetic, reference dndrv5/6 pattern)
        if use_rayleigh is None:
            use_rayleigh = (not sym) and op.mode in (3, 4) \
                and op.a_apply is not None and np.iscomplexobj(np.array(sigma)) \
                and np.array(sigma).imag != 0
        if use_rayleigh and op.a_apply is not None:
            def _apply_c(fn, z):
                """Apply a (possibly real-dtype) device matvec to a complex
                host vector."""
                if np.iscomplexobj(z) and not _dt.is_complex(cfg.dtype):
                    re = np.asarray(jax.device_get(
                        fn(jnp.asarray(z.real.astype(cfg.dtype)))))
                    im = np.asarray(jax.device_get(
                        fn(jnp.asarray(z.imag.astype(cfg.dtype)))))
                    return re + 1j * im
                return np.asarray(jax.device_get(
                    fn(jnp.asarray(z.astype(cfg.dtype)))))

            lam_rq = np.zeros(nconv, np.complex128)
            for i in range(nconv):
                z = Zh_rows[i]
                az = _apply_c(op.a_apply, z)
                if op.m_apply is not None and op.bmat == "G":
                    mz = _apply_c(op.m_apply, z)
                else:
                    mz = z
                lam_rq[i] = np.vdot(z, az) / np.vdot(z, mz)
            lam = lam_rq

        vectors = Zh_rows[:, : cfg.n].T  # (n, nconv)
        if sym and not _dt.is_complex(cfg.dtype):
            vectors = vectors.real
        if op.perm is not None:
            # unwind the bandwidth-reduction permutation: internal row i
            # holds logical coordinate perm[i]
            unperm = np.empty_like(vectors)
            unperm[np.asarray(op.perm)] = vectors
            vectors = unperm

    return EigenResult(values=lam, vectors=vectors, nconv=nconv, info=info,
                       bounds=lam_bounds, n_iter=result.n_iter,
                       stats=result.stats)
