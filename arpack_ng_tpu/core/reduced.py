"""Host-side reduced-space (NCV-sized) subproblem kernels.

The reference keeps every NCV-sized quantity (H, Ritz values, bounds, Q)
*replicated* on all ranks and computes on them redundantly with zero
communication (SRC/dsaupd.f:331-348 "Data Distribution Note";
PARPACK/SRC/MPI/pdsaup2.f:481-517).  This framework keeps the same split:
O(n) work lives on device; the tiny dense subproblem runs here in numpy
(float64 host arithmetic regardless of device dtype — strictly more accurate
than the reference, whose single-precision drivers do this in float32).

Contents and their reference counterparts:

* :func:`sym_eigt`        — dseigt + dstqrb (tridiagonal eig + last
                            eigenvector components for the error bounds)
* :func:`nonsym_eigt`     — dneigh / cneigh-zneigh (Hessenberg eig + bounds)
* :func:`sym_gets`        — dsgets (wanted/unwanted split + exact shifts)
* :func:`nonsym_gets`     — dngets / zngets (incl. conjugate-pair keeping)
* :func:`conv_count`      — dsconv / dnconv (eps^(2/3)-floored test)
* :func:`sym_shift_q`     — dsapps (implicit-shift QR on the tridiagonal,
                            returning the accumulated orthogonal Q)
* :func:`nonsym_shift_q`  — dnapps / znapps (single real shifts, double
                            implicit shifts for conjugate pairs, complex
                            single shifts)
* :func:`exit_sort_*`     — the exit-path ordering of dsaup2.f:524-667

Shift application here computes ONLY the (ncv, ncv) orthogonal Q; the O(n)
basis update ``V <- Q^T V`` and the residual update are device GEMMs
(see core/iram.py), exactly mirroring the reference's split where
``pdsapps`` V-updates are row-local (PARPACK/SRC/MPI/pdsapps.f).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.linalg as sla

from .. import native as _native

# --------------------------------------------------------------------------
# sorts (dsortr / dsortc / zsortc)
# --------------------------------------------------------------------------


def sort_key(which: str, vals: np.ndarray, real_pairs: bool) -> np.ndarray:
    """Ascending-sort key reproducing dsortr/dsortc 'wanted last' orders.

    The caller sorts ascending by this key; for each ``which`` the *wanted*
    end of the spectrum lands in the LAST positions, matching the dsgets /
    dngets convention (SRC/dsgets.f:180-186, SRC/dngets.f:147-170).
    """
    w = which.upper()
    if w == "LM":
        return np.abs(vals)
    if w == "SM":
        return -np.abs(vals)
    if w == "LA" or w == "LR":
        return vals.real
    if w == "SA" or w == "SR":
        return -vals.real
    if w == "LI":
        return np.abs(vals.imag) if real_pairs else vals.imag
    if w == "SI":
        return -np.abs(vals.imag) if real_pairs else -vals.imag
    raise ValueError(f"bad which={which!r}")


def _stable_order(key: np.ndarray) -> np.ndarray:
    return np.argsort(key, kind="stable")


def sortc_order(which: str, vals: np.ndarray, real_pairs: bool) -> np.ndarray:
    """Permutation for the dngets two-stage sort that keeps conjugate pairs
    adjacent (SRC/dngets.f:147-170 does a pre-sort then the final sort; a
    stable lexsort with the pair key secondary achieves the same result)."""
    primary = sort_key(which, vals, real_pairs)
    if real_pairs:
        # secondary key groups each conjugate pair (equal primary keys):
        # pair members share (real, |imag|); order member with +imag first
        # like dsortc's swap convention.
        return np.lexsort((-vals.imag, primary))
    return _stable_order(primary)


# --------------------------------------------------------------------------
# Ritz values + error bounds of the projected matrix
# --------------------------------------------------------------------------


def sym_eigt(alpha: np.ndarray, beta: np.ndarray, rnorm: float,
             need_vectors: bool = True
             ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Eigenvalues of the tridiagonal T and Ritz-estimate bounds.

    dseigt (SRC/dseigt.f:155) calls dstqrb, a modified dsteqr returning all
    eigenvalues plus only the LAST component of each eigenvector
    (SRC/dstqrb.f:6-11); bounds = rnorm * |last component|.  The native
    C++ kernel (native/src/reduced.cc, atpu_stqrb_d) implements exactly
    that last-row tracking; the scipy fallback computes full eigenvectors.

    Returns (ritz ascending, bounds, S or None when need_vectors=False).
    """
    k = alpha.shape[0]
    if k == 1:
        return alpha.copy(), np.array([abs(rnorm)]), np.ones((1, 1))
    if _native.available():
        # the native QL can hit its sweep cap on pathological
        # tridiagonals (observed once on an f32 floor-tolerance H at
        # n=1M) — same class of failure dsteqr reports via info>0
        # (reference maps it to dsaupd info=-8); LAPACK's bidiagonal
        # DC solver below handles those, so fall back instead of
        # failing the solve
        try:
            if need_vectors:
                ritz, S = _native.steqr(np.asarray(alpha, np.float64),
                                        np.asarray(beta, np.float64))
                return ritz, np.abs(rnorm * S[-1, :]), S
            ritz, bounds = _native.stqrb(np.asarray(alpha, np.float64),
                                         np.asarray(beta, np.float64),
                                         rnorm)
            return ritz, bounds, None
        except RuntimeError:
            pass
    ritz, S = sla.eigh_tridiagonal(alpha, beta[: k - 1])
    bounds = np.abs(rnorm * S[-1, :])
    return ritz, bounds, (S if need_vectors else None)


def nonsym_eigt(H: np.ndarray, rnorm: float
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Eigenvalues of the Hessenberg H and Ritz-estimate bounds.

    dneigh (SRC/dneigh.f:194-213): Schur via dlahqr, eigenvectors via dtrevc,
    each normalized to 2-norm 1; bound_i = rnorm * |last component of y_i|.
    Host LAPACK geev delivers the same normalized eigenvectors directly.

    Returns (ritz complex, bounds real, Y eigenvector matrix complex).
    """
    ritz, Y = sla.eig(H)
    bounds = np.abs(rnorm) * np.abs(Y[-1, :])
    return ritz, bounds, Y


# --------------------------------------------------------------------------
# shift selection (dsgets / dngets / zngets)
# --------------------------------------------------------------------------


def sym_gets(which: str, kev: int, np_: int, ritz: np.ndarray,
             bounds: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """dsgets: order (ritz, bounds) so the kev wanted values are LAST; the
    first np_ entries are the exact shifts, re-ordered so the shifts with
    the largest bounds are applied first (forward-stability heuristic,
    SRC/dsgets.f:186-197).

    Returns (ritz_sorted, bounds_sorted, shifts).
    """
    k = kev + np_
    assert ritz.shape[0] == k
    if which == "BE":
        order = np.argsort(ritz, kind="stable")
        r, b = ritz[order], bounds[order]
        # wanted: kev//2 from the low end, kev-kev//2 from the high end —
        # dsgets.f:166-171 swaps the kevd2=kev/2 SMALLEST into the wanted
        # block next to the kev-kevd2 largest (verified against the
        # library for odd kev; the previous split here was inverted).
        # The unwanted middle block becomes the shifts.
        kevd2 = kev // 2
        lo = np.arange(0, kevd2)
        hi = np.arange(k - (kev - kevd2), k)
        mid = np.arange(kevd2, k - (kev - kevd2))
        perm = np.concatenate([mid, lo, hi])
        r, b = r[perm], b[perm]
    else:
        order = _stable_order(sort_key(which, ritz, real_pairs=False))
        r, b = ritz[order], bounds[order]
    shifts = r[:np_].copy()
    if np_ > 0:
        # largest Ritz estimates first: dsortr('SM', bounds) = decreasing
        # magnitude of bounds (SRC/dsgets.f:193-196).
        so = np.argsort(-np.abs(b[:np_]), kind="stable")
        shifts = shifts[so]
    return r, b, shifts


def nonsym_gets(which: str, kev: int, np_: int, ritz: np.ndarray,
                bounds: np.ndarray, real_pairs: bool
                ) -> Tuple[int, int, np.ndarray, np.ndarray, np.ndarray]:
    """dngets/zngets: sort so wanted are last; for real problems keep
    conjugate pairs together, growing kev by one if the boundary would split
    a pair (SRC/dngets.f:165-176).

    Returns (kev, np_, ritz_sorted, bounds_sorted, shifts).
    """
    k = kev + np_
    order = sortc_order(which, ritz, real_pairs)
    r, b = ritz[order], bounds[order]
    if real_pairs and np_ > 0 and np_ < k:
        if (r[np_ - 1] == np.conj(r[np_])) and r[np_ - 1].imag != 0:
            np_ -= 1
            kev += 1
    shifts = r[:np_].copy()
    if np_ > 0:
        # dsortc('SR', bounds, ...) : shifts with largest bounds first
        # (SRC/dngets.f:180-187).
        so = np.argsort(-b[:np_].real, kind="stable")
        shifts = shifts[so]
    return kev, np_, r, b, shifts


# --------------------------------------------------------------------------
# convergence (dsconv / dnconv)
# --------------------------------------------------------------------------


def conv_mask(ritz: np.ndarray, bounds: np.ndarray, tol: float,
              eps23: float) -> np.ndarray:
    """``bounds_i <= tol * max(eps23, |ritz_i|)`` (SRC/dsconv.f:123;
    SRC/dnconv.f:133-134 uses dlapy2 = complex magnitude, which np.abs is)."""
    return bounds <= tol * np.maximum(eps23, np.abs(ritz))


def conv_count(ritz, bounds, tol, eps23) -> int:
    return int(np.count_nonzero(conv_mask(ritz, bounds, tol, eps23)))


# --------------------------------------------------------------------------
# implicit-shift application: compute the orthogonal Q (dsapps / dnapps)
# --------------------------------------------------------------------------


def _deflate_sym(alpha: np.ndarray, beta: np.ndarray, eps_m: float) -> None:
    """Zero negligible subdiagonals: |e_i| <= eps*(|d_i|+|d_{i+1}|)
    (SRC/dsapps.f:430-443)."""
    big = np.abs(alpha[:-1]) + np.abs(alpha[1:])
    beta[np.abs(beta) <= eps_m * big] = 0.0


def sym_shift_q(alpha: np.ndarray, beta: np.ndarray, shifts: np.ndarray,
                eps_m: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Apply the np exact shifts to the tridiagonal T, accumulating Q.

    Mathematically identical to dsapps' bulge chase: for each shift mu,
    ``T - mu I = Q_mu R`` (orthogonal-triangular), ``T <- Q_mu^T T Q_mu``,
    which preserves tridiagonal form up to rounding; structure is enforced
    by re-symmetrizing and truncating to tridiagonal after each shift (the
    chase enforces the same invariant in-place, SRC/dsapps.f:226-336).
    Ends with the deflation sweep (dsapps.f:430-443) and the subdiagonal
    sign-normalization similarity (dsapps.f:396-402).

    Returns (alpha', beta', Q) with beta' >= 0.
    """
    k = alpha.shape[0]
    if _native.available():
        # native implicit Givens chase: block-aware like dsapps (exactly
        # one QR step per shift per unreduced block)
        return _native.sym_shift_q(np.asarray(alpha, np.float64),
                                   np.asarray(beta, np.float64),
                                   np.asarray(shifts, np.float64))
    T = np.diag(alpha.astype(np.float64))
    if k > 1:
        T += np.diag(beta[: k - 1].astype(np.float64), 1)
        T += np.diag(beta[: k - 1].astype(np.float64), -1)
    Q = np.eye(k)
    eye = np.eye(k)
    for mu in np.asarray(shifts, np.float64):
        q, _ = np.linalg.qr(T - mu * eye)
        T = q.T @ T @ q
        # enforce tridiagonal symmetric structure
        d = np.diag(T).copy()
        e = np.diag(T, -1).copy()
        e2 = np.diag(T, 1)
        e = 0.5 * (e + e2)
        T = np.diag(d)
        if k > 1:
            T += np.diag(e, 1) + np.diag(e, -1)
        Q = Q @ q
    d = np.diag(T).copy()
    e = np.diag(T, -1).copy() if k > 1 else np.zeros(0)
    _deflate_sym(d, e, eps_m) if k > 1 else None
    # sign-normalize: make every subdiagonal non-negative via the diagonal
    # similarity Phi = diag(phi), phi_0 = 1, phi_{i+1} = phi_i * sign(e_i).
    phi = np.ones(k)
    for i in range(k - 1):
        s = 1.0 if e[i] >= 0 else -1.0
        phi[i + 1] = phi[i] * s
        e[i] = abs(e[i])
    Q = Q * phi[None, :]
    beta_out = np.zeros_like(beta, dtype=np.float64)
    beta_out[: k - 1] = e
    return d, beta_out, Q


def _deflate_hess(H: np.ndarray, eps_m: float, smlnum: float) -> None:
    """dnapps deflation: |h(i+1,i)| <= max(ulp*(|h(i,i)|+|h(i+1,i+1)|),
    smlnum) -> zero (SRC/dnapps.f:328-336)."""
    k = H.shape[0]
    for i in range(k - 1):
        tst1 = abs(H[i, i]) + abs(H[i + 1, i + 1])
        if tst1 == 0.0:
            tst1 = np.abs(np.diag(H)).sum()
        if abs(H[i + 1, i]) <= max(eps_m * tst1, smlnum):
            H[i + 1, i] = 0.0


def _truncate_hessenberg(H: np.ndarray) -> np.ndarray:
    k = H.shape[0]
    return np.triu(H, -1)


def nonsym_shift_q(H: np.ndarray, shifts: np.ndarray, eps_m: float,
                   smlnum: float, real_arith: bool
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Apply shifts to the Hessenberg H, accumulating (unitary) Q.

    dnapps applies real shifts as single implicit QR steps and complex
    conjugate pairs as double implicit shifts, keeping all arithmetic real
    (SRC/dnapps.f); znapps applies single complex shifts (SRC/znapps.f).
    Here each is realized as an *explicit* QR of the (tiny, host-resident)
    shifted matrix — orthogonally similar to the bulge-chase result:

    * real shift mu:            QR(H - mu I)
    * conjugate pair (mu,~mu):  QR(H^2 - 2 Re(mu) H + |mu|^2 I)  [real Q]
    * complex shift (complex arithmetic): QR(H - mu I)           [unitary Q]

    Returns (H', Q).
    """
    k = H.shape[0]
    work_dtype = np.complex128 if np.iscomplexobj(H) else np.float64
    Hc = H.astype(work_dtype)
    Q = np.eye(k, dtype=work_dtype)
    eye = np.eye(k, dtype=work_dtype)

    shifts = np.asarray(shifts)
    used = np.zeros(len(shifts), dtype=bool)
    for i, mu in enumerate(shifts):
        if used[i]:
            continue
        used[i] = True
        if real_arith and mu.imag != 0.0:
            # find + consume the conjugate partner (dngets keeps pairs in
            # the shift set, SRC/dngets.f:165-176)
            partner = None
            for jj in range(i + 1, len(shifts)):
                if not used[jj] and np.isclose(shifts[jj], np.conj(mu)):
                    partner = jj
                    break
            if partner is not None:
                used[partner] = True
            M = Hc @ Hc - 2.0 * mu.real * Hc + (abs(mu) ** 2) * eye
            q, _ = np.linalg.qr(M.real.astype(np.float64))
            q = q.astype(work_dtype)
        else:
            mu_use = mu.real if (real_arith and not np.iscomplexobj(Hc)) \
                else mu
            q, _ = np.linalg.qr(Hc - mu_use * eye)
        Hc = q.conj().T @ Hc @ q
        Hc = _truncate_hessenberg(Hc)
        _deflate_hess(Hc, eps_m, smlnum)
        Q = Q @ q
    return Hc, Q


# --------------------------------------------------------------------------
# exit-path ordering (dsaup2.f:524-667 / dnaup2 analog)
# --------------------------------------------------------------------------


def exit_sort(which: str, nev0: int, nconv: int, ritz: np.ndarray,
              bounds: np.ndarray, eps23: float, symmetric: bool,
              real_pairs: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Reproduce the exit ordering of the restart loop: sort all kplusp Ritz
    values opposite-to-which (wanted first), push converged ones forward by
    the scaled-bound sort, then order the converged set by ``which``
    (SRC/dsaup2.f:536-638)."""
    k = ritz.shape[0]
    if symmetric and which == "BE":
        # decreasing sort, then swap the low end of the spectrum into the
        # wanted block: first nev0 = (nev0 - nev0//2) largest + nev0//2
        # smallest (SRC/dsaup2.f:536-556 — the dswap at :551-556; without
        # it the odd-nev0 low/high split is wrong).
        order = np.argsort(-ritz, kind="stable")
        r, b = ritz[order], bounds[order]
        nevd2 = nev0 // 2
        nevm2 = nev0 - nevd2
        np_ = k - nev0
        m = min(nevd2, np_)
        if nev0 > 1 and m > 0:
            lo_idx = np.arange(nevm2, nevm2 + m)
            hi_start = max(k - nevd2, k - np_)
            hi_idx = np.arange(hi_start, hi_start + m)
            r[lo_idx], r[hi_idx] = r[hi_idx].copy(), r[lo_idx].copy()
            b[lo_idx], b[hi_idx] = b[hi_idx].copy(), b[lo_idx].copy()
    else:
        # sort opposite to which -> wanted part lands FIRST
        key = sort_key(which, ritz, real_pairs)
        order = _stable_order(-key) if not real_pairs else \
            np.lexsort((-ritz.imag, -key))
        r, b = ritz[order], bounds[order]
    # scaled-bound stable sort over the first nev0 entries pushes converged
    # values to the front (dsaup2.f:579-607)
    nev0 = min(nev0, k)
    scale = np.maximum(eps23, np.abs(r[:nev0]))
    so = np.argsort(b[:nev0] / scale, kind="stable")
    r[:nev0], b[:nev0] = r[:nev0][so], b[:nev0][so]
    # final ordering of the converged set by which (BE: ascending)
    if nconv > 0:
        if symmetric and which == "BE":
            so2 = np.argsort(r[:nconv], kind="stable")
        else:
            so2 = _stable_order(sort_key(which, r[:nconv], real_pairs))
        r[:nconv], b[:nconv] = r[:nconv][so2], b[:nconv][so2]
    return r, b
