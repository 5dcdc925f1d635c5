"""Realification: run genuinely-complex eigenproblems through the REAL
solver paths.

A complex operator A = Ar + i*Ai acting on z = x + i*y is equivalent to
the real block operator

    M = [[Ar, -Ai],
         [Ai,  Ar]]        acting on [x; y]  (dimension 2n),

whose spectrum is spec(A) ∪ conj(spec(A)) and whose eigenvector for
eigenvalue lambda is [Re z; Im z].  This classic construction lets a
backend with no complex-arithmetic support solve complex problems with
the real non-symmetric driver; it also gives complex HERMITIAN problems
a real-SYMMETRIC route
(M is symmetric when A is Hermitian), usable with the fused symmetric
path at full speed.

Cost: 2x memory, ~2x flops vs native complex — the same constant the
complexification route pays in the other direction.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..config import pad_dim
from .operator import Operator


def realify_matvec(a_apply_c: Callable, n: int, n_pad2: int):
    """Real matvec on stacked [x; y] from a complex matvec closure."""
    def mv(u):
        z = u[:n] + 1j * u[n_pad2 // 2: n_pad2 // 2 + n]
        w = a_apply_c(z)
        out = jnp.zeros((n_pad2,), u.dtype)
        out = out.at[:n].set(w.real.astype(u.dtype))
        out = out.at[n_pad2 // 2: n_pad2 // 2 + n].set(
            w.imag.astype(u.dtype))
        return out

    return mv


def realify_dense(a: np.ndarray, *, hermitian: Optional[bool] = None
                  ) -> Operator:
    """Dense complex matrix -> real block Operator of dimension 2n."""
    a = np.asarray(a)
    if not np.iscomplexobj(a):
        raise ValueError("realify expects a complex matrix")
    n = a.shape[0]
    if hermitian is None:
        hermitian = np.allclose(a, a.conj().T, atol=1e-12)
    rdt = np.float32 if a.dtype == np.complex64 else np.float64
    half = pad_dim(n)
    n2 = 2 * half
    m = np.zeros((n2, n2), rdt)
    m[:n, :n] = a.real
    m[:n, half: half + n] = -a.imag
    m[half: half + n, :n] = a.imag
    m[half: half + n, half: half + n] = a.real
    m_dev = jnp.asarray(m)

    def apply(v, bv):
        w = m_dev @ v
        return w, w

    return Operator(n=n2, dtype=np.dtype(rdt), apply=apply, bmat="I",
                    mode=1, a_apply=lambda v: m_dev @ v, n_pad=n2,
                    hermitian=bool(hermitian))


def realify_sparse(a, *, hermitian: Optional[bool] = None) -> Operator:
    """Sparse complex matrix -> real block Operator of dimension 2n,
    routed through the structure-exploiting sparse importer.

    The realified block matrix [[Ar, -Ai], [Ai, Ar]] of a banded complex
    matrix has its nonzeros on ~3x the diagonal count (around offsets 0
    and +-half), so the DIA streaming path applies directly — complex
    sparse problems scale on real-only backends the same way real ones
    do (the dense realification is O(4 n^2) memory and caps out fast)."""
    import scipy.sparse as sp

    from .sparse import from_scipy

    if not sp.issparse(a):
        raise ValueError("realify_sparse expects a scipy sparse matrix")
    if not np.iscomplexobj(a):
        raise ValueError("realify expects a complex matrix")
    n = a.shape[0]
    if hermitian is None:
        hermitian = (abs(a - a.conj().T) > 1e-12).nnz == 0
    rdt = np.float32 if a.dtype == np.complex64 else np.float64
    half = pad_dim(n)
    ar = sp.csr_matrix(a.real.astype(rdt))
    ai = sp.csr_matrix(a.imag.astype(rdt))
    # place the blocks at [0, n) and [half, half+n) so _recover's
    # z = u[:n] + i u[half:half+n] layout matches realify_dense
    def expand(m):
        c = m.tocoo()
        return sp.csr_matrix((c.data, (c.row, c.col)),
                             shape=(half, half), dtype=rdt)

    are, aim = expand(ar), expand(ai)
    a2 = sp.bmat([[are, -aim], [aim, are]]).tocsr()
    return from_scipy(a2, hermitian=bool(hermitian), n_pad=2 * half)


def _recover(vals, vecs, a, n: int, half: int, k: int, *,
             tol: float = 0.0):
    """Map realified eigenpairs back to the complex problem, picking for
    each eigenvalue whichever of (lambda, conj(lambda)) the candidate
    vector actually satisfies.

    All gates derive from the solve's working precision (and the user
    tol, whichever is looser) instead of fixed constants:

    * ``floor`` (conjugate-copy detector): for a copy belonging to the
      conj(A) half, z = p + iq vanishes to solve accuracy (~sqrt(eps)),
      while genuine copies have ||z|| ~ 1/sqrt(2) — a >1e3 margin.
    * ``gate`` (residual acceptance): measured realified residuals sit
      at ~10*sqrt(eps) of the storage dtype (f32 ~3e-4, f64 ~1.5e-6).
    * ``dedup``: real eigenvalues of A appear TWICE in spec(M); copies
      agree to solve accuracy.  (A genuinely double eigenvalue of A
      collapses too — same behavior as any Krylov solver on a
      multiplet, documented in the test conventions.)
    """
    rdt = np.asarray(vecs).real.dtype
    eps = float(np.finfo(rdt).eps)
    floor = 10.0 * np.sqrt(eps)
    gate = max(float(tol), 10.0 * np.sqrt(eps))
    dedup = max(float(tol), 10.0 * np.sqrt(eps))
    out_vals, out_vecs = [], []
    seen = []
    for i in range(len(vals)):
        lam = complex(vals[i])
        u = vecs[:, i]
        # For M's eigenpair (lam, u=[p; q]): z = p + i q is an eigenvector
        # of A for lam, and is ~zero exactly when the pair belongs to the
        # conj(A) half of the realified spectrum — skip those copies.
        z = u[:n] + 1j * u[half: half + n]
        nrm = np.linalg.norm(z)
        if nrm < floor * max(np.linalg.norm(u), 1e-300):
            continue
        z = z / nrm
        az = a @ z
        res = np.linalg.norm(az - lam * z)
        res_conj = np.linalg.norm(az - np.conj(lam) * z)
        # keep the pair only if z is genuinely A's eigenvector for lam:
        # closer to lam than to conj(lam), and sane in absolute terms
        if res > res_conj or res > gate * max(1.0, abs(lam)):
            continue
        if any(abs(lam - s) < dedup * max(1.0, abs(lam)) for s in seen):
            continue
        seen.append(lam)
        out_vals.append(lam)
        out_vecs.append(z)
        if len(out_vals) == k:
            break
    return (np.array(out_vals),
            np.stack(out_vecs, axis=1) if out_vecs else
            np.zeros((n, 0), complex))


def eigs_realified(a, k: int = 6, *, which: str = "LM",
                   tol: float = 0.0, ncv: Optional[int] = None,
                   maxiter: Optional[int] = None, seed: int = 0,
                   hermitian: Optional[bool] = None, mesh=None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """znaupd-class solve of a complex matrix through the REAL drivers.

    Each complex eigenvalue of A surfaces in the realified spectrum with
    its conjugate partner; twice as many pairs are requested and the
    genuine ones are selected by residual.  If the conjugate copies
    crowd out genuine pairs in the which-selection (possible for
    one-sided selectors like 'LI' on an asymmetric spectrum), the
    subspace is enlarged and the solve retried until k genuine pairs are
    recovered; a :class:`UserWarning` is emitted if the full spectrum
    cannot deliver k.  Hermitian inputs route through the real-symmetric
    fused path ('LM'/'LA'/'SA' selectors).
    """
    import warnings

    from .. import api

    import scipy.sparse as sp
    if sp.issparse(a):
        n = a.shape[0]
        op = realify_sparse(a, hermitian=hermitian)
    else:
        a = np.asarray(a)
        n = a.shape[0]
        op = realify_dense(a, hermitian=hermitian)
    half = op.n_pad // 2
    kmax = op.n - 2
    k2 = min(2 * k, kmax)
    retries = 0
    while True:
        if op.hermitian:
            vals, vecs = api.eigsh(op, k=k2, which=which if which in
                                   ("LM", "LA", "SA") else "LM",
                                   tol=tol, ncv=ncv, maxiter=maxiter,
                                   seed=seed, mesh=mesh)
        else:
            vals, vecs = api.eigs(op, k=k2, which=which, tol=tol,
                                  ncv=ncv, maxiter=maxiter, seed=seed,
                                  mesh=mesh)
        out_vals, out_vecs = _recover(np.atleast_1d(vals), vecs, a, n,
                                      half, k, tol=tol)
        if len(out_vals) >= k or k2 >= kmax or retries >= 2:
            break
        # under-delivery: conj copies consumed part of the subspace —
        # widen and retry (bounded: each retry is a full re-solve)
        retries += 1
        k2 = min(2 * k2, kmax)
    if len(out_vals) < k:
        warnings.warn(
            f"eigs_realified recovered {len(out_vals)} of {k} requested "
            "pairs even at the maximum subspace size; the conjugate-copy "
            "filter rejected the rest (check `which` vs the spectrum's "
            "symmetry, or raise tol)", stacklevel=2)
    return out_vals, out_vecs
