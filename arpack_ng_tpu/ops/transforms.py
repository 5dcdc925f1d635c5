"""Spectral transformations: builders for the OP/B operator pairs of the
reference's modes 1-5 (SRC/dsaupd.f:30-48 for symmetric; SRC/dnaupd.f:20-36
non-symmetric; SRC/znaupd.f:20-27 complex).

==== symmetric (dsaupd) ====
mode 1: OP = A,                     B = I   (dsdrv1)
mode 2: OP = inv(M)*A,              B = M   (dsdrv3)
mode 3: OP = inv(A - sigma*M)*M,    B = M   (shift-invert, dsdrv2/dsdrv4)
mode 4: OP = inv(A - sigma*M)*A,    B = A   (buckling, dsdrv5 — here A=K)
mode 5: OP = inv(A - sigma*M)*(A + sigma*M), B = M  (Cayley, dsdrv6)

==== non-symmetric (dnaupd) ====
mode 1/2 as above;
mode 3: OP = Re [ inv(A - sigma*M)*M ],  B = M  (dndrv4/5)
mode 4: OP = Im [ inv(A - sigma*M)*M ],  B = M  (dndrv6)
(For real sigma mode 3 is real arithmetic throughout; complex dtypes use
znaupd mode 3: OP = inv(A - sigma*M)*M.)

The linear solves the reference obtains from LAPACK band/tridiagonal
factorizations (e.g. dgttrf/dgttrs in dsdrv2, EXAMPLES/SYM/dsdrv2.f) or
from Eigen's direct/iterative solvers (arpackSolver.hpp + arpackmm's
``--slv LU/QR/LLT/LDLT/CG/BiCG`` menu, arpackmm.cpp:445-476) are provided
here in three flavors:

* dense direct: host LU factorization once, applied on device as an
  explicit-inverse GEMM — the matmul-shaped way to apply a precomputed
  dense solve (one matmul per application, no triangular-solve latency);
* user-supplied ``solve`` callable (traceable) — the fully general path;
* device iterative Krylov solves (CG/BiCGSTAB, see ops/solvers.py) for the
  matrix-free case, mirroring arpackmm's iterative mode-solver menu.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp

from ..config import pad_dim
from .operator import Operator, _pad_mat_identity, from_dense


def _dense_inv(mat: np.ndarray, n_pad: int) -> np.ndarray:
    """Host LU -> explicit inverse, identity-padded."""
    m = _pad_mat_identity(np.asarray(mat), n_pad)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lu, piv = sla.lu_factor(m)
        inv = sla.lu_solve((lu, piv), np.eye(n_pad, dtype=m.dtype))
    if not np.all(np.isfinite(inv)):
        raise ValueError(
            "A - sigma*M is numerically singular: sigma appears to be an "
            "eigenvalue; perturb the shift (reference behavior: LAPACK "
            "factorization info>0 aborts the driver)")
    return inv


def _coerce_dense(A):
    if sp.issparse(A):
        return A.toarray()
    return np.asarray(A)


def shift_invert_operator(
    n: int,
    dtype,
    solve: Callable,
    *,
    sigma: complex,
    m_apply: Optional[Callable] = None,
    a_apply: Optional[Callable] = None,
    mode: int = 3,
    n_pad: int = 0,
    hermitian: bool = False,
    bmat: Optional[str] = None,
) -> Operator:
    """General spectral-transform operator from a traceable ``solve`` with
    ``solve(b) ~= inv(A - sigma*M) b`` (M = I when ``m_apply`` is None).

    ``mode`` selects which right-hand side is fed to the solve, matching the
    table in the module docstring.  This is the operator-callable analog of
    the reference's shift-invert RCI drivers, which reuse ``ipntr(3) = B*x``
    to avoid a second M multiply (SRC/dsaupd.f:208-213).
    """
    n_pad = n_pad or n
    dtype = np.dtype(dtype)
    if bmat is None:
        bmat = "I" if m_apply is None else "G"

    if mode == 3:
        if m_apply is None:
            def apply(v, bv):
                w = solve(v)
                return w, w
        else:
            def apply(v, bv):
                w = solve(bv)          # OP v = inv(A-sigma M) (M v)
                return w, m_apply(w)
    elif mode == 4:
        if a_apply is None:
            raise ValueError("buckling mode needs a_apply")

        def apply(v, bv):
            w = solve(bv)              # bv = A v here (B = A)
            return w, a_apply(w)
    elif mode == 5:
        if a_apply is None or m_apply is None:
            raise ValueError("Cayley mode needs a_apply and m_apply")
        sig = jnp.asarray(np.array(sigma).astype(dtype))

        def apply(v, bv):
            w = solve(a_apply(v) + sig * bv)   # (A + sigma M) v
            return w, m_apply(w)
    else:
        raise ValueError(f"bad transform mode {mode}")

    b_ap = m_apply if bmat == "G" else None
    if mode == 4:
        b_ap = a_apply
    return Operator(n=n, dtype=dtype, apply=apply, bmat=bmat, mode=mode,
                    b_apply=b_ap, a_apply=a_apply, m_apply=m_apply,
                    n_pad=n_pad, sigma=sigma, hermitian=hermitian)


def build_sym_operator(A, M=None, sigma=None, mode: str = "normal",
                       dtype=None, n_pad: int = 0) -> Operator:
    """Dense/sparse convenience builder for the symmetric drivers
    (the dsdrv1-6 example family).  ``n_pad`` overrides the default
    128-lane padding (mesh-partitioned solves need n_pad divisible by
    the device count — the PARPACK nloc convention, pdsdrv1.f:178-179)."""
    if isinstance(A, Operator):
        if sigma is None and M is None:
            return A
        raise ValueError(
            "pass matrices (dense/sparse) for built-in spectral transforms, "
            "or use shift_invert_operator() with your own solve callable")
    a = _coerce_dense(A)
    if dtype is not None:
        a = a.astype(dtype)
    n = a.shape[0]
    n_pad = n_pad or pad_dim(n)
    m = _coerce_dense(M).astype(a.dtype) if M is not None else None

    if sigma is None:
        if m is None:
            return from_dense(a, n_pad=n_pad, hermitian=True)   # mode 1
        return from_dense(a, m, n_pad=n_pad, hermitian=True)    # mode 2

    sigma = float(sigma)
    mnum = {"normal": 3, "buckling": 4, "cayley": 5}[mode]
    m_eff = m if m is not None else np.eye(n, dtype=a.dtype)
    shifted = a - sigma * m_eff
    cinv = jnp.asarray(_dense_inv(shifted, n_pad).astype(a.dtype))
    a_dev = jnp.asarray(_pad_mat_identity(a, n_pad) if mnum == 4
                        else np.pad(a, ((0, n_pad - n), (0, n_pad - n))))
    solve = lambda b: cinv @ b
    a_apply = lambda v: a_dev @ v
    if m is None and mnum == 3:
        # standard shift-invert: bmat='I' (dsdrv2 class)
        return shift_invert_operator(n, a.dtype, solve, sigma=sigma,
                                     mode=3, n_pad=n_pad, hermitian=True,
                                     a_apply=a_apply)
    m_pad = np.pad(m_eff, ((0, n_pad - n), (0, n_pad - n)))
    m_dev = jnp.asarray(m_pad)
    return shift_invert_operator(
        n, a.dtype, solve, sigma=sigma, mode=mnum, n_pad=n_pad,
        hermitian=True, a_apply=a_apply, m_apply=lambda v: m_dev @ v)


def build_nonsym_operator(A, M=None, sigma=None, dtype=None,
                          part: str = "real", n_pad: int = 0) -> Operator:
    """Dense/sparse convenience builder for the non-symmetric/complex
    drivers (dndrv1-6 / zndrv1-4 families).

    ``part`` selects mode 3 (real part) vs mode 4 (imaginary part) when
    sigma is complex but the problem dtype is real (dndrv5/dndrv6).
    ``n_pad`` as in :func:`build_sym_operator`."""
    if isinstance(A, Operator):
        if sigma is None and M is None:
            return A
        raise ValueError(
            "pass matrices for built-in spectral transforms, or use "
            "shift_invert_operator() with your own solve callable")
    a = _coerce_dense(A)
    if dtype is not None:
        a = a.astype(dtype)
    n = a.shape[0]
    n_pad = n_pad or pad_dim(n)
    m = _coerce_dense(M).astype(a.dtype) if M is not None else None

    if sigma is None:
        if m is None:
            return from_dense(a, n_pad=n_pad, hermitian=False)
        return from_dense(a, m, n_pad=n_pad, hermitian=False)

    sigma = complex(sigma)
    is_cplx_prob = np.issubdtype(a.dtype, np.complexfloating)
    m_eff = m if m is not None else np.eye(n, dtype=a.dtype)
    shifted = a.astype(np.complex128) - sigma * m_eff.astype(np.complex128)
    cinv128 = _dense_inv(shifted, n_pad)
    a_dev = jnp.asarray(np.pad(a, ((0, n_pad - n), (0, n_pad - n))))
    a_apply = lambda v: a_dev @ v
    if is_cplx_prob:
        cinv = jnp.asarray(cinv128.astype(a.dtype))
        solve = lambda b: cinv @ b
        mode = 3
    else:
        # real arithmetic with complex shift: OP = Re/Im[inv(A-sigma M) M]
        # (dnaupd modes 3/4, SRC/dnaupd.f:20-36)
        if sigma.imag == 0.0:
            cinv = jnp.asarray(cinv128.real.astype(a.dtype))
            mode = 3
        else:
            partmat = cinv128.real if part == "real" else cinv128.imag
            cinv = jnp.asarray(partmat.astype(a.dtype))
            mode = 3 if part == "real" else 4
        solve = lambda b: cinv @ b

    if m is None:
        return shift_invert_operator(n, a.dtype, solve, sigma=sigma,
                                     mode=3, n_pad=n_pad, hermitian=False,
                                     a_apply=a_apply)
    m_dev = jnp.asarray(np.pad(m_eff, ((0, n_pad - n), (0, n_pad - n))))
    op = shift_invert_operator(
        n, a.dtype, solve, sigma=sigma, mode=3, n_pad=n_pad,
        hermitian=False, a_apply=a_apply, m_apply=lambda v: m_dev @ v)
    if not is_cplx_prob and sigma.imag != 0.0 and part != "real":
        op = Operator(n=n, dtype=a.dtype, apply=op.apply, bmat=op.bmat,
                      mode=4, b_apply=op.b_apply, a_apply=op.a_apply,
                      m_apply=op.m_apply, n_pad=n_pad, sigma=sigma,
                      hermitian=False)
    return op
