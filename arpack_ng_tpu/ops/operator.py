"""Operator callables: the JAX replacement of arpack-ng's Reverse
Communication Interface (RCI).

The reference never sees the matrix: ``dsaupd`` returns with ``ido`` flags
asking the caller to compute ``y = OP*x`` (ido=1/-1) or ``y = B*x`` (ido=2)
into a shared workspace (SRC/dsaupd.f:68-97, DOCUMENTS/ex-sym.doc:10-24).
Here the inversion of control is replaced by JAX-traceable callables packed
into an :class:`Operator`; the solver jit-traces them directly into its
device computation — no host round-trip per matvec.

Contract (mirrors the information flow of the RCI work arrays):

* ``apply(v, bv) -> (w, bw)`` with ``w = OP @ v`` and ``bw = B @ w``.
  ``bv = B @ v`` is made available exactly like the reference provides
  ``ipntr(3)`` to shift-invert drivers so ``OP*x = inv(A-sigma*M)*(B*x)``
  can reuse it (SRC/dsaupd.f:208-213).  For ``bmat='I'`` implementations
  must return ``bw = w``.  For mode 2 (``OP = inv(M)*A``) implementations
  return ``bw = A@v`` so that ``<w, bw>`` is the inv(M)-norm of ``A v``,
  reproducing the reference's mode-2 shortcut (SRC/dsaitr.f:504-548).
* ``b_apply(v) -> B @ v`` (identity for ``bmat='I'``).
* ``a_apply``/``m_apply``: the *raw* problem matvecs, used for residual
  verification and Rayleigh-quotient eigenvalue recovery — the analog of the
  independent matvec the reference examples use to check
  ``||A x - lambda B x||`` (PARPACK/EXAMPLES/MPI/pdsdrv1.f:350-352).

Padding: operators act on a padded dimension ``n_pad >= n`` (a multiple
of 128, the basis row width).  Implementations must map zero padding to zero padding so the
Krylov space never leaves the embedded subspace; the solver guarantees every
vector it injects (start/restart vectors) is zero on the pad.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Operator:
    """A spectral-transformed operator pair (OP, B) plus raw problem matvecs."""

    n: int                          # logical dimension
    dtype: np.dtype                 # vector dtype
    apply: Callable                 # (v, bv) -> (w, bw)
    bmat: str = "I"                 # 'I' or 'G'
    mode: int = 1                   # ARPACK iparam(7)
    b_apply: Optional[Callable] = None   # v -> B v ; None => identity
    a_apply: Optional[Callable] = None   # raw A matvec (verification)
    m_apply: Optional[Callable] = None   # raw M matvec (verification)
    n_pad: int = 0                  # padded dimension (0 => n)
    sigma: complex = 0.0            # spectral-transform shift (modes 3-5)
    hermitian: bool = False         # A (and M) hermitian/symmetric
    perm: object = None             # optional bandwidth-reduction row
    #   permutation (np.ndarray): the operator acts on PERMUTED
    #   coordinates (internal i holds logical perm[i]); the solver
    #   permutes v0 in and un-permutes eigenvectors out, so users see
    #   logical coordinates throughout.
    format: Optional[str] = None    # execution structure chosen by the
    #   sparse importer ('dense'/'dia'/'ell'/'hyb'/'coo'); None for
    #   user-built operators.
    apply_block: Optional[Callable] = None  # optional batched raw matvec
    #   (B, n_pad) -> (B, n_pad) for block solvers: vmap of a
    #   shifted-slice DIA matvec lowers .at[].add updates to scatters;
    #   a block-native form keeps static slices and reads operator data
    #   once per block.

    def __post_init__(self):
        if self.n_pad == 0:
            object.__setattr__(self, "n_pad", self.n)
        if self.b_apply is None:
            object.__setattr__(self, "b_apply", lambda v: v)
        object.__setattr__(self, "dtype", np.dtype(self.dtype))

    # -- convenience ------------------------------------------------------

    def matvec(self, v):
        """Raw ``A @ v`` on logical-length vectors (host-friendly helper)."""
        if self.a_apply is None:
            raise ValueError("operator has no raw a_apply")
        vp = jnp.zeros((self.n_pad,), self.dtype).at[: self.n].set(
            jnp.asarray(v, self.dtype))
        return np.asarray(self.a_apply(vp))[: self.n]


def _pad_mat(a: np.ndarray, n_pad: int) -> np.ndarray:
    n = a.shape[0]
    if n_pad == n:
        return a
    out = np.zeros((n_pad, n_pad), a.dtype)
    out[:n, :n] = a
    return out


def from_dense(
    a,
    m=None,
    *,
    n_pad: int = 0,
    hermitian: bool = False,
) -> Operator:
    """Standard (or generalized mode-2) operator from dense matrices.

    ``m is None``: mode 1, ``OP = A``, ``B = I`` (EXAMPLES/SIMPLE drivers).
    ``m`` given:   mode 2, ``OP = inv(M) A``, ``B = M`` (dsdrv3-class).
    Dense matvec is one matrix-vector product.
    """
    a = np.asarray(a)
    n = a.shape[0]
    n_pad = n_pad or n
    dtype = a.dtype
    a_dev = jnp.asarray(_pad_mat(a, n_pad))

    if m is None:
        def apply(v, bv, _a=a_dev):
            w = _a @ v
            return w, w

        return Operator(n=n, dtype=dtype, apply=apply, bmat="I", mode=1,
                        a_apply=lambda v: a_dev @ v, n_pad=n_pad,
                        hermitian=hermitian, format="dense")

    m = np.asarray(m)
    # Factor M once on host (reference dsdrv3 uses LAPACK pttrf/pttrs for the
    # mass matrix; here a dense Cholesky/LU via numpy, applied on device as
    # two triangular solves folded into explicit inverse application).
    import scipy.linalg as sla
    lu, piv = sla.lu_factor(_pad_mat_identity(m, n_pad))
    minv = sla.lu_solve((lu, piv), np.eye(n_pad, dtype=m.dtype))
    minv_dev = jnp.asarray(minv.astype(dtype))
    m_dev = jnp.asarray(_pad_mat_identity(m, n_pad).astype(dtype))

    def apply(v, bv, _a=a_dev, _mi=minv_dev):
        av = _a @ v
        return _mi @ av, av      # bw = A v  (mode-2 shortcut)

    return Operator(n=n, dtype=dtype, apply=apply, bmat="G", mode=2,
                    b_apply=lambda v: m_dev @ v,
                    a_apply=lambda v: a_dev @ v,
                    m_apply=lambda v: m_dev @ v,
                    n_pad=n_pad, hermitian=hermitian)


def _pad_mat_identity(a: np.ndarray, n_pad: int) -> np.ndarray:
    """Pad with an identity block (so factorizations stay non-singular)."""
    n = a.shape[0]
    if n_pad == n:
        return a
    out = np.eye(n_pad, dtype=a.dtype)
    out[:n, :n] = a
    return out


def from_matvec(
    matvec: Callable,
    n: int,
    dtype,
    *,
    n_pad: int = 0,
    hermitian: bool = False,
) -> Operator:
    """Mode-1 standard operator from a traceable matvec closure.

    The direct analog of the user's RCI loop body for ``ido=1`` in
    EXAMPLES/SIMPLE/dssimp.f.  ``matvec`` must accept/return padded vectors
    and preserve zero padding.
    """
    def apply(v, bv):
        w = matvec(v)
        return w, w

    return Operator(n=n, dtype=np.dtype(dtype), apply=apply, bmat="I",
                    mode=1, a_apply=matvec, n_pad=n_pad or n,
                    hermitian=hermitian)


def from_diagonal(d, *, n_pad: int = 0) -> Operator:
    """Diagonal operator (the reference ICB test matrix,
    TESTS/icb_arpack_c.c:20-40 uses diag(1..1000))."""
    d = np.asarray(d)
    n = d.shape[0]
    n_pad = n_pad or n
    dd = np.zeros((n_pad,), d.dtype)
    dd[:n] = d
    d_dev = jnp.asarray(dd)

    def apply(v, bv, _d=d_dev):
        w = _d * v
        return w, w

    return Operator(n=n, dtype=d.dtype, apply=apply, bmat="I", mode=1,
                    a_apply=lambda v: d_dev * v, n_pad=n_pad,
                    hermitian=not np.iscomplexobj(d))
