"""Solver configuration: the typed replacement of arpack-ng's ``iparam``/
argument-list "config struct" (SRC/dsaupd.f:154-226).

Mapping to the reference:

===========================  =================================================
reference                    here
===========================  =================================================
``nev``                      :attr:`IRAMConfig.nev`
``ncv``                      :attr:`IRAMConfig.ncv`
``which`` (2-char string)    :attr:`IRAMConfig.which`
``bmat`` ('I'/'G')           :attr:`IRAMConfig.bmat`
``iparam(1)`` ishift         :attr:`IRAMConfig.exact_shifts`
``iparam(3)`` mxiter         :attr:`IRAMConfig.max_iter`
``iparam(4)`` nb             (always 1 in the reference; not needed)
``iparam(7)`` mode 1..5      :attr:`IRAMConfig.mode`
``tol``                      :attr:`IRAMConfig.tol`
``info!=0`` (user v0)        ``v0`` argument of the solver entry points
===========================  =================================================
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .utils import dtypes as _dt

#: Valid ``which`` selectors, symmetric problems (SRC/dsaupd.f:98-105).
SYM_WHICH = ("LA", "SA", "LM", "SM", "BE")
#: Valid ``which`` selectors, non-symmetric/complex (SRC/dnaupd.f:106-111).
NONSYM_WHICH = ("LM", "SM", "LR", "SR", "LI", "SI")


@dataclasses.dataclass(frozen=True)
class IRAMConfig:
    """Static configuration of one implicitly-restarted Arnoldi solve."""

    n: int                      # problem dimension (logical, un-padded)
    nev: int                    # number of eigenvalues wanted
    ncv: int                    # Krylov subspace dimension (nev < ncv <= n)
    which: str = "LM"
    bmat: str = "I"             # 'I' standard, 'G' generalized
    mode: int = 1               # ARPACK iparam(7): 1..5
    tol: float = 0.0            # <=0 -> machine eps of dtype (dsaupd.f:546-551)
    max_iter: int = 300         # max restart cycles (iparam(3))
    exact_shifts: bool = True   # iparam(1)=1; False -> caller supplies shifts
    symmetric: bool = False     # use Lanczos semantics (dsaupd vs dnaupd)
    dtype: np.dtype = np.dtype(np.float32)
    n_pad: int = 0              # padded dimension actually carried on device
    seed: int = 0               # PRNG seed for starting/restart vectors
    safe_norms: bool = False    # overflow-safe two-phase norms (pdnorm2
    #   analog, PARPACK/SRC/MPI/pdnorm2.f:70-80); costs one extra pass
    storage_dtype: object = None  # optional low-precision basis storage
    #   (e.g. jnp.bfloat16): V is stored narrow, every contraction
    #   accumulates in `dtype` (preferred_element_type) — halves the
    #   dominant HBM traffic of the orthogonalization at a documented
    #   accuracy cost (residual floor ~ ||A|| * eps(storage)).  A
    #   capability with no reference equivalent.
    restart: str = "implicit"   # symmetric fused-path restart scheme:
    #   'implicit' (the reference's exact-shift QR bulge chase, dsapps)
    #   or 'thick' (thick-restart Lanczos / Krylov-Schur class: keep the
    #   wanted Ritz vectors directly with the arrowhead residual
    #   coupling — mathematically equivalent to implicit restarts with
    #   exact shifts [Wu & Simon 2000], numerically exact where the f32
    #   QR chase accumulates rounding, and cheaper on device: one basis
    #   GEMM instead of an np-step scan of QR factorizations).  The fused
    #   tail re-tridiagonalizes the kept block, so the selective-reorth
    #   omega model stays valid (core/device_sym._retridiagonalize).
    reorth: str = "dgks"        # refinement-trigger policy for the Arnoldi
    #   step's iterative reorthogonalization:
    #   'dgks'      — the reference's test: refine whenever the CGS pass
    #                 shed more than a factor 0.717 of the norm
    #                 (SRC/dsaitr.f:656).  Safe but fires on most steps of
    #                 well-conditioned problems (most steps of the 2-D
    #                 Laplacian flagship) — each firing costs
    #                 two extra full passes over V on a V-bandwidth-bound
    #                 solver.
    #   'selective' — refine only when one CGS pass cannot guarantee
    #                 SEMI-orthogonality (defect <= sqrt(eps)): trigger at
    #                 rnorm <= 8*sqrt(eps)*wnorm (utils/dtypes.selective_eta).
    #                 Semi-orthogonality preserves eps-level Ritz accuracy
    #                 for Lanczos (Simon 1984); the acceptance test inside
    #                 the refinement loop keeps the reference's 0.717 rule.
    pair_rule: str = "always"   # forced follow-up reorthogonalization
    #   after a selective-reorth event (PROPACK's pairing: both carriers
    #   of the three-term recurrence must be clean before omega growth
    #   can restart from the eps floor):
    #   'always' — every triggered event forces a full follow-up event on
    #              the next step (the classical rule).
    #   'clean'  — suppress the follow-up when both carriers are already
    #              clean: the eta-subset selection left every untouched
    #              row of omega_{j+1} below eta_sub (true by
    #              construction) AND the previous carrier v_j's omega row
    #              is below eta_sub everywhere — then the -beta_j*w_{j,i}
    #              feedback term cannot re-inject a super-eta defect and
    #              the paired event buys nothing (value-checked by the
    #              tests/test_reorth.py basis-defect property test).

    def __post_init__(self):
        # Argument validation mirroring dsaupd.f:435-519 / dnaupd.f info codes.
        if self.n <= 0:
            raise ValueError("n must be positive (reference info = -1)")
        if self.nev <= 0:
            raise ValueError("nev must be positive (reference info = -2)")
        min_gap = 1 if self.symmetric else 2
        # dsaupd requires nev < ncv <= n (info=-3); dnaupd ncv-nev >= 2.
        if not (self.nev + min_gap <= self.ncv <= max(self.n, self.nev + min_gap)):
            raise ValueError(
                f"need nev+{min_gap} <= ncv <= n; got nev={self.nev}, "
                f"ncv={self.ncv}, n={self.n} (reference info = -3)")
        valid = SYM_WHICH if self.symmetric else NONSYM_WHICH
        if self.which not in valid:
            raise ValueError(
                f"which={self.which!r} invalid; must be one of {valid} "
                "(reference info = -5)")
        if self.bmat not in ("I", "G"):
            raise ValueError("bmat must be 'I' or 'G' (reference info = -6)")
        if self.max_iter <= 0:
            raise ValueError("max_iter must be positive (reference info = -4)")
        if not (1 <= self.mode <= 5):
            raise ValueError("mode must be 1..5 (reference info = -10)")
        if self.mode == 1 and self.bmat == "G":
            raise ValueError("mode 1 requires bmat='I' (reference info = -11)")
        if self.mode >= 3 and self.bmat == "I" and self.symmetric:
            # modes 3,4,5 are generalized-problem transforms for sym problems;
            # shift-invert on a standard problem is allowed (M = I) and is
            # expressed with bmat='I', mode=3 in the reference drivers too.
            pass
        # NOTE: complex + symmetric == HERMITIAN Lanczos — an extension
        # beyond the reference (which has no c/z 'saupd' and routes
        # Hermitian problems through the general complex driver at ~2x
        # cost).  The projected matrix is real tridiagonal; the whole
        # symmetric reduced-space machinery applies unchanged.
        if self.reorth not in ("dgks", "selective"):
            raise ValueError("reorth must be 'dgks' or 'selective'")
        if self.pair_rule not in ("always", "clean"):
            raise ValueError("pair_rule must be 'always' or 'clean'")
        if self.restart not in ("implicit", "thick"):
            raise ValueError("restart must be 'implicit' or 'thick'")
        if self.n_pad == 0:
            object.__setattr__(self, "n_pad", self.n)
        if self.n_pad < self.n:
            raise ValueError("n_pad must be >= n")

    @property
    def tol_effective(self) -> float:
        return self.tol if self.tol > 0 else _dt.default_tol(self.dtype)

    @property
    def eps23(self) -> float:
        return _dt.eps23(self.dtype)


def default_ncv(n: int, nev: int, symmetric: bool) -> int:
    """Reasonable default subspace size (scipy convention: min(n, max(2k+1, 20)))."""
    gap = 1 if symmetric else 2
    return int(min(n, max(2 * nev + 1, 20, nev + gap + 1)))


def pad_dim(n: int, multiple: int = 128) -> int:
    """Round ``n`` up to a multiple of ``multiple`` (128: the 3-D basis
    layout's row width, core/arnoldi.v_is_3d)."""
    return int(-(-n // multiple) * multiple)
