"""Dtype-parametric numerics helpers.

The reference (arpack-ng) quadruplicates every routine over the type prefixes
``s, d, c, z`` (e.g. ``SRC/dsaupd.f`` / ``ssaupd.f`` / ``cnaupd.f`` /
``znaupd.f``).  Here the entire framework is dtype-parametric: one
implementation covers float32/float64/complex64/complex128, with the machine
constants re-derived per dtype (reference obtains them from LAPACK ``dlamch``,
e.g. ``SRC/dsaupd.f:550``, ``SRC/dsconv.f:123``).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

#: Machine-epsilon floor exponent used in the ARPACK convergence test
#: ``bounds(i) <= tol * max(eps23, |ritz(i)|)`` (SRC/dsconv.f:64-69,123).
EPS23_POW = 2.0 / 3.0

#: The Kahan / Gragg & Reichel re-orthogonalization threshold used by the
#: DGKS iterative-refinement test in the Arnoldi step
#: (SRC/dsaitr.f:656 ``if (rnorm .gt. 0.717*wnorm) go to 100``; history in
#: SRC/version.h:3-7).  sqrt(2)/2 ~ 0.7071; ARPACK hard-codes 0.717.
DGKS_ETA = 0.717

#: Safety factor for the *selective* reorthogonalization trigger
#: (``reorth='selective'``): a single classical Gram-Schmidt pass leaves a
#: component of size ~``eps * wnorm / rnorm`` of the new basis vector in
#: span(V) (Giraud/Langou/Rozloznik analysis of CGS cancellation), so the
#: basis stays *semi-orthogonal* (defect <= sqrt(eps), which preserves
#: eps-level Ritz-value accuracy for Lanczos — Simon, Math. Comp. 1984)
#: as long as ``rnorm >= (eps/tau) * wnorm`` with ``tau = sqrt(eps) /
#: SELECTIVE_SAFETY``.  The refinement trigger is therefore
#: ``rnorm <= SELECTIVE_SAFETY * sqrt(eps) * wnorm`` — the same test shape
#: as DGKS (SRC/dsaitr.f:656) with the threshold derived from the actual
#: orthogonality requirement instead of the worst-case 0.717.
SELECTIVE_SAFETY = 6.0
# The default of 6 keeps a margin under the sqrt(eps) semi-orthogonality
# bar on the n=1M flagship: the final basis defect grows as the factor
# shrinks (at 8: 1.85e-4, at 6: 2.06e-4, at 4: 3.42e-4 — 0.8% under the
# sqrt(eps)=3.45e-4 bar, NO margin).  The defect is a property of the
# arithmetic, not of the chip; the speed side of this trade has not been
# measured on the GPU.  The knob below is a measurement hatch (read at
# import, like the other build-time hatches); values < 1 put the trigger
# ABOVE the bar and are clamped.
import os as _os

_s = _os.environ.get("ARPACK_TPU_SELECTIVE_SAFETY")
if _s:
    try:
        SELECTIVE_SAFETY = max(float(_s), 1.0)
    except ValueError:
        pass


def selective_eta(dtype) -> float:
    """Trigger threshold for selective reorthogonalization: refine when
    ``rnorm <= selective_eta * wnorm``."""
    return float(SELECTIVE_SAFETY * np.sqrt(eps(dtype)))


def real_dtype(dtype) -> np.dtype:
    """Real counterpart of a (possibly complex) dtype."""
    return np.dtype(jnp.finfo(np.dtype(dtype)).dtype)


def is_complex(dtype) -> bool:
    return np.issubdtype(np.dtype(dtype), np.complexfloating)


def eps(dtype) -> float:
    """Machine epsilon of the *real* dtype underlying ``dtype``.

    Mirrors LAPACK ``dlamch('EpsMach')`` as used at SRC/dsaupd.f:550.
    (jnp.finfo also covers the extended dtypes numpy's finfo does not,
    e.g. bfloat16 storage.)
    """
    return float(jnp.finfo(real_dtype(dtype)).eps)


def eps23(dtype) -> float:
    """``eps**(2/3)``: the relative-accuracy floor of the convergence test."""
    return float(eps(dtype) ** EPS23_POW)


def safmin(dtype) -> float:
    """Smallest safe reciprocal-able number (LAPACK ``dlamch('S')``)."""
    return float(np.finfo(real_dtype(dtype)).tiny)


def default_tol(dtype) -> float:
    """Default convergence tolerance: machine eps (SRC/dsaupd.f:546-551)."""
    return eps(dtype)
