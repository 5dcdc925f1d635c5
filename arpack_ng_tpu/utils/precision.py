"""Matmul-precision pinning for the solver's traced computations.

XLA may evaluate a float32 contraction at reduced input precision (on an
NVIDIA GPU the default lets a float32 product run in TF32, which keeps
about 10 mantissa bits).  Gram-Schmidt coefficient dots computed that
way are wrong at ~2^-11 relative — orders of magnitude above the f32
rounding model every (semi-)orthogonality argument assumes.  The symptom
is GHOST Ritz values a few percent above the spectrum that pass their
own residual bound (the basis is no longer orthonormal, so H stops being
a projection): on the 2-D Laplacian flagship, lambda_max estimates above
the true bound of 8.

Fix: every solver-critical traced function is built under
``jax.default_matmul_precision('highest')`` — the contractions involved
are all bandwidth-bound (GEMV-shaped CGS passes, (ncv, ncv) reduced
ops, one rotation GEMM per restart), so full-precision arithmetic costs
no wall-clock time on a memory-bound solver.  User operators keep the
precision the user traced them with (the context only wraps library
code paths; anything the operator closure does inherits it during the
library trace, matching how the reference links against full-precision
BLAS).  ``chip_smoke.py`` checks for ghost values on the GPU.
"""
from __future__ import annotations

import functools

import jax

#: matmul precision for solver contractions
LEVEL = "highest"


def hiprec(fn):
    """Wrap a (traceable) callable so its body traces under
    ``jax.default_matmul_precision(LEVEL)``."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision(LEVEL):
            return fn(*args, **kwargs)

    return wrapped
