"""Solver statistics: the JAX equivalent of arpack-ng's ``stat.h``.

The reference keeps a ``/timing/`` Fortran common block of op counters
(``nopx, nbx, nrorth, nitref, nrstrt``) and per-phase wall-clock timers
(``tsaupd, tsaitr, titref, tgetv0, tseigt, tsgets, tsapps, tsconv, tmvopx,
tmvbx, trvec`` — stat.h:10-21), zeroed by ``dstats``/``dstatn`` and exposed
to C via ``stat_c()`` (ICB/stat_c.h:12-16).

Here the counters are an explicit pytree carried through the jitted solver
(pure-functional: no global mutable state, hence reentrant — unlike the
reference, which is documented non-thread-safe due to ``save`` variables,
SRC/dsaupd.f:451-453).  Wall-clock timers are accumulated host-side by the
driver between jitted phases.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import jax.numpy as jnp


class OpCounts(NamedTuple):
    """Device-side op counters (int32 scalars), mirroring stat.h:10-13."""

    nopx: jnp.ndarray    # number of OP*x applications
    nbx: jnp.ndarray     # number of B*x applications
    nrorth: jnp.ndarray  # number of steps that entered re-orthogonalization
    nitref: jnp.ndarray  # number of iterative-refinement passes taken
    nrstrt: jnp.ndarray  # number of invariant-subspace restarts (dgetv0 calls
    #                      from inside the Arnoldi step, SRC/dsaitr.f:397)
    nrotr: jnp.ndarray   # total basis rows WRITTEN by restart rotations —
    #                      the dsapps kev-column update (SRC/dsapps.f:445-481)
    #                      writes only the surviving rows, so this feeds the
    #                      honest rotation-traffic model in bench.py.
    #                      No reference stat.h analog (extension).
    nrorthr: jnp.ndarray  # total basis rows STREAMED by reorthogonalization
    #                      passes on the selective path (eta-subset events
    #                      read K << ncv rows) — the reorth-traffic model
    #                      input.  No reference analog (extension).

    @classmethod
    def zeros(cls) -> "OpCounts":
        z = jnp.zeros((), jnp.int32)
        return cls(z, z, z, z, z, z, z)

    def add(self, **deltas) -> "OpCounts":
        return self._replace(
            **{k: getattr(self, k) + v for k, v in deltas.items()}
        )


@dataclasses.dataclass
class Timers:
    """Host-side per-phase timers (seconds), mirroring stat.h:14-21.

    Names follow the reference's ``t*`` convention so the printed summary
    (SRC/dsaupd.f:650-680) can be reproduced verbatim.
    """

    taupd: float = 0.0   # total in the top-level iteration driver
    taitr: float = 0.0   # total in Arnoldi/Lanczos factorization extension
    teigt: float = 0.0   # total computing Ritz values of the projected matrix
    tgets: float = 0.0   # total in shift selection
    tapps: float = 0.0   # total applying implicit shifts
    tconv: float = 0.0   # total in convergence testing
    tgetv0: float = 0.0  # total generating/orthogonalizing starting vectors
    titref: float = 0.0  # total in iterative refinement (device-fused: 0)
    trvec: float = 0.0   # total computing Ritz/Schur vectors (eupd phase)
    tmvopx: float = 0.0  # total in user OP*x (device-fused paths fold this
    #                      into taitr; hybrid paths time it separately)
    tmvbx: float = 0.0   # total in user B*x

    def timed(self, name: str):
        """Context manager accumulating wall time into ``self.<name>``."""
        return _TimerCtx(self, name)


class _TimerCtx:
    def __init__(self, timers: Timers, name: str):
        self._timers, self._name = timers, name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        setattr(self._timers, self._name,
                getattr(self._timers, self._name) + dt)
        return False


@dataclasses.dataclass
class SolverStats:
    """Aggregated statistics returned to the user.

    ``iparam``-style outputs of the reference driver: ``iparam(3)`` = actual
    number of restart iterations, ``iparam(5)`` = number of converged Ritz
    values, ``iparam(9:11)`` = nopx/nbx/nrorth (SRC/dsaupd.f:616-620).
    """

    n_iter: int = 0        # restart (major) iterations taken
    n_conv: int = 0        # converged Ritz values
    nopx: int = 0
    nbx: int = 0
    nrorth: int = 0
    nitref: int = 0
    nrstrt: int = 0
    nrotr: int = 0
    nrorthr: int = 0
    timers: Timers = dataclasses.field(default_factory=Timers)

    def absorb_counts(self, counts: OpCounts) -> None:
        for f in OpCounts._fields:
            setattr(self, f, int(getattr(counts, f)))

    def summary(self) -> str:
        """Human-readable summary in the spirit of SRC/dsaupd.f:662-679."""
        t = self.timers
        lines = [
            "==========================================",
            "= Implicitly-restarted Arnoldi  (JAX)    =",
            "= Version arpack_ng_tpu                  =",
            "==========================================",
            f"Total number update iterations             = {self.n_iter}",
            f"Total number of OP*x operations            = {self.nopx}",
            f"Total number of B*x operations             = {self.nbx}",
            f"Total number of reorthogonalization steps  = {self.nrorth}",
            f"Total number of iterative refinement steps = {self.nitref}",
            f"Total number of restart steps              = {self.nrstrt}",
            f"Total time in user OP*x operation          = {t.tmvopx:.6f}",
            f"Total time in user B*x operation           = {t.tmvbx:.6f}",
            f"Total time in Arnoldi update routine       = {t.taitr:.6f}",
            f"Total time in saup2 routine                = {t.taupd:.6f}",
            f"Total time in basic Arnoldi iteration loop = {t.taitr:.6f}",
            f"Total time in reorthogonalization phase    = {t.titref:.6f}",
            f"Total time in (re)start vector generation  = {t.tgetv0:.6f}",
            f"Total time in Hessenberg eig. subproblem   = {t.teigt:.6f}",
            f"Total time in getting the shifts           = {t.tgets:.6f}",
            f"Total time in applying the shifts          = {t.tapps:.6f}",
            f"Total time in convergence testing          = {t.tconv:.6f}",
            f"Total time in computing final Ritz vectors = {t.trvec:.6f}",
        ]
        return "\n".join(lines)
