"""Implicitly-restarted Arnoldi/Lanczos driver: the dsaupd+dsaup2 /
dnaupd+dnaup2 / znaupd+znaup2 equivalent (one dtype-generic implementation).

Execution model ("hybrid"): all O(n) work — factorization extension, basis
rotation ``V <- Q^T V``, residual updates — runs as jit-compiled device
computations; the O(ncv^2..3) reduced-space subproblem (Ritz values, shift
selection, bulge-chase Q) runs replicated on the host in float64, mirroring
the PARPACK data distribution where all NCV-sized quantities are replicated
and communication-free (SRC/dsaupd.f:331-348, PARPACK/SRC/MPI/pdsaup2.f).
The restart loop itself is a host loop over jitted phases — one restart
cycle is a handful of device dispatches whose cost is dominated by the
np matvecs inside ``extend``.

The reference's reverse-communication protocol collapses into
:meth:`IRAMSolver.iterate` (one major iteration of the dsaup2 1000-loop,
SRC/dsaup2.f:400-821); :meth:`IRAMSolver.solve` is the full dsaupd loop.
``iterate``'s state is an explicit pytree, so checkpoint/resume is "stop
calling / keep calling" (reference parity: info!=0 restart protocol,
SRC/dsaupd.f:130-136).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import IRAMConfig
from ..ops.operator import Operator
from ..utils import dtypes as _dt
from ..utils.debug import debug, trace
from ..utils.hoist import hoisted_jit
from ..utils.precision import hiprec
from ..utils.stats import SolverStats, Timers
from . import reduced
from .arnoldi import (FactorizationState, make_bnorm, make_extend,
                      make_init, rotate_basis_kev, v_is_3d)


@dataclasses.dataclass
class IRAMResult:
    """Output of the iteration phase (input to extraction, cf. dseupd args)."""

    ritz: np.ndarray        # (ncv,) exit-ordered Ritz values (conv. first)
    bounds: np.ndarray      # (ncv,) matching Ritz estimates
    nconv: int              # iparam(5)
    info: int               # dsaupd info code (0, 1=maxiter, 2=no shifts,
    #                         <0 errors; SRC/dsaupd.f:247-276)
    n_iter: int             # iparam(3)
    state: FactorizationState
    stats: SolverStats


class IRAMSolver:
    """One solver instance per (operator, config): compiles its device
    phases once and can run many solves (reentrant, unlike the reference)."""

    def __init__(self, op: Operator, cfg: IRAMConfig,
                 shift_fn: Optional[Callable] = None, mesh=None):
        if op.n != cfg.n:
            raise ValueError("operator/config dimension mismatch")
        if op.bmat != cfg.bmat:
            raise ValueError("operator/config bmat mismatch")
        self.op = op
        self.cfg = cfg
        self.mesh = mesh
        self.shift_fn = shift_fn  # ido=3 analog (iparam(1)=0 user shifts)
        if not cfg.exact_shifts and shift_fn is None:
            raise ValueError("exact_shifts=False requires a shift_fn")
        self._complex = _dt.is_complex(cfg.dtype)
        self._host_dtype = np.complex128 if self._complex else np.float64
        self._rdt = _dt.real_dtype(cfg.dtype)

        init = make_init(op, cfg, v3d=v_is_3d(cfg, mesh))
        extend = make_extend(op, cfg)
        if mesh is None:
            # hoisted_jit keeps operator data (dense/DIA/banded/ILU
            # arrays) out of the lowered module (utils/hoist.py)
            self._init_rand = hoisted_jit(lambda key: init(key, None))
            self._init_v0 = hoisted_jit(init)
            self._extend = hoisted_jit(extend, donate_argnums=(0,))
            self._tail = hoisted_jit(self._cycle_tail,
                                     donate_argnums=(0,))
        else:
            # Distributed solve: PARPACK-style row partition (see
            # parallel/sharding.py).  The exact same traced code runs;
            # sharding annotations make XLA insert the allreduces at the
            # reference's MPI call sites.
            from ..parallel.sharding import replicated, state_shardings
            st_sh = state_shardings(mesh, v3d=v_is_3d(cfg, mesh))
            rep = replicated(mesh)
            if cfg.n_pad % mesh.devices.size != 0:
                raise ValueError(
                    f"n_pad={cfg.n_pad} must be divisible by the mesh size "
                    f"{mesh.devices.size}")
            self._init_rand = jax.jit(lambda key: init(key, None),
                                      in_shardings=(rep,),
                                      out_shardings=st_sh)
            self._init_v0 = jax.jit(
                init, in_shardings=(rep, st_sh.resid),
                out_shardings=st_sh)
            self._extend = jax.jit(extend, donate_argnums=(0,),
                                   in_shardings=(st_sh, rep),
                                   out_shardings=st_sh)
            self._tail = jax.jit(
                self._cycle_tail, donate_argnums=(0,),
                in_shardings=(st_sh, rep, rep, rep, rep, rep),
                out_shardings=st_sh)

    # -- device phase: rotate basis + update residual after shifts ---------

    @hiprec
    def _cycle_tail(self, state: FactorizationState, Q, H_new, sigmak,
                    betak, kev) -> FactorizationState:
        """Device part of dsapps/dnapps + the end-of-cycle residual norm
        (SRC/dsapps.f:452-501, SRC/dsaup2.f:764-808): V <- Q^T V,
        r <- sigmak*r + betak*(V Q)_{kev+1}, then rnorm = ||r||_B."""
        op = self.op
        # dsapps-parity kev-row update: only rows 0..kev of Q^T V survive
        # the restart (SRC/dsapps.f:445-481); layout-generic GEMM
        VQ, v_next, rots = rotate_basis_kev(Q, state.V, kev,
                                            self.cfg.dtype)
        v_next = v_next.reshape(-1).astype(self.cfg.dtype)
        resid = sigmak * state.resid + betak * v_next
        if op.bmat == "G":
            b_resid = op.b_apply(resid)
            counts = state.counts.add(nbx=jnp.int32(1), nrotr=rots)
        else:
            b_resid = resid
            counts = state.counts.add(nrotr=rots)
        rnorm = make_bnorm(op, self.cfg)(resid, b_resid).astype(self._rdt)
        return state._replace(V=VQ, H=H_new, resid=resid, b_resid=b_resid,
                              rnorm=rnorm, k=kev, nev_cur=kev,
                              iter=state.iter + 1, counts=counts)



    # -- lifecycle ---------------------------------------------------------

    def init_state(self, key=None, v0=None) -> FactorizationState:
        if key is None:
            key = jax.random.key(self.cfg.seed)
        if v0 is None:
            return self._init_rand(key)
        v0 = np.asarray(v0)
        if getattr(self.op, "perm", None) is not None \
                and v0.shape[0] == self.cfg.n:
            v0 = v0[np.asarray(self.op.perm)]
        if v0.shape[0] == self.cfg.n and self.cfg.n_pad != self.cfg.n:
            v0p = np.zeros((self.cfg.n_pad,), v0.dtype)
            v0p[: self.cfg.n] = v0
            v0 = v0p
        return self._init_v0(key, jnp.asarray(v0, self.cfg.dtype))

    # -- one major iteration (dsaup2 1000-loop body) -----------------------

    def iterate(self, state: FactorizationState, timers: Timers
                ) -> Tuple[FactorizationState, Optional[IRAMResult]]:
        cfg = self.cfg
        kplusp, nev0 = cfg.ncv, cfg.nev
        np0 = kplusp - nev0
        sym = cfg.symmetric
        tol = cfg.tol_effective
        eps23 = cfg.eps23
        eps_m = _dt.eps(np.float64)      # host reduced space is float64
        smlnum = _dt.safmin(np.float64) * (kplusp / eps_m)

        # ---- extend the factorization to kplusp steps (dsaitr) ----
        with timers.timed("taitr"):
            state = self._extend(state, jnp.int32(kplusp))
            # ONE host<->device round trip per cycle: everything the host
            # reduced space needs comes back in a single batched transfer
            # (each separate readback is a host<->device round trip).
            iter_h, info_h, H_h, rnorm_h = jax.device_get(
                (state.iter, state.info, state.H, state.rnorm))
        cur_iter = int(iter_h) + 1
        info = int(info_h)
        if info < 0:
            return state, self._make_result(state, np.zeros(kplusp),
                                            np.zeros(kplusp), 0, info,
                                            cur_iter)
        if info > 0:
            # could not build a kplusp-step factorization even after random
            # restarts: reference maps this to -9999 (SRC/dsaup2.f:434-443).
            return state, self._make_result(state, np.zeros(kplusp),
                                            np.zeros(kplusp), 0, -9999,
                                            cur_iter)

        H = np.asarray(H_h).astype(self._host_dtype)
        rnorm = float(rnorm_h)

        # ---- Ritz values + bounds of the projected matrix (dseigt/dneigh)
        with timers.timed("teigt"):
            if sym:
                alpha = np.diag(H).real.copy()
                beta = np.zeros(kplusp)
                if kplusp > 1:
                    beta[: kplusp - 1] = np.diag(H, -1).real
                ritz, bounds, _ = reduced.sym_eigt(
                    alpha, beta[: kplusp - 1], rnorm, need_vectors=False)
            else:
                ritz, bounds, _ = reduced.nonsym_eigt(H, rnorm)
        trace(debug.maup2, 1, "_aup2: eigenvalues of H", ritz)

        # ---- shift selection over (nev0, np0) (dsgets/dngets) ----
        nev, np_ = nev0, np0
        real_pairs = (not sym) and (not self._complex)
        with timers.timed("tgets"):
            if sym:
                r_s, b_s, shifts = reduced.sym_gets(cfg.which, nev, np_,
                                                    ritz, bounds)
            else:
                nev, np_, r_s, b_s, shifts = reduced.nonsym_gets(
                    cfg.which, nev, np_, ritz, bounds, real_pairs)

        # ---- convergence test on the nev0 wanted values (dsconv/dnconv)
        with timers.timed("tconv"):
            nconv = reduced.conv_count(r_s[kplusp - nev0:],
                                       b_s[kplusp - nev0:], tol, eps23)
        trace(debug.maup2, 0,
              f"_aup2: iter {cur_iter}: nconv={nconv}, rnorm={rnorm:.3e}")

        # ---- unremovable (zero-bound) unwanted values (dsaup2.f:500-516)
        nz = int(np.count_nonzero(b_s[:np_] == 0.0))
        np_ -= nz
        nev += nz

        # ---- exit test (dsaup2.f:519-667) ----
        if (nconv >= nev0) or (cur_iter >= cfg.max_iter) or (np_ == 0):
            r_x, b_x = reduced.exit_sort(cfg.which, nev0, nconv, r_s.copy(),
                                         b_s.copy(), eps23, sym, real_pairs)
            info = 0
            if cur_iter >= cfg.max_iter and nconv < nev0:
                info = 1
            if np_ == 0 and nconv < nev0:
                info = 2
            return state, self._make_result(state, r_x, b_x, nconv, info,
                                            cur_iter)

        # ---- stagnation guard: inflate nev (dsaup2.f:673-693) ----
        if nconv < nev0 and cfg.exact_shifts:
            nevbef = nev
            nev = nev + min(nconv, np_ // 2)
            if nev == 1 and kplusp >= 6:
                nev = kplusp // 2
            elif nev == 1 and kplusp > 3:
                nev = 2
            np_ = kplusp - nev
            if nevbef < nev:
                with timers.timed("tgets"):
                    if sym:
                        r_s, b_s, shifts = reduced.sym_gets(
                            cfg.which, nev, np_, ritz, bounds)
                    else:
                        nev, np_, r_s, b_s, shifts = reduced.nonsym_gets(
                            cfg.which, nev, np_, ritz, bounds, real_pairs)

        if not cfg.exact_shifts:
            # ido=3 analog: caller supplies the shifts (iparam(1)=0;
            # SRC/dsaup2.f:700-724).
            shifts = np.asarray(
                self.shift_fn(r_s[:np_].copy(), b_s[:np_].copy()))
            if shifts.shape[0] != np_:
                shifts = shifts[:np_]
        trace(debug.mgets, 2, "_aup2: shifts selected", shifts[:np_])

        # ---- implicit-shift QR: host computes Q (dsapps/dnapps) ----
        with timers.timed("tapps"):
            if sym:
                alpha2, beta2, Q = reduced.sym_shift_q(
                    alpha, beta[: kplusp - 1], shifts[:np_], eps_m)
                betak = float(beta2[nev - 1]) if nev < kplusp else 0.0
                H_new = (np.diag(alpha2)
                         + np.diag(beta2[: kplusp - 1], -1)
                         + np.diag(beta2[: kplusp - 1], 1))
            else:
                H_new, Q = reduced.nonsym_shift_q(H, shifts[:np_], eps_m,
                                                  smlnum, real_pairs)
                betak = H_new[nev, nev - 1] if nev < kplusp else 0.0
                # dnapps zeroes the sub-boundary entry after the update
                H_new = np.asarray(H_new)
            sigmak = Q[kplusp - 1, nev - 1]

        # ---- device tail: V <- Q^T V, residual + its B-norm ----
        with timers.timed("tapps"):
            state = self._tail(
                state,
                jnp.asarray(Q.astype(self.cfg.dtype)),
                jnp.asarray(H_new.astype(self.cfg.dtype)),
                jnp.asarray(np.array(sigmak, self._host_dtype)
                            .astype(self.cfg.dtype)),
                jnp.asarray(np.array(betak, self._host_dtype)
                            .astype(self.cfg.dtype)),
                jnp.int32(nev),
            )
        return state, None

    # -- full solve (dsaupd RCI loop equivalent) ---------------------------

    def solve(self, key=None, v0=None,
              state: Optional[FactorizationState] = None) -> IRAMResult:
        """Full solve; pass ``state`` (e.g. from io.checkpoint.load_state)
        to resume a previous run mid-factorization."""
        timers = Timers()
        with timers.timed("taupd"):
            with timers.timed("tgetv0"):
                if state is None:
                    state = self.init_state(key=key, v0=v0)
            if int(state.info) < 0:
                return self._make_result(
                    state, np.zeros(self.cfg.ncv), np.zeros(self.cfg.ncv),
                    0, int(state.info), 0, timers)
            result = None
            while result is None:
                state, result = self.iterate(state, timers)
        result.stats.timers = timers
        if debug.maupd > 0:
            print(result.stats.summary())
        return result

    # -- helpers -----------------------------------------------------------

    def _make_result(self, state, ritz, bounds, nconv, info, n_iter,
                     timers: Optional[Timers] = None) -> IRAMResult:
        stats = SolverStats(n_iter=n_iter, n_conv=nconv,
                            timers=timers or Timers())
        stats.absorb_counts(jax.device_get(state.counts))
        return IRAMResult(ritz=ritz, bounds=bounds, nconv=nconv, info=info,
                          n_iter=n_iter, state=state, stats=stats)
