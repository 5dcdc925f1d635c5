"""Fully device-fused symmetric restart cycle — the flagship path.

The hybrid driver (core/iram.py) mirrors the reference's host/device split:
tiny reduced-space work on host, O(n) on device.  That costs several
host<->device round trips per restart cycle.  This module fuses the ENTIRE
major iteration of dsaup2 — factorization extension (dsaitr), tridiagonal
eigensolve (dseigt via jnp.linalg.eigh), shift selection (dsgets),
convergence count (dsconv), implicit-shift QR with accumulated Q (dsapps),
basis rotation and residual update — into ONE jit-compiled XLA computation.
The host loop reads back a single scalar (`done`) per cycle.

Reduced-space numerics on device (vs the host float64 path):

* dseigt: ``jnp.linalg.eigh`` of the dense-ified tridiagonal T (ncv tiny);
  bounds = rnorm * |last eigenvector components| (SRC/dseigt.f:155).
* dsgets: `which`-keyed sort with the wanted nev in the LAST positions
  (SRC/dsgets.f:180-186); shifts = leading np entries re-ordered largest
  Ritz-estimate first (dsgets.f:193-196).  'BE' uses an index-arithmetic
  [middle, low, high] arrangement over the ascending order (low share =
  nev//2, high share = nev - nev//2, the dsgets.f:166-171 swap
  convention), re-derived with the inflated nev before the chase.
* dsapps: per-shift explicit QR of (T - mu I) — orthogonally identical to
  the bulge chase — as a ``lax.scan`` of ``jnp.linalg.qr`` over a
  static-length masked shift list; tridiagonal truncation after each
  shift, deflation sweep (dsapps.f:430-443) and subdiagonal
  sign-normalization (dsapps.f:396-402) at the end.
* dynamic nev inflation (dsaup2.f:673-693) and zero-bound shift removal
  (dsaup2.f:500-516) are computed with masks; all shapes stay static.

Exit protocol: the cycle takes ``is_last``; when the convergence/exit test
fires (or on the final allowed iteration) the shift application is skipped
so the state keeps the full kplusp factorization, exactly like dsaup2
exits before dsapps — extraction then proceeds identically to the hybrid
path.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import IRAMConfig
from ..ops.operator import Operator
from ..utils import dtypes as _dt
from ..utils.debug import debug, device_trace
from ..utils.hoist import hoisted_jit
from ..utils.precision import hiprec
from ..utils.stats import SolverStats, Timers
from . import reduced
from .arnoldi import (FactorizationState, make_bnorm, make_extend,
                      make_init, rotate_basis_kev, v_is_3d)
from .iram import IRAMResult


def _which_key(which: str, vals):
    """Device sort key: ascending order puts the WANTED nev last
    (dsortr convention as used by dsgets)."""
    if which == "LA":
        return vals
    if which == "SA":
        return -vals
    if which == "LM":
        return jnp.abs(vals)
    if which == "SM":
        return -jnp.abs(vals)
    raise ValueError(f"device path does not support which={which!r}")


class CycleOut(NamedTuple):
    state: FactorizationState
    done: jax.Array      # bool: exit condition fired (excl. maxiter)
    nconv: jax.Array     # int32
    ritz_s: jax.Array    # (ncv,) which-sorted Ritz values (wanted last)
    bounds_s: jax.Array  # (ncv,) matching bounds


class HeadOut(NamedTuple):
    """Everything the restart tail needs from the first half of a cycle
    (extend + dseigt + dsgets + dsconv + nev inflation) — the boundary at
    which the reference returns to the caller with ido=3 for user shifts
    (SRC/dsaup2.f:700-724)."""

    state: FactorizationState
    T: jax.Array         # (ncv, ncv) densified projected matrix
    evals: jax.Array     # ascending eigenvalues of T
    S: jax.Array         # eigenvectors of T (columns, matching evals)
    r_s: jax.Array       # which-sorted Ritz values, nev0 arrangement
    b_s: jax.Array       # matching bounds
    r_si: jax.Array      # which-sorted with the INFLATED nev (differs from
    b_si: jax.Array      #   r_s/b_s only for which='BE', dsaup2.f:690-693)
    nconv: jax.Array     # int32
    done: jax.Array      # bool
    nev_eff: jax.Array   # int32, after zero-bound removal + inflation
    np_eff: jax.Array    # int32 = ncv - nev_eff


def make_sym_head(op: Operator, cfg: IRAMConfig, inflate: bool = True):
    """Build the jitted cycle head: ``head(state) -> HeadOut``.

    Covers dsaup2's extension through shift-count fixing: dsaitr
    (:368,423), dseigt (:458), dsgets (:485), dsconv (:492), zero-bound
    shift removal (:500-516) and the stagnation nev inflation (:673-693).
    ``inflate=False`` skips the inflation, matching the reference's
    ishift=0 behavior (the guard ``nconv < nev .and. ishift == 1`` at
    dsaup2.f:673 — user-shift solves never inflate nev).
    """
    if not cfg.symmetric:
        raise ValueError("fused cycle is for symmetric/Hermitian problems")
    ncv, nev0 = cfg.ncv, cfg.nev
    np0 = ncv - nev0
    thick = cfg.restart == "thick"
    if thick and cfg.which == "BE":
        raise ValueError("restart='thick' does not support which='BE'; "
                         "use the implicit restart")
    rdt = _dt.real_dtype(cfg.dtype)
    tol = jnp.asarray(cfg.tol_effective, rdt)
    eps23 = jnp.asarray(cfg.eps23, rdt)
    extend = make_extend(op, cfg)
    iota = jnp.arange(ncv)
    be_arrange = _make_be_arrange(ncv) if cfg.which == "BE" else None

    def head(state: FactorizationState) -> HeadOut:
        state = extend(state, jnp.int32(ncv))

        # ---- dseigt: Ritz values + bounds of the projected matrix ----
        if thick:
            # thick-restart factorizations carry an arrowhead block:
            # use the full upper triangle (the computed CGS projections;
            # the lower subdiagonal holds Lanczos-convention beta writes
            # that do not apply across a thick restart boundary)
            Hf = state.H.real.astype(rdt)
            T = jnp.triu(Hf) + jnp.triu(Hf, 1).T
        else:
            d = jnp.diag(state.H).real.astype(rdt)
            e = jnp.diag(state.H, -1).real.astype(rdt)
            T = (jnp.diag(d) + jnp.diag(e, 1) + jnp.diag(e, -1))
        evals, S = jnp.linalg.eigh(T)
        bounds = jnp.abs(state.rnorm * S[ncv - 1, :]).astype(rdt)

        # ---- dsgets: wanted last ----
        if cfg.which == "BE":
            # 'BE' splits both ends (SRC/dsgets.f:154-171): ascending
            # sort, then [unwanted middle, low half, high half] — the
            # split depends on nev, so the permutation is index
            # arithmetic over the ascending order (re-derived with the
            # inflated nev below)
            order_a = jnp.argsort(evals)
            r_a, b_a = evals[order_a], bounds[order_a]
            r_s = be_arrange(r_a, jnp.int32(nev0))
            b_s = be_arrange(b_a, jnp.int32(nev0))
        else:
            order = jnp.argsort(_which_key(cfg.which, evals))
            r_s, b_s = evals[order], bounds[order]

        # ---- dsconv over the nev0 wanted ----
        wanted, wb = r_s[np0:], b_s[np0:]
        nconv = jnp.sum(
            wb <= tol * jnp.maximum(eps23, jnp.abs(wanted))
        ).astype(jnp.int32)

        # ---- zero-bound unwanted (cannot be shifted away) ----
        nz = jnp.sum(b_s[:np0] == 0).astype(jnp.int32)
        np_eff = jnp.int32(np0) - nz
        nev_eff = jnp.int32(nev0) + nz

        done = (nconv >= nev0) | (np_eff == 0)

        # msaup2-gated per-cycle dumps (SRC/dsaup2.f:404-413, :494-504)
        device_trace(debug.maup2, 0,
                     "_sym_cycle: iter {i}: nconv={nc} rnorm={rn}",
                     i=state.iter, nc=nconv, rn=state.rnorm)
        device_trace(debug.maup2, 1,
                     "_sym_cycle: ritz (wanted last) {r}\n"
                     "_sym_cycle: bounds {b}", r=r_s, b=b_s)
        device_trace(debug.meigt, 0,
                     "_sym_cycle: eigenvalues of T {e}", e=evals)

        if inflate:
            # ---- stagnation guard: nev inflation (dsaup2.f:673-693) ----
            nev_inf = nev_eff + jnp.minimum(nconv, np_eff // 2)
            nev_inf = jnp.where((nev_inf == 1) & (ncv >= 6), ncv // 2,
                                jnp.where((nev_inf == 1) & (ncv > 3), 2,
                                          nev_inf))
            nev_eff = jnp.minimum(nev_inf, ncv - 1)
            np_eff = jnp.int32(ncv) - nev_eff

        if cfg.which == "BE":
            # the BE split moves with the inflated nev: re-derive the
            # [middle, low, high] arrangement (the reference re-calls
            # dsgets after inflation, SRC/dsaup2.f:690-693)
            r_si = be_arrange(r_a, nev_eff)
            b_si = be_arrange(b_a, nev_eff)
        else:
            r_si, b_si = r_s, b_s

        return HeadOut(state=state, T=T, evals=evals, S=S, r_s=r_s,
                       b_s=b_s, r_si=r_si, b_si=b_si, nconv=nconv,
                       done=done, nev_eff=nev_eff, np_eff=np_eff)

    return hiprec(head)


def _make_be_arrange(ncv: int):
    """Index-arithmetic 'BE' arrangement over the ascending order:
    [unwanted middle, low half, high half]; low-end share is kev//2,
    high-end share kev - kev//2 (dsgets.f:166-171 convention; see
    reduced.sym_gets)."""
    iota = jnp.arange(ncv)

    def be_arrange(vals_a, nev):
        lo = nev // 2
        hi = nev - lo
        np_ = jnp.int32(ncv) - nev
        src = jnp.where(
            iota < np_, lo + iota,
            jnp.where(iota < np_ + lo, iota - np_,
                      (jnp.int32(ncv) - hi) + (iota - np_ - lo)))
        return vals_a[src]

    return be_arrange


def make_sym_tail(op: Operator, cfg: IRAMConfig, user_shifts: bool = False):
    """Build the jitted restart tail: ``tail(h, is_last[, shifts])``.

    The exact-shift tail (dsapps with shifts from dsgets) or — with
    ``user_shifts`` — the ido=3 protocol tail applying a caller-supplied
    length-np0 shift table, of which the leading np_eff entries are used
    (SRC/dsaup2.f:700-724: the reference asks for exactly np shifts).
    ``restart='thick'`` has no shift concept, so ``user_shifts`` requires
    the implicit restart.
    """
    ncv, nev0 = cfg.ncv, cfg.nev
    np0 = ncv - nev0
    thick = cfg.restart == "thick"
    if thick and user_shifts:
        raise ValueError("user shifts require restart='implicit' "
                         "(a thick restart applies no shifts)")
    rdt = _dt.real_dtype(cfg.dtype)
    eps_m = jnp.asarray(_dt.eps(cfg.dtype), rdt)
    is_g = op.bmat == "G"
    iota = jnp.arange(ncv)
    bnorm = make_bnorm(op, cfg)

    def apply_shifts(args):
        state, T, r_si, b_si, nev_eff, np_eff, ushifts = args
        active0 = iota < np_eff
        if user_shifts:
            # caller-supplied shifts, applied in the given order
            # (the reference does not re-order user shifts)
            shifts = ushifts
            active = active0[:np0]
        else:
            # exact shifts: the np_eff LEAST-WANTED values (leading
            # positions of the which-order — the positional exclusion of
            # dsaup2.f:516-521, which drops the trailing entries when
            # zero-bound values shrink np), re-ordered largest Ritz
            # estimate first for application; masked-out slots get +inf
            # key and are skipped in the chase.
            skey = jnp.where(active0[:np0], -jnp.abs(b_si[:np0]),
                             jnp.asarray(jnp.inf, rdt))
            sperm = jnp.argsort(skey)
            shifts = r_si[:np0][sperm]
            active = active0[:np0]  # after sort: first np_eff active
        eyek = jnp.eye(ncv, dtype=rdt)

        def chase(carry, inp):
            Tc, Qc = carry
            mu, act = inp

            def do(TQ):
                Tc, Qc = TQ
                q, _ = jnp.linalg.qr(Tc - mu * eyek)
                Tn = q.T @ Tc @ q
                dn = jnp.diag(Tn)
                en = 0.5 * (jnp.diag(Tn, 1) + jnp.diag(Tn, -1))
                Tn = (jnp.diag(dn) + jnp.diag(en, 1)
                      + jnp.diag(en, -1))
                return Tn, Qc @ q

            return lax.cond(act, do, lambda TQ: TQ, (Tc, Qc)), None

        (Tc, Q), _ = lax.scan(chase, (T, eyek), (shifts, active))
        dn = jnp.diag(Tc)
        en = jnp.diag(Tc, -1)
        # deflation sweep (dsapps.f:430-443)
        big = jnp.abs(dn[:-1]) + jnp.abs(dn[1:])
        en = jnp.where(jnp.abs(en) <= eps_m * big,
                       jnp.zeros_like(en), en)
        # subdiagonal sign normalization via diagonal similarity
        # (literals typed rdt so x64 processes don't carry f64 scalars)
        sgn = jnp.where(en >= 0, jnp.ones((), rdt), -jnp.ones((), rdt))
        phi = jnp.concatenate([jnp.ones((1,), rdt), jnp.cumprod(sgn)])
        en = jnp.abs(en)
        Q = Q * phi[None, :]
        H_new = (jnp.diag(dn) + jnp.diag(en, 1)
                 + jnp.diag(en, -1)).astype(cfg.dtype)

        sigmak = Q[ncv - 1, nev_eff - 1].astype(cfg.dtype)
        betak = jnp.where(nev_eff < ncv, en[nev_eff - 1],
                          jnp.zeros((), rdt)).astype(cfg.dtype)
        # dsapps-parity kev-row update: only rows 0..nev_eff of Q^T V
        # survive the restart (SRC/dsapps.f:445-481)
        VQ, v_next, rots = rotate_basis_kev(Q, state.V, nev_eff,
                                            cfg.dtype)
        v_next = v_next.reshape(-1).astype(cfg.dtype)
        resid = sigmak * state.resid + betak * v_next
        b_resid = op.b_apply(resid) if is_g else resid
        counts = state.counts.add(
            nbx=jnp.int32(1 if is_g else 0), nrotr=rots)
        rnorm = bnorm(resid, b_resid).astype(rdt)
        return state._replace(V=VQ, H=H_new, resid=resid,
                              b_resid=b_resid, rnorm=rnorm, k=nev_eff,
                              nev_cur=nev_eff, iter=state.iter + 1,
                              counts=counts)

    def _retridiagonalize(theta, c, kk):
        """Orthogonal ``P`` with ``P^T diag(theta) P`` tridiagonal and
        ``c^T P = ||c|| e_{kk-1}^T`` — the Krylov-Schur-to-Lanczos
        conversion that removes the thick restart's arrowhead so the
        three-term recurrence (and with it the selective-reorth omega
        model) stays valid.

        Method: ``kk`` steps of Lanczos on the DIAGONAL matrix theta
        with start vector c/||c|| and full (two-pass) reorthogonalization
        — the classic Jacobi-inverse-eigenvalue construction; every step
        is (ncv,)-vector elementwise work plus two (ncv, ncv) matmuls, far
        lighter than one ``jnp.linalg.qr`` of the shift chase.  Exact
        breakdowns (c orthogonal to an invariant subspace — e.g. a kept
        Ritz vector with zero coupling) splice in the least-represented
        coordinate with a TRUE zero coupling beta, which just splits the
        tridiagonal (legitimate Lanczos deflation).  The forward
        construction couples the start vector to column 0; reversing the
        active window puts the coupling on the LAST kept vector, where
        the resumed recurrence expects it.

        Returns ``(P, a_rev, b_rev)`` — only the leading ``kk`` columns
        / entries are meaningful.
        """
        m = iota < kk
        thet = jnp.where(m, theta, jnp.zeros((), rdt))
        cnorm = jnp.sqrt(jnp.sum(jnp.where(m, c * c, 0.0)))
        tiny = jnp.asarray(_dt.safmin(rdt), rdt)
        q1 = jnp.where(m, c, 0.0) / jnp.maximum(cnorm, tiny)
        scale = jnp.max(jnp.abs(thet))
        brk = 8 * ncv * eps_m * jnp.maximum(scale, tiny)

        def step(i, carry):
            Q, a, b, q_cur, q_prev, beta_prev = carry
            Q = Q.at[:, i].set(q_cur)
            w = thet * q_cur
            alpha = jnp.sum(q_cur * w)
            w = w - alpha * q_cur - beta_prev * q_prev

            def reorth(w):
                s = jnp.where(iota <= i, Q.T @ w, 0.0)
                return w - Q @ s

            w = reorth(reorth(w))
            beta = jnp.sqrt(jnp.sum(w * w))

            def breakdown(_):
                # least-represented active coordinate, orthogonalized
                rowsq = jnp.sum(jnp.where(iota[None, :] <= i,
                                          Q * Q, 0.0), axis=1)
                t = jnp.argmax(jnp.where(m, 1.0 - rowsq, -jnp.inf))
                e = jnp.zeros((ncv,), rdt).at[t].set(1.0)
                w2 = reorth(reorth(e))
                nw = jnp.sqrt(jnp.sum(w2 * w2))
                return w2 / jnp.maximum(nw, tiny), jnp.zeros((), rdt)

            def ok(_):
                return w / jnp.maximum(beta, tiny), beta

            q_next, beta_out = lax.cond(beta <= brk, breakdown, ok, None)
            a = a.at[i].set(alpha)
            b = b.at[i].set(beta_out)
            return (Q, a, b, q_next, q_cur, beta_out)

        Q0 = jnp.zeros((ncv, ncv), rdt)
        z = jnp.zeros((ncv,), rdt)
        Q, a, b, _, _, _ = lax.fori_loop(
            0, ncv, lambda i, cr: lax.cond(i < kk, lambda c_: step(i, c_),
                                           lambda c_: c_, cr),
            (Q0, z, z, q1, z, jnp.zeros((), rdt)))
        # reverse the active window: j <- kk-1-j
        rev = jnp.where(m, jnp.maximum(kk - 1 - iota, 0), iota)
        P = jnp.where(m[None, :], Q[:, rev], 0.0)
        a_rev = jnp.where(m, a[rev], 0.0)
        b_src = jnp.maximum(kk - 2 - iota, 0)
        b_rev = jnp.where(iota < kk - 1, b[b_src], 0.0)
        return P, a_rev, b_rev, cnorm

    def thick_restart(args):
        """Krylov-Schur-class restart WITH re-tridiagonalization: keep
        the wanted nev_eff Ritz vectors, then rotate them by the
        ``_retridiagonalize`` P so H returns to tridiagonal form with the
        residual coupling concentrated on the last kept vector —
        ``A V' = V' T' + (||c|| r) e_kev^T`` is again a genuine Lanczos
        factorization.  Mathematically equivalent to the implicit
        exact-shift chase (Wu & Simon 2000) but replaces the np-shift
        scan of ``jnp.linalg.qr`` on (ncv, ncv) operands with one
        ncv-step scan of (ncv,)-vector work, and — unlike an arrowhead
        form — keeps the selective-reorth omega recurrence valid."""
        state, T, evals, S, nev_eff, np_eff = args
        # arrange kept (wanted) eigen-indices first: positions
        # p >= np_eff of `order` are the wanted ones; stable argsort
        # of the unwanted flag puts them first in ascending order
        order = jnp.argsort(_which_key(cfg.which, evals))
        src = order[jnp.argsort(iota < np_eff, stable=True)]
        theta = evals[src].astype(rdt)
        # coupling row: c_i = S[ncv-1, kept_i] (A W = W Theta + r c^T
        # for W = V S_kept, r the current residual of norm rnorm)
        c = S[ncv - 1, src].astype(rdt)
        P, a_rev, b_rev, cnorm = _retridiagonalize(theta, c, nev_eff)
        # combined rotation (S_kept P)^T V in one kev-row pass
        Sk = jnp.where((iota < nev_eff)[None, :], S[:, src].astype(rdt),
                       0.0)
        R = Sk @ P
        VQ, _, rots = rotate_basis_kev(R, state.V, nev_eff, cfg.dtype,
                                       need_next=False)
        H_new = (jnp.diag(a_rev) + jnp.diag(b_rev[:-1], 1)
                 + jnp.diag(b_rev[:-1], -1)).astype(cfg.dtype)
        # residual direction unchanged; its effective length scales by
        # ||c|| (beta_kev = cnorm * rnorm)
        resid = state.resid * cnorm.astype(cfg.dtype)
        b_resid = state.b_resid * cnorm.astype(cfg.dtype) if is_g \
            else resid
        rnorm = (state.rnorm * cnorm).astype(_dt.real_dtype(cfg.dtype))
        return state._replace(V=VQ, H=H_new, resid=resid,
                              b_resid=b_resid, rnorm=rnorm, k=nev_eff,
                              nev_cur=nev_eff, iter=state.iter + 1,
                              counts=state.counts.add(nrotr=rots))

    def tail(h: HeadOut, is_last, shifts=None) -> CycleOut:
        if user_shifts:
            ush = jnp.asarray(shifts, rdt)
        else:
            ush = jnp.zeros((np0,), rdt)

        def skip_shifts(args):
            state = args[0]
            return state._replace(iter=state.iter + 1)

        if thick:
            state = lax.cond(
                h.done | is_last, lambda a: skip_shifts((a[0],)),
                thick_restart,
                (h.state, h.T, h.evals, h.S, h.nev_eff, h.np_eff))
        else:
            state = lax.cond(
                h.done | is_last, lambda a: skip_shifts((a[0],)),
                apply_shifts,
                (h.state, h.T, h.r_si, h.b_si, h.nev_eff, h.np_eff, ush))
        return CycleOut(state=state, done=h.done, nconv=h.nconv,
                        ritz_s=h.r_s, bounds_s=h.b_s)

    return hiprec(tail)


def make_sym_cycle(op: Operator, cfg: IRAMConfig):
    """Build the jitted fused cycle: (state, is_last) -> CycleOut —
    head and exact-shift tail composed into one traced computation."""
    head = make_sym_head(op, cfg)
    tail = make_sym_tail(op, cfg)

    def cycle(state: FactorizationState, is_last) -> CycleOut:
        return tail(head(state), is_last)

    return cycle


def make_sym_multi_cycle(op: Operator, cfg: IRAMConfig):
    """Run up to ``n_cycles`` restart cycles in ONE device dispatch: a
    ``lax.while_loop`` over the fused cycle that exits as soon as the
    convergence test fires.  The whole dsaup2 restart loop thus executes
    on-device with zero host involvement — the design endpoint of
    replacing reverse communication with traced operators (and it
    amortizes per-dispatch latency)."""
    cycle = make_sym_cycle(op, cfg)
    ncv = cfg.ncv
    rdt = _dt.real_dtype(cfg.dtype)

    def multi(state: FactorizationState, n_cycles, iter_limit) -> CycleOut:
        out0 = CycleOut(state=state, done=jnp.bool_(False),
                        nconv=jnp.int32(0),
                        ritz_s=jnp.zeros((ncv,), rdt),
                        bounds_s=jnp.zeros((ncv,), rdt))

        def cond(c):
            out, j = c
            return ((~out.done) & (j < n_cycles)
                    & (out.state.iter < iter_limit)
                    & (out.state.info == 0))

        def body(c):
            out, j = c
            is_last = out.state.iter + 1 >= iter_limit
            return cycle(out.state, is_last), j + 1

        out, _ = lax.while_loop(cond, body, (out0, jnp.int32(0)))
        return out

    return multi


class FusedSymSolver:
    """dsaupd-equivalent driver over the fused device cycle.

    API-compatible with IRAMSolver.solve(); one host sync per restart
    cycle (the `done` scalar)."""

    def __init__(self, op: Operator, cfg: IRAMConfig, mesh=None,
                 cycles_per_dispatch: int = 16, shift_fn=None):
        self.op, self.cfg, self.mesh = op, cfg, mesh
        #: restart cycles executed per device dispatch (the on-device
        #: while_loop exits early on convergence, so large values cost
        #: nothing extra beyond coarser host-side progress visibility)
        self.cycles_per_dispatch = cycles_per_dispatch
        #: ido=3 analog (iparam(1)=0): per-cycle user shifts.  The fused
        #: loop splits into two dispatches per cycle around the host
        #: callback (head -> shift_fn(ritz, bounds) -> tail), the exact
        #: fused equivalent of the reference's ido=3 return
        #: (SRC/dsaup2.f:700-724).
        self.shift_fn = shift_fn
        if cfg.exact_shifts and shift_fn is not None:
            raise ValueError("shift_fn requires exact_shifts=False "
                             "(reference iparam(1)=0, ishift=0)")
        if not cfg.exact_shifts and shift_fn is None:
            raise ValueError("exact_shifts=False requires a shift_fn")
        init = make_init(op, cfg, v3d=v_is_3d(cfg, mesh))
        user = shift_fn is not None
        cycle = None if user else make_sym_cycle(op, cfg)
        multi = None if user else make_sym_multi_cycle(op, cfg)
        head = make_sym_head(op, cfg, inflate=not user) if user else None
        tailu = make_sym_tail(op, cfg, user_shifts=True) if user else None
        if mesh is None:
            # hoisted_jit keeps operator data (dense/DIA/banded/ILU
            # arrays) out of the lowered module (utils/hoist.py)
            self._init_rand = hoisted_jit(lambda key: init(key, None))
            self._init_v0 = hoisted_jit(init)
            if user:
                self._head = hoisted_jit(head, donate_argnums=(0,))
                # donate only the state (big buffers); the reduced-space
                # HeadOut leaves are inputs XLA cannot reuse (avoids the
                # unusable-donation warning)
                self._tailu = hoisted_jit(
                    lambda st, rest, is_last, sh: tailu(
                        HeadOut(st, *rest), is_last, sh),
                    donate_argnums=(0,))
            else:
                self._cycle = hoisted_jit(cycle, donate_argnums=(0,))
                self._multi = hoisted_jit(multi, donate_argnums=(0,))
        else:
            from ..parallel.sharding import replicated, state_shardings
            st_sh = state_shardings(mesh, v3d=v_is_3d(cfg, mesh))
            rep = replicated(mesh)
            if cfg.n_pad % mesh.devices.size != 0:
                raise ValueError("n_pad must divide the mesh size")
            out_sh = CycleOut(state=st_sh, done=rep, nconv=rep,
                              ritz_s=rep, bounds_s=rep)
            self._init_rand = jax.jit(lambda key: init(key, None),
                                      in_shardings=(rep,),
                                      out_shardings=st_sh)
            self._init_v0 = jax.jit(init, in_shardings=(rep, st_sh.resid),
                                    out_shardings=st_sh)
            if user:
                h_sh = HeadOut(state=st_sh, T=rep, evals=rep, S=rep,
                               r_s=rep, b_s=rep, r_si=rep, b_si=rep,
                               nconv=rep, done=rep, nev_eff=rep,
                               np_eff=rep)
                self._head = jax.jit(head, donate_argnums=(0,),
                                     in_shardings=(st_sh,),
                                     out_shardings=h_sh)
                self._tailu = jax.jit(
                    lambda st, rest, is_last, sh: tailu(
                        HeadOut(st, *rest), is_last, sh),
                    donate_argnums=(0,),
                    in_shardings=(st_sh, tuple(h_sh[1:]), rep, rep),
                    out_shardings=out_sh)
            else:
                self._cycle = jax.jit(
                    cycle, donate_argnums=(0,),
                    in_shardings=(st_sh, rep), out_shardings=out_sh)
                self._multi = jax.jit(
                    multi, donate_argnums=(0,),
                    in_shardings=(st_sh, rep, rep), out_shardings=out_sh)

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

    def _solve_user_shifts(self, key, v0, state) -> IRAMResult:
        """Restart loop with caller-supplied shifts: two dispatches per
        cycle around the host ``shift_fn`` callback (the ido=3 protocol,
        SRC/dsaup2.f:700-724)."""
        cfg = self.cfg
        np0 = cfg.ncv - cfg.nev
        rdt = _dt.real_dtype(cfg.dtype)
        timers = Timers()
        with timers.timed("taupd"):
            if state is None:
                with timers.timed("tgetv0"):
                    state = self.init_state(key=key, v0=v0)
            if int(jax.device_get(state.info)) < 0:
                z = np.zeros(cfg.ncv)
                return self._result(state, z, z, 0, int(state.info), 0,
                                    timers)
            while True:
                with timers.timed("taitr"):
                    h = self._head(state)
                    # ONE batched readback per cycle (each round trip
                    # is latency paid by host shifts)
                    (done_h, nconv_h, it_h, info_h, r_s, b_s, r_si, b_si,
                     np_eff_h) = jax.device_get(
                        (h.done, h.nconv, h.state.iter, h.state.info,
                         h.r_s, h.b_s, h.r_si, h.b_si, h.np_eff))
                it = int(it_h) + 1
                info = int(info_h)
                if info != 0:
                    return self._result(h.state, np.zeros(cfg.ncv),
                                        np.zeros(cfg.ncv), 0,
                                        -9999 if info > 0 else info, it,
                                        timers)
                if bool(done_h) or it >= cfg.max_iter:
                    state = h.state
                    break
                np_eff = int(np_eff_h)
                with timers.timed("tgets"):
                    shifts = np.asarray(self.shift_fn(
                        np.asarray(r_si[:np_eff], np.float64).copy(),
                        np.asarray(b_si[:np_eff], np.float64).copy()))
                if shifts.shape[0] < np_eff:
                    raise ValueError(
                        f"shift_fn returned {shifts.shape[0]} shifts; "
                        f"{np_eff} required (reference ido=3 contract)")
                sh = np.zeros((np0,), np.float64)
                sh[:np_eff] = shifts[:np_eff].real
                with timers.timed("tapps"):
                    out = self._tailu(h.state, tuple(h[1:]),
                                      jnp.bool_(False),
                                      jnp.asarray(sh, rdt))
                    state = out.state
        nconv = int(nconv_h)
        r_x, b_x = reduced.exit_sort(
            cfg.which, cfg.nev, nconv,
            np.asarray(r_s, np.float64).copy(),
            np.asarray(b_s, np.float64).copy(), cfg.eps23, True, False)
        info = 0
        if it >= cfg.max_iter and nconv < cfg.nev:
            info = 1
        np_rem = int(np.count_nonzero(
            np.asarray(b_s)[: cfg.ncv - cfg.nev] == 0))
        if (cfg.ncv - cfg.nev - np_rem) == 0 and nconv < cfg.nev:
            info = 2
        return self._result(state, r_x, b_x, nconv, info, it, timers)

    def solve(self, key=None, v0=None, state=None) -> IRAMResult:
        if self.shift_fn is not None:
            return self._solve_user_shifts(key, v0, state)
        cfg = self.cfg
        timers = Timers()
        with timers.timed("taupd"):
            if state is None:
                with timers.timed("tgetv0"):
                    state = self.init_state(key=key, v0=v0)
            if int(jax.device_get(state.info)) < 0:
                z = np.zeros(cfg.ncv)
                return self._result(state, z, z, 0, int(state.info), 0,
                                    timers)
            out = None
            it = 0
            chunk = self.cycles_per_dispatch
            while True:
                with timers.timed("taitr"):
                    out = self._multi(state, jnp.int32(chunk),
                                      jnp.int32(cfg.max_iter))
                    state = out.state
                    done = bool(jax.device_get(out.done))
                it = int(jax.device_get(state.iter))
                info = int(jax.device_get(state.info))
                if info != 0:
                    return self._result(state, np.zeros(cfg.ncv),
                                        np.zeros(cfg.ncv), 0,
                                        -9999 if info > 0 else info, it,
                                        timers)
                if done or it >= cfg.max_iter:
                    break
        nconv = int(jax.device_get(out.nconv))
        r_s = np.asarray(jax.device_get(out.ritz_s), dtype=np.float64)
        b_s = np.asarray(jax.device_get(out.bounds_s), dtype=np.float64)
        r_x, b_x = reduced.exit_sort(cfg.which, cfg.nev, nconv, r_s.copy(),
                                     b_s.copy(), cfg.eps23, True, False)
        info = 0
        if it >= cfg.max_iter and nconv < cfg.nev:
            info = 1
        np_rem = int(np.count_nonzero(b_s[: cfg.ncv - cfg.nev] == 0))
        if (cfg.ncv - cfg.nev - np_rem) == 0 and nconv < cfg.nev:
            info = 2
        return self._result(state, r_x, b_x, nconv, info, it, timers)

    def _result(self, state, ritz, bounds, nconv, info, n_iter, timers
                ) -> IRAMResult:
        stats = SolverStats(n_iter=n_iter, n_conv=nconv, timers=timers)
        stats.absorb_counts(jax.device_get(state.counts))
        return IRAMResult(ritz=ritz, bounds=bounds, nconv=nconv, info=info,
                          n_iter=n_iter, state=state, stats=stats)
