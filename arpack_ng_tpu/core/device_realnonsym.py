"""Fully device-fused REAL non-symmetric restart cycle — real arithmetic
end to end (dnaupd/dnaup2 class), the faithful-real counterpart of the
complexified path in core/device_nonsym.py.

Why this exists: the complex fused path costs 2x matvec flops (operator
applied to Re/Im separately), and the hybrid driver pays a host
reduced-space round trip per restart cycle.  This module runs the
whole dnaup2 major iteration on device in real arithmetic:

* **Real Schur form** of the (ncv, ncv) Hessenberg via explicit
  Wilkinson/Francis QR iteration (dlahqr's role, SRC/dneigh.f:194): per
  sweep, the trailing active 2x2 supplies either a real Wilkinson shift
  (explicit QR of ``H - mu I``) or a conjugate pair handled as ONE
  double shift through the real product matrix
  ``M = H^2 - 2Re(mu) H + |mu|^2 I`` (explicit QR of M — the classic
  explicit double-shift step; the implicit bulge chase of dlahqr is its
  rounding-refined equivalent).  Converged complex 2x2 blocks are
  recognized (outer couplings zero, negative discriminant) and excluded
  from further shifting; the result is the quasi-upper-triangular real
  Schur form with 2x2 blocks for conjugate pairs.
* **Eigenvalues** from the 1x1/2x2 diagonal blocks (dlanv2's role),
  exactly conjugate by construction.
* **Ritz bounds** = rnorm * |last component of the unit eigenvector of
  H| (dneigh.f:213, via dtrevc): quasi-triangular back-substitution in
  explicit (re, im) PAIR arithmetic — complex values as two real
  carries, 2x2 diagonal blocks solved jointly in closed form, dtrevc's
  smallnum clamping on near-singular denominators.  No complex dtype
  ever reaches the device.
* **Shift selection** (dngets, SRC/dngets.f): which-keyed device sort
  with conjugate pairs kept adjacent (pair members tie exactly on every
  key; bounds are symmetrized across pairs so stable sorts cannot split
  them) and the kev+1 boundary adjustment when the cut would split a
  pair (dngets.f:165-176).
* **Shift application** (dnapps): scan over the shift list; real shifts
  apply a single explicit QR, conjugate pairs apply one real double
  shift via the product matrix (the pair's second member is marked and
  skipped); deflation test |h| <= eps*(|d_i|+|d_i+1|) per step
  (SRC/dnapps.f:328-336).

Everything else (extension via the dtype-generic real Arnoldi engine,
convergence tests, nev inflation, V*Q rotation, residual update, exit
protocol, extraction on host) mirrors device_sym/device_nonsym.
"""
from __future__ import annotations

from typing import NamedTuple

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

#: QR-iteration sweep budget per cycle (a double shift retires a whole
#: conjugate pair, so this is generous; matches device_nonsym's budget).
_SWEEPS_PER_EV = 4


def _which_key_real(which: str, wr, wi):
    """Device sort key on (wr, wi) pairs — ascending puts WANTED last.
    LI/SI use |wi| (dsortc's real-problem semantics, core/reduced.py
    sort_key with real_pairs=True); conjugate partners tie exactly on
    every key, so stable argsort keeps them adjacent (+wi first, the
    dsortc swap convention, because block extraction emits +wi first)."""
    if which == "LM":
        return jnp.hypot(wr, wi)
    if which == "SM":
        return -jnp.hypot(wr, wi)
    if which == "LR":
        return wr
    if which == "SR":
        return -wr
    if which == "LI":
        return jnp.abs(wi)
    if which == "SI":
        return -jnp.abs(wi)
    raise ValueError(f"bad which={which!r}")


def _deflate_real(T, eps):
    """Zero negligible subdiagonals (dnapps.f:328-336 test)."""
    sub = jnp.diag(T, -1)
    big = jnp.abs(jnp.diag(T)[:-1]) + jnp.abs(jnp.diag(T)[1:])
    big = jnp.where(big == 0, jnp.ones_like(big), big)
    keep = jnp.abs(sub) > eps * big
    sub2 = jnp.where(keep, sub, jnp.zeros_like(sub))
    return jnp.triu(T, 0) + jnp.diag(sub2, -1), keep


def _block_disc(T):
    """Per subdiagonal position i: discriminant of the (i, i+1) block,
    ((a-d)/2)^2 + b*c  — negative <=> complex conjugate eigenvalues."""
    d0 = jnp.diag(T)
    b = jnp.diag(T, 1)
    c = jnp.diag(T, -1)
    half = (d0[:-1] - d0[1:]) / 2.0
    return half * half + b * c


def make_real_schur(k: int, rdt, sweeps: int):
    """Device real Schur: H -> (T quasi-upper-triangular, Q orthogonal)
    with H = Q T Q^T."""
    eps = jnp.asarray(_dt.eps(rdt), rdt)
    eye = jnp.eye(k, dtype=rdt)
    idx1 = jnp.arange(k - 1)

    def sweep(carry, _):
        T, Q = carry
        T, keep = _deflate_real(T, eps)
        disc = _block_disc(T)
        # converged complex 2x2: outer couplings gone, disc < 0
        left0 = jnp.concatenate([jnp.ones((1,), bool), ~keep[:-1]])
        right0 = jnp.concatenate([~keep[1:], jnp.ones((1,), bool)])
        conv2 = keep & left0 & right0 & (disc < 0)
        active = keep & ~conv2
        any_active = jnp.any(active)
        m = jnp.maximum(jnp.max(jnp.where(active, idx1, -1)), 0)
        blk = lax.dynamic_slice(T, (m, m), (2, 2))
        a11, a12 = blk[0, 0], blk[0, 1]
        a21, a22 = blk[1, 0], blk[1, 1]
        s = a11 + a22
        p = a11 * a22 - a12 * a21
        dsc = s * s / 4.0 - p

        def do(TQ):
            T, Q = TQ

            def single(TQ):
                T, Q = TQ
                r = jnp.sqrt(jnp.maximum(dsc, 0.0))
                mu1, mu2 = s / 2.0 + r, s / 2.0 - r
                mu = jnp.where(jnp.abs(mu1 - a22) < jnp.abs(mu2 - a22),
                               mu1, mu2)
                q, _ = jnp.linalg.qr(T - mu * eye)
                return jnp.triu(q.T @ T @ q, -1), Q @ q

            def double(TQ):
                T, Q = TQ
                M = T @ T - s * T + p * eye
                q, _ = jnp.linalg.qr(M)
                return jnp.triu(q.T @ T @ q, -1), Q @ q

            return lax.cond(dsc >= 0, single, double, (T, Q))

        T, Q = lax.cond(any_active, do, lambda TQ: TQ, (T, Q))
        return (T, Q), None

    def schur(H):
        (T, Q), _ = lax.scan(sweep, (H.astype(rdt), eye), None,
                             length=sweeps)
        T, _ = _deflate_real(T, eps)
        return T, Q

    return schur


def real_block_eigs(T):
    """Eigenvalues (wr, wi) of the quasi-triangular T from its 1x1/2x2
    diagonal blocks (dlanv2's role), plus the pair-start mask.  Conjugate
    partners are EXACT mirrors by construction (same block formula)."""
    k = T.shape[0]
    sub = jnp.diag(T, -1)                        # (k-1,)
    pstart = jnp.concatenate([sub != 0, jnp.zeros((1,), bool)])   # (k,)
    psecond = jnp.concatenate([jnp.zeros((1,), bool), sub != 0])  # (k,)
    d0 = jnp.diag(T)
    disc = jnp.concatenate([_block_disc(T), jnp.zeros((1,), T.dtype)])
    mean = (d0 + jnp.concatenate([d0[1:], d0[-1:]])) / 2.0
    r_real = jnp.sqrt(jnp.maximum(disc, 0.0))
    r_imag = jnp.sqrt(jnp.maximum(-disc, 0.0))
    # pair start entries
    wr_ps = jnp.where(disc < 0, mean, mean + r_real)
    wi_ps = jnp.where(disc < 0, r_imag, jnp.zeros_like(r_imag))
    # pair second entries (values of the block starting one position up)
    mean_m = jnp.concatenate([mean[-1:], mean[:-1]])
    disc_m = jnp.concatenate([disc[-1:], disc[:-1]])
    rr_m = jnp.sqrt(jnp.maximum(disc_m, 0.0))
    ri_m = jnp.sqrt(jnp.maximum(-disc_m, 0.0))
    wr_sec = jnp.where(disc_m < 0, mean_m, mean_m - rr_m)
    wi_sec = jnp.where(disc_m < 0, -ri_m, jnp.zeros_like(ri_m))
    wr = jnp.where(pstart, wr_ps, jnp.where(psecond, wr_sec, d0))
    wi = jnp.where(pstart, wi_ps, jnp.where(psecond, wi_sec,
                                            jnp.zeros_like(d0)))
    return wr, wi, pstart, psecond


def make_real_last_components(k: int, rdt):
    """|last component of the unit eigenvector of H| for every eigenvalue
    of the real Schur pair (T, Q) — dneigh's bound ingredient via a
    dtrevc-class quasi-triangular back-substitution, done entirely in
    (re, im) pair arithmetic so no complex dtype reaches the device.

    Bounds of conjugate partners are symmetrized (the partner's
    eigenvector is the exact conjugate, and exact ties are required so
    downstream stable sorts never split a pair)."""
    eps = _dt.eps(rdt)
    iota = jnp.arange(k)

    def last_comps(T, Q):
        tnorm = jnp.maximum(jnp.max(jnp.abs(T)), 1.0)
        small = jnp.asarray(eps, rdt) * tnorm
        small2 = small * small
        wr, wi, pstart, psecond = real_block_eigs(T)
        sub = jnp.diag(T, -1)
        # bottom-of-block flag per row l: rows (l-1, l) coupled
        bottom = jnp.concatenate([jnp.zeros((1,), bool), sub != 0])
        qlast = Q[k - 1, :]

        def one(i):
            # block start s / end e for eigen-index i
            s = jnp.where(psecond[i], i - 1, i)
            is_pair = pstart[s]
            e = s + jnp.where(is_pair, 1, 0)
            lr, li = wr[i], jnp.abs(wi[i])      # use +wi branch
            # seeds: 1x1 -> u[s] = 1; 2x2 -> robust nullspace of the block
            a = T[s, s]
            b = jnp.where(is_pair, T[s, s + jnp.int32(1)], jnp.zeros((), rdt))
            c = jnp.where(is_pair, T[jnp.minimum(s + 1, k - 1), s],
                          jnp.zeros((), rdt))
            d = T[jnp.minimum(s + 1, k - 1), jnp.minimum(s + 1, k - 1)]
            use_b = jnp.abs(b) >= jnp.abs(c)
            seed_s_r = jnp.where(is_pair, jnp.where(use_b, b, lr - d),
                                 jnp.ones((), rdt))
            seed_s_i = jnp.where(is_pair & ~use_b, li, jnp.zeros((), rdt))
            seed_e_r = jnp.where(use_b, lr - a, c)
            seed_e_i = jnp.where(use_b, li, jnp.zeros((), rdt))

            def step(carry, l):
                ur, ui, skip = carry
                row = T[l, :]
                mgt = iota > l
                cr = jnp.sum(jnp.where(mgt, row * ur, 0.0))
                ci = jnp.sum(jnp.where(mgt, row * ui, 0.0))

                def solve(_):
                    def joint(_):
                        # rows (l-1, l) coupled: solve the complex 2x2
                        lm1 = jnp.maximum(l - 1, 0)
                        rowm = T[lm1, :]
                        crm = jnp.sum(jnp.where(mgt, rowm * ur, 0.0))
                        cim = jnp.sum(jnp.where(mgt, rowm * ui, 0.0))
                        a11r, a11i = T[lm1, lm1] - lr, -li
                        a12 = T[lm1, l]
                        a21 = T[l, lm1]
                        a22r, a22i = T[l, l] - lr, -li
                        detr = a11r * a22r - a11i * a22i - a12 * a21
                        deti = a11r * a22i + a11i * a22r
                        dmag2 = detr * detr + deti * deti
                        ok = dmag2 >= small2
                        detr = jnp.where(ok, detr, small)
                        deti = jnp.where(ok, deti, 0.0)
                        dmag2 = jnp.where(ok, dmag2, small2)
                        # rhs = -(c_{l-1}, c_l); x = A^{-1} rhs
                        b1r, b1i = -crm, -cim
                        b2r, b2i = -cr, -ci
                        x1r_n = a22r * b1r - a22i * b1i - a12 * b2r
                        x1i_n = a22r * b1i + a22i * b1r - a12 * b2i
                        x2r_n = a11r * b2r - a11i * b2i - a21 * b1r
                        x2i_n = a11r * b2i + a11i * b2r - a21 * b1i
                        x1r = (x1r_n * detr + x1i_n * deti) / dmag2
                        x1i = (x1i_n * detr - x1r_n * deti) / dmag2
                        x2r = (x2r_n * detr + x2i_n * deti) / dmag2
                        x2i = (x2i_n * detr - x2r_n * deti) / dmag2
                        nur = jnp.where(iota == lm1, x1r,
                                        jnp.where(iota == l, x2r, ur))
                        nui = jnp.where(iota == lm1, x1i,
                                        jnp.where(iota == l, x2i, ui))
                        return nur, nui, jnp.bool_(True)

                    def scalar(_):
                        denr, deni = T[l, l] - lr, -li
                        dmag2 = denr * denr + deni * deni
                        ok = dmag2 >= small2
                        denr = jnp.where(ok, denr, small)
                        deni = jnp.where(ok, deni, 0.0)
                        dmag2 = jnp.where(ok, dmag2, small2)
                        xr = (-cr * denr - ci * deni) / dmag2
                        xi = (-ci * denr + cr * deni) / dmag2
                        nur = jnp.where(iota == l, xr, ur)
                        nui = jnp.where(iota == l, xi, ui)
                        return nur, nui, jnp.bool_(False)

                    return lax.cond(bottom[l], joint, scalar, None)

                def seed_or_skip(_):
                    at_e = (l == e) & ~skip
                    nur = jnp.where(at_e & (iota == e), seed_e_r, ur)
                    nui = jnp.where(at_e & (iota == e), seed_e_i, ui)
                    nur = jnp.where(at_e & is_pair & (iota == s),
                                    seed_s_r, nur)
                    nui = jnp.where(at_e & is_pair & (iota == s),
                                    seed_s_i, nui)
                    nur = jnp.where(at_e & ~is_pair & (iota == s),
                                    seed_s_r, nur)
                    # after seeding a pair, the next step (l-1 == s) must
                    # be skipped; after a joint solve likewise
                    nskip = at_e & is_pair
                    return nur, nui, nskip

                ur, ui, skip = lax.cond((l < s) & ~skip, solve,
                                        seed_or_skip, None)
                return (ur, ui, skip), None

            init = (jnp.zeros((k,), rdt), jnp.zeros((k,), rdt),
                    jnp.bool_(False))
            (ur, ui, _), _ = lax.scan(step, init,
                                      jnp.arange(k - 1, -1, -1))
            unorm = jnp.sqrt(jnp.sum(ur * ur + ui * ui))
            unorm = jnp.maximum(unorm, jnp.asarray(_dt.safmin(rdt), rdt))
            pr = jnp.sum(qlast * ur)
            pi = jnp.sum(qlast * ui)
            return jnp.hypot(pr, pi) / unorm

        out = jax.vmap(one)(iota)
        # symmetrize across pairs: partner gets the pair-start's value
        out = jnp.where(psecond, jnp.concatenate([out[-1:], out[:-1]]),
                        out)
        return out, wr, wi, pstart, psecond

    return last_comps


class RealCycleOut(NamedTuple):
    state: FactorizationState
    done: jax.Array
    nconv: jax.Array
    wr_s: jax.Array      # (ncv,) which-sorted Ritz real parts, wanted last
    wi_s: jax.Array      # (ncv,) imaginary parts
    bounds_s: jax.Array  # (ncv,)


def make_realnonsym_cycle(op: Operator, cfg: IRAMConfig):
    """Jitted fused cycle for REAL non-symmetric problems:
    (state, is_last) -> RealCycleOut."""
    if cfg.symmetric:
        raise ValueError("use device_sym for symmetric problems")
    if _dt.is_complex(cfg.dtype):
        raise ValueError("use device_nonsym for complex problems")
    ncv, nev0 = cfg.ncv, cfg.nev
    np0 = ncv - nev0
    rdt = jnp.dtype(cfg.dtype)
    tol = jnp.asarray(cfg.tol_effective, rdt)
    eps23 = jnp.asarray(cfg.eps23, rdt)
    eps_m = jnp.asarray(_dt.eps(rdt), rdt)
    extend = make_extend(op, cfg)
    bnorm = make_bnorm(op, cfg)
    is_g = op.bmat == "G"
    iota = jnp.arange(ncv)
    schur = make_real_schur(ncv, rdt, sweeps=_SWEEPS_PER_EV * ncv)
    last_comps = make_real_last_components(ncv, rdt)
    eyek = jnp.eye(ncv, dtype=rdt)

    def _straddle(wr_s, wi_s, boundary):
        """True iff the conjugate pair straddles index ``boundary``
        (sorted order keeps pairs adjacent, +wi first)."""
        bm1 = jnp.clip(boundary - 1, 0, ncv - 1)
        bb = jnp.clip(boundary, 0, ncv - 1)
        inside = (boundary >= 1) & (boundary <= ncv - 1)
        return (inside & (wi_s[bm1] > 0) & (wi_s[bb] < 0)
                & (wr_s[bm1] == wr_s[bb]) & (wi_s[bm1] == -wi_s[bb]))

    def cycle(state: FactorizationState, is_last) -> RealCycleOut:
        state = extend(state, jnp.int32(ncv))

        # ---- dneigh: real Schur + Ritz values + bounds ----
        T, Qs = schur(state.H.astype(rdt))
        lc, wr, wi, _, _ = last_comps(T, Qs)
        bounds = (state.rnorm * lc).astype(rdt)

        # ---- dngets: wanted last, pairs adjacent ----
        order = jnp.argsort(_which_key_real(cfg.which, wr, wi),
                            stable=True)
        wr_s, wi_s, b_s = wr[order], wi[order], bounds[order]

        # boundary pair adjustment at the static nev0 cut
        # (dngets.f:165-176: grow kev by one)
        str0 = _straddle(wr_s, wi_s, jnp.int32(np0))
        np1 = jnp.int32(np0) - str0
        nev1 = jnp.int32(nev0) + str0

        # ---- dnconv over the wanted set ----
        conv = b_s <= tol * jnp.maximum(eps23, jnp.hypot(wr_s, wi_s))
        nconv = jnp.sum(conv & (iota >= np1)).astype(jnp.int32)

        # ---- zero-bound unwanted ----
        nz = jnp.sum((b_s == 0) & (iota < np1)).astype(jnp.int32)
        np_eff = np1 - nz
        nev_eff = nev1 + nz
        done = (nconv >= nev0) | (np_eff == 0)

        # mnaup2-gated per-cycle dumps (SRC/dnaup2.f:389-397 analog)
        device_trace(debug.maup2, 0,
                     "_realnonsym_cycle: iter {i}: nconv={nc} rnorm={rn}",
                     i=state.iter, nc=nconv, rn=state.rnorm)
        device_trace(debug.maup2, 1,
                     "_realnonsym_cycle: ritz Re (wanted last) {wr}\n"
                     "_realnonsym_cycle: ritz Im {wi}\n"
                     "_realnonsym_cycle: bounds {b}",
                     wr=wr_s, wi=wi_s, b=b_s)

        # ---- nev inflation (dnaup2.f:673-693) ----
        nev_inf = nev_eff + jnp.minimum(nconv, np_eff // 2)
        nev_inf = jnp.where((nev_inf == 1) & (ncv >= 6), ncv // 2,
                            jnp.where((nev_inf == 1) & (ncv > 3), 2,
                                      nev_inf))
        nev_eff = jnp.minimum(nev_inf, ncv - 1)
        np_eff = jnp.int32(ncv) - nev_eff
        # re-check the (possibly moved) boundary for a split pair.  The
        # normal adjustment grows kev (dngets.f:165-176); when that would
        # leave np_eff == 0 (nothing to shift -> a no-op cycle that would
        # corrupt the residual update, cf. dnapps' 'if (np .eq. 0)' exit
        # guard), take BOTH pair members as shifts instead.
        str1 = _straddle(wr_s, wi_s, np_eff)
        shrink = str1 & (np_eff > 1)
        grow = str1 & (np_eff <= 1)
        np_eff = np_eff - shrink + grow
        nev_eff = nev_eff + shrink - grow

        def apply_shifts(args):
            state, wr_s, wi_s, b_s, nev_eff, np_eff = args
            active0 = iota < np_eff
            # shift pool = the np_eff least-wanted values (positional,
            # dsaup2.f:516-521), applied largest bound first
            # (dngets.f:180-187); pair members tie exactly (bounds
            # symmetrized), stable sort keeps them adjacent with +wi first
            skey = jnp.where(active0[:np0], -jnp.abs(b_s[:np0]),
                             jnp.asarray(jnp.inf, rdt))
            sperm = jnp.argsort(skey, stable=True)
            s_wr = wr_s[:np0][sperm]
            s_wi = wi_s[:np0][sperm]
            active = active0[:np0]
            second = s_wi < 0          # pair partner: already applied

            def chase(carry, inp):
                Hc, Qc = carry
                mur, mui, act, sec = inp

                def do(HQ):
                    Hc, Qc = HQ

                    def sgl(_):
                        q, _r = jnp.linalg.qr(Hc - mur * eyek)
                        return q

                    def dbl(_):
                        s2 = 2.0 * mur
                        p = mur * mur + mui * mui
                        M = Hc @ Hc - s2 * Hc + p * eyek
                        q, _r = jnp.linalg.qr(M)
                        return q

                    q = lax.cond(mui > 0, dbl, sgl, None)
                    Hn = jnp.triu(q.T @ Hc @ q, -1)
                    Hn, _ = _deflate_real(Hn, eps_m)
                    return Hn, Qc @ q

                return lax.cond(act & ~sec, do, lambda HQ: HQ,
                                (Hc, Qc)), None

            (Hc, Q), _ = lax.scan(chase, (state.H.astype(rdt), eyek),
                                  (s_wr, s_wi, active, second))
            sigmak = Q[ncv - 1, nev_eff - 1].astype(cfg.dtype)
            betak_row = lax.dynamic_index_in_dim(Hc, nev_eff, axis=0,
                                                 keepdims=False)
            betak = betak_row[nev_eff - 1].astype(cfg.dtype)
            # dsapps-parity kev-row update (SRC/dnapps.f analog): only
            # rows 0..nev_eff of Q^T V survive the restart
            VQ, v_next, rots = rotate_basis_kev(Q, state.V, nev_eff,
                                                cfg.dtype)
            v_next = v_next.reshape(-1).astype(cfg.dtype)
            resid = sigmak * state.resid + betak * v_next
            b_resid = op.b_apply(resid) if is_g else resid
            counts = state.counts.add(nbx=jnp.int32(1 if is_g else 0),
                                      nrotr=rots)
            rnorm = bnorm(resid, b_resid).astype(
                _dt.real_dtype(cfg.dtype))
            return state._replace(V=VQ, H=Hc.astype(cfg.dtype),
                                  resid=resid, b_resid=b_resid,
                                  rnorm=rnorm, k=nev_eff,
                                  nev_cur=nev_eff, iter=state.iter + 1,
                                  counts=counts)

        def skip_shifts(args):
            state = args[0]
            return state._replace(iter=state.iter + 1)

        state = lax.cond(done | is_last, skip_shifts, apply_shifts,
                         (state, wr_s, wi_s, b_s, nev_eff, np_eff))
        return RealCycleOut(state=state, done=done, nconv=nconv,
                            wr_s=wr_s, wi_s=wi_s, bounds_s=b_s)

    return hiprec(cycle)


def make_realnonsym_multi_cycle(op: Operator, cfg: IRAMConfig):
    """lax.while_loop over the fused real-nonsym cycle — the whole
    restart loop in one dispatch (see device_sym.make_sym_multi_cycle)."""
    cycle = make_realnonsym_cycle(op, cfg)
    ncv = cfg.ncv
    rdt = jnp.dtype(cfg.dtype)

    def multi(state: FactorizationState, n_cycles, iter_limit
              ) -> RealCycleOut:
        out0 = RealCycleOut(state=state, done=jnp.bool_(False),
                            nconv=jnp.int32(0),
                            wr_s=jnp.zeros((ncv,), rdt),
                            wi_s=jnp.zeros((ncv,), rdt),
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


class FusedRealNonsymSolver:
    """dnaupd-equivalent driver over the fused REAL nonsym cycle — zero
    complex arithmetic on device (runs on complex-incapable backends) and
    single-matvec cost (no complexification).  API-compatible with
    IRAMSolver.solve()."""

    def __init__(self, op: Operator, cfg: IRAMConfig, mesh=None,
                 cycles_per_dispatch: int = 16):
        if _dt.is_complex(cfg.dtype):
            raise ValueError("FusedRealNonsymSolver is for real dtypes")
        if cfg.symmetric:
            raise ValueError("use FusedSymSolver for symmetric problems")
        self.op, self.cfg, self.mesh = op, cfg, mesh
        self.cycles_per_dispatch = cycles_per_dispatch
        if not cfg.exact_shifts:
            raise ValueError("fused path requires exact shifts")
        init = make_init(op, cfg, v3d=v_is_3d(cfg, mesh))
        multi = make_realnonsym_multi_cycle(op, cfg)
        if mesh is None:
            # hoisted_jit keeps operator data (dense/DIA/banded/ILU
            # arrays) out of the lowered module (utils/hoist.py)
            self._init_rand = hoisted_jit(lambda key: init(key, None))
            self._init_v0 = hoisted_jit(init)
            self._multi = hoisted_jit(multi, donate_argnums=(0,))
        else:
            from ..parallel.sharding import replicated, state_shardings
            st_sh = state_shardings(mesh, v3d=v_is_3d(cfg, mesh))
            rep = replicated(mesh)
            out_sh = RealCycleOut(state=st_sh, done=rep, nconv=rep,
                                  wr_s=rep, wi_s=rep, bounds_s=rep)
            self._init_rand = jax.jit(lambda key: init(key, None),
                                      in_shardings=(rep,),
                                      out_shardings=st_sh)
            self._init_v0 = jax.jit(init, in_shardings=(rep, st_sh.resid),
                                    out_shardings=st_sh)
            self._multi = jax.jit(multi, donate_argnums=(0,),
                                  in_shardings=(st_sh, rep, rep),
                                  out_shardings=out_sh)

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

    def solve(self, key=None, v0=None, state=None) -> IRAMResult:
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
            while True:
                with timers.timed("taitr"):
                    out = self._multi(state,
                                      jnp.int32(self.cycles_per_dispatch),
                                      jnp.int32(cfg.max_iter))
                    state = out.state
                    done, it, info = map(int, jax.device_get(
                        (out.done, state.iter, state.info)))
                if info != 0:
                    return self._result(state, np.zeros(cfg.ncv),
                                        np.zeros(cfg.ncv), 0,
                                        -9999 if info > 0 else info, it,
                                        timers)
                if done or it >= cfg.max_iter:
                    break
        nconv = int(jax.device_get(out.nconv))
        wr_s, wi_s, b_np = jax.device_get((out.wr_s, out.wi_s,
                                           out.bounds_s))
        r_s = (np.asarray(wr_s, np.float64)
               + 1j * np.asarray(wi_s, np.float64))
        b_s = np.asarray(b_np, np.float64)
        r_x, b_x = reduced.exit_sort(cfg.which, cfg.nev, nconv, r_s.copy(),
                                     b_s.copy(), cfg.eps23, False, True)
        info = 0
        if it >= cfg.max_iter and nconv < cfg.nev:
            info = 1
        return self._result(state, r_x, b_x, nconv, info, it, timers)

    def _result(self, state, ritz, bounds, nconv, info, n_iter, timers
                ) -> IRAMResult:
        stats = SolverStats(n_iter=n_iter, n_conv=nconv, timers=timers)
        stats.absorb_counts(jax.device_get(state.counts))
        return IRAMResult(ritz=ritz, bounds=bounds, nconv=nconv, info=info,
                          n_iter=n_iter, state=state, stats=stats)
