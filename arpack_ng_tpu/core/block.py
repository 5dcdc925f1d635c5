"""Thick-restart BLOCK Lanczos — the b>1 algorithmic traffic lever
(no reference equivalent — arpack-ng fixes nb=1, SRC/dsaupd.f:160
"NB: blocksize to be used ... use 1").

Why blocks: a block step applies the operator to b vectors at
once and orthogonalizes them against the basis in ONE pair of
(s, n) x (n, b) GEMM passes.  Per new column that divides the two
dominant traffic terms by b:

* operator bytes (DIA diagonals, ELL gather data, dense rows) are read
  once per BLOCK instead of once per vector — decisive when matrix
  bytes dominate (wide-band DIA: 100+ diagonals = 400+ B/point/matvec
  vs ~32 B/point of vector traffic);
* full-CGS basis streams cost 2 V-passes per block = 2/b passes per
  column (the classical-vs-block trade the reference's nb=1 never
  exploits).

Against the production b=1 path the comparison is honest only
end-to-end: partial-reorthogonalization Lanczos (reorth='selective')
already streams ZERO basis rows on most steps, and scalar Krylov
degree grows b-times faster per matvec than block degree — so for
matrix-free stencils the block trade is expected NEGATIVE.  Block
Lanczos
also converges degenerate multiplets of multiplicity <= b in one
sweep, which scalar Lanczos cannot.

Design: Krylov-Schur/thick-restart form (Zhou & Saad class) with a
STATIC restart size — kev is fixed (no dsaup2-style dynamic inflation),
so every block step is a static-shape slice and the whole cycle unrolls
into one XLA computation with zero masking; the restart keeps the kev
wanted Ritz vectors plus the current residual block, with the arrow
coupling B_p * S[last b rows] written explicitly into H.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.operator import Operator
from ..utils import dtypes as _dt
from ..utils.hoist import hoisted_jit
from ..utils.precision import hiprec


class BlockState(NamedTuple):
    V: jax.Array       # (ncv + b, npan, 128) basis rows (3-D row-tiled)
    H: jax.Array       # (ncv + b, ncv + b) symmetric projection
    key: jax.Array
    nmv: jax.Array     # int32 matvec counter


def _qr_rows(W):
    """Row-stored thin QR of the block via CholQR2: with column matrices
    ``W_c = W_rows^T = Q_c R`` (R upper b x b), returns
    ``(Q_c^T as rows, R)``; the new-block coupling H[new, cur] equals R
    (v_p^T A v_q = (Q_c^T W_c)_{pq} = R_{pq}).

    CholQR (Gram cholesky + triangular solve) costs two streaming passes
    over the (b, n) block and a b x b factorization — vs a Householder
    QR of an (n, b) panel, which is both compile- and runtime-expensive
    on this hardware; applied twice (CholQR2) the orthogonality defect
    is eps-level for any block the preceding CGS left well-conditioned.
    A tiny trace-scaled ridge guards rank-deficient blocks (breakdown
    surfaces as a huge R entry, caught by the bounds test)."""
    import jax.scipy.linalg as jsl
    shp = W.shape
    Wf = W.reshape(shp[0], -1)

    def one(Wf):
        G = Wf @ Wf.T
        ridge = jnp.asarray(1e-30, G.dtype) +             jnp.finfo(G.dtype).eps * jnp.trace(G) / shp[0]
        L = jnp.linalg.cholesky(G + ridge * jnp.eye(shp[0], dtype=G.dtype))
        Qf = jsl.solve_triangular(L, Wf, lower=True)
        return Qf, L.T

    Q1, R1 = one(Wf)
    Q2, R2 = one(Q1)
    return Q2.reshape(shp), R2 @ R1


def make_block_solver(op: Operator, b: int, nev: int, ncv: int,
                      dtype, seed: int = 0):
    """Build (init_fn, cycle_fn, extract_fn) for thick-restart block
    Lanczos with block size ``b``, static restart size ``kev = nev + b``
    (rounded up to a multiple of b so restarts stay block-aligned)."""
    if ncv % b:
        raise ValueError("ncv must be a multiple of the block size")
    if op.bmat != "I":
        raise ValueError("block Lanczos harness supports standard "
                         "problems (bmat='I') only")
    if _dt.is_complex(np.dtype(dtype)):
        raise ValueError("block Lanczos harness is real-only")
    kev = -(-(nev + b) // b) * b            # static thick-restart size
    if kev + 2 * b > ncv:
        raise ValueError("need ncv >= kev + 2b (room to expand)")
    if ncv + b > op.n:
        raise ValueError(
            f"ncv + b = {ncv + b} orthonormal basis rows cannot exist in "
            f"an n = {op.n}-dimensional space (reference info = -3 class)")
    n, n_pad = op.n, op.n_pad
    if n_pad % 128:
        raise ValueError("n_pad must be a multiple of 128")
    npan = n_pad // 128
    dt = jnp.dtype(dtype)
    rdt = _dt.real_dtype(dt)
    nrow = ncv + b

    # batched operator application over the block rows: prefer the
    # block-native form (a vmap of shifted-slice updates lowers to
    # scatters — Operator.apply_block)
    blk_fn = getattr(op, "apply_block", None)

    def a_block(Vb):                       # (b, npan, 128) -> same
        flat = Vb.reshape(b, n_pad)
        if blk_fn is not None:
            out = blk_fn(flat)
        else:
            out = jax.vmap(lambda x: op.apply(x, x)[0])(flat)
        return out.reshape(b, npan, 128)

    def _ortho_block(V, s, W):
        """Full block CGS of W (b rows) against V[:s] (static s), two
        passes (block DGKS); returns (W, coeffs (s, b))."""
        Vs = V[:s]
        c1 = jnp.einsum("spl,bpl->sb", Vs, W)
        W = W - jnp.einsum("sb,spl->bpl", c1, Vs)
        c2 = jnp.einsum("spl,bpl->sb", Vs, W)
        W = W - jnp.einsum("sb,spl->bpl", c2, Vs)
        return W, c1 + c2

    def _steps(V, H, s0, nmv):
        """Extend: the current orthonormal block sits at rows [s0-b, s0);
        run block steps until ncv rows are filled, leaving the final
        residual block (orthonormalized) at rows [ncv, ncv+b)."""
        s = s0
        while s + b <= ncv + b:
            blk = V[s - b:s]
            AW = a_block(blk)
            nmv = nmv + b
            AW, coeff = _ortho_block(V, s, AW)
            Q, R = _qr_rows(AW)
            V = V.at[s:s + b].set(Q)
            H = H.at[:s, s - b:s].set(coeff[:, :b].astype(dt))
            H = H.at[s - b:s, :s].set(coeff[:, :b].T.astype(dt))
            H = H.at[s:s + b, s - b:s].set(R.astype(dt))
            H = H.at[s - b:s, s:s + b].set(R.T.astype(dt))
            s += b
        return V, H, nmv

    def init(key) -> BlockState:
        key, sub = jax.random.split(key)
        X = jax.random.uniform(sub, (b, n_pad), rdt, -1.0, 1.0).astype(dt)
        if n < n_pad:
            X = jnp.where(jnp.arange(n_pad)[None, :] < n, X,
                          jnp.zeros((), dt))
        Q, _ = _qr_rows(X.reshape(b, npan, 128))
        V = jnp.zeros((nrow, npan, 128), dt).at[0:b].set(Q)
        H = jnp.zeros((nrow, nrow), dt)
        V, H, nmv = _steps(V, H, b, jnp.int32(0))
        return BlockState(V=V, H=H, key=key, nmv=nmv)

    def cycle(st: BlockState):
        """Ritz + thick restart + refill: one dispatch."""
        V, H = st.V, st.H
        T = H[:ncv, :ncv].real.astype(rdt)
        T = (T + T.T) / 2
        theta, S = jnp.linalg.eigh(T)
        # bounds: || B_p * S[last b rows, i] ||, B_p = H[ncv:ncv+b, ncv-b:ncv]
        Bp = H[ncv:nrow, ncv - b:ncv].real.astype(rdt)
        bounds = jnp.linalg.norm(Bp @ S[ncv - b:ncv, :], axis=0)
        # wanted = largest algebraic (LA) at the top end of eigh order
        wanted_idx = jnp.arange(ncv - kev, ncv)     # kept kev (wanted last)
        theta_k = theta[wanted_idx]
        S_k = S[:, wanted_idx]
        # thick restart: V[:kev] = S_k^T V[:ncv]; residual block moves down
        Vk = jnp.einsum("sk,spl->kpl", S_k.astype(dt), V[:ncv])
        Wb = V[ncv:nrow]
        V = V.at[:kev].set(Vk).at[kev:kev + b].set(Wb)
        Hn = jnp.zeros((nrow, nrow), dt)
        Hn = Hn.at[jnp.arange(kev), jnp.arange(kev)].set(
            theta_k.astype(dt))
        arrow = (Bp @ S_k[ncv - b:ncv, :]).astype(dt)    # (b, kev)
        Hn = Hn.at[kev:kev + b, :kev].set(arrow)
        Hn = Hn.at[:kev, kev:kev + b].set(arrow.T)
        V, Hn, nmv = _steps(V, Hn, kev + b, st.nmv)
        return (BlockState(V=V, H=Hn, key=st.key, nmv=nmv),
                theta[ncv - nev:], bounds[ncv - nev:])

    def extract(st: BlockState):
        """Ritz pairs of the current factorization (host)."""
        H = np.asarray(jax.device_get(st.H))[:ncv, :ncv].astype(np.float64)
        H = (H + H.T) / 2
        theta, S = np.linalg.eigh(H)
        V = np.asarray(jax.device_get(st.V))[:ncv].reshape(ncv, n_pad)
        vecs = (S[:, -nev:].T @ V)[:, :n].T
        return theta[-nev:], vecs

    return hiprec(init), hiprec(cycle), extract, kev


def eigsh_block(op_or_a, k: int = 6, *, block_size: int = 2,
                ncv: Optional[int] = None, tol: float = 0.0,
                maxiter: int = 200, dtype=None, seed: int = 0,
                mesh=None):
    """Largest-algebraic eigenpairs by thick-restart block Lanczos
    (experimental; which='LA' only).  Returns (vals ascending, vecs,
    info dict with matvec count).

    .. note:: **When to use blocks**: the block-Krylov degree penalty
       (more matvecs on non-clustered spectra) means the scalar
       selective path is expected to win END-TO-END on generic
       problems (not yet measured on the GPU; benchmarks/bench_block.py
       is the A/B).  Use ``eigsh_block`` for degenerate clusters of
       multiplicity > 1 (choose ``block_size >=`` the multiplicity):
       they converge in one sweep while scalar Lanczos provably cannot
       separate the copies (tests/test_block.py), and there the degree
       penalty vanishes."""
    from ..api import _as_operator
    op = (op_or_a if isinstance(op_or_a, Operator)
          else _as_operator(op_or_a, dtype=dtype, hermitian=True))
    b = block_size
    ncv = ncv or max(4 * b, 2 * (-(-(k + b) // b) * b) + 2 * b)
    ncv = -(-ncv // b) * b
    # clamp into the space like eigsh's min(ncv, n) convention
    if ncv + b > op.n:
        ncv = (op.n - b) // b * b
    dt = np.dtype(dtype or op.dtype)
    tol_eff = tol if tol > 0 else _dt.default_tol(dt)
    eps23 = _dt.eps23(dt)
    # cache compiled solvers per (operator, geometry): repeat calls
    # (fresh seeds, restarted solves, benchmarks) must not re-trace and
    # RE-COMPILE the cycle
    ck = (id(op), b, k, ncv, str(dt), id(mesh) if mesh is not None
          else None)
    cached = _SOLVER_CACHE.get(ck)
    if cached is not None:
        init, cycle, extract, kev, jinit, jcycle = cached
        return _run_block(op, jinit, jcycle, extract, k, kev, b, tol_eff,
                          eps23, maxiter, seed)
    init, cycle, extract, kev = make_block_solver(op, b, k, ncv, dt,
                                                  seed=seed)
    if mesh is not None:
        # PARPACK-style row distribution for the block driver: V panel-
        # sharded, reduced space replicated (same layout contract as
        # FusedSymSolver; block contractions over (panel, lane) lower to
        # psums under jit-with-shardings)
        import jax as _jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.sharding import ROWS, replicated
        if (op.n_pad // 128) % int(mesh.devices.size):
            raise ValueError("n_pad/128 must divide the mesh size for "
                             "the block driver")
        rep = replicated(mesh)
        st_sh = BlockState(
            V=NamedSharding(mesh, P(None, ROWS, None)),
            H=rep, key=rep, nmv=rep)
        jinit = _jax.jit(init, in_shardings=(rep,), out_shardings=st_sh)
        jcycle = _jax.jit(cycle, donate_argnums=(0,),
                          in_shardings=(st_sh,),
                          out_shardings=(st_sh, rep, rep))
    else:
        # hoisted_jit keeps captured operator arrays (DIA diagonals,
        # dense matrices) out of the lowered module — a 65-diagonal n=1M
        # operator would otherwise embed ~0.5 GB of literals
        # (utils/hoist.py)
        jinit = hoisted_jit(init)
        jcycle = hoisted_jit(cycle, donate_argnums=(0,))
    _SOLVER_CACHE[ck] = (init, cycle, extract, kev, jinit, jcycle)
    return _run_block(op, jinit, jcycle, extract, k, kev, b, tol_eff,
                      eps23, maxiter, seed)


#: compiled block solvers keyed by (operator id, geometry); see
#: eigsh_block
_SOLVER_CACHE: dict = {}


def _run_block(op, jinit, jcycle, extract, k, kev, b, tol_eff, eps23,
               maxiter, seed):
    st = jinit(jax.random.key(seed))
    nconv = 0
    for it in range(maxiter):
        st, theta, bounds = jcycle(st)
        th, bo = jax.device_get((theta, bounds))
        nconv = int(np.sum(bo <= tol_eff * np.maximum(eps23,
                                                      np.abs(th))))
        if nconv >= k:
            break
    vals, vecs = extract(st)
    return vals, vecs, {"nconv": nconv, "iters": it + 1,
                        "matvecs": int(jax.device_get(st.nmv)),
                        "block_size": b, "kev": kev}
