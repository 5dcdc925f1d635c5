"""Arnoldi/Lanczos factorization engine: the dtype-generic, jit-compiled
equivalent of ``dsaitr``/``dnaitr``/``znaitr`` + ``dgetv0`` (and their four
s/d/c/z clones each).

Design notes (vs. SRC/dsaitr.f, SRC/dnaitr.f, SRC/dgetv0.f):

* The reference's reverse-communication state machine (STEP3/STEP4/ORTH1/
  ORTH2/RSTART flags, SRC/dsaitr.f:334-351) collapses into straight-line
  traced code: the user operator is a closure invoked in-trace.
* One implementation serves symmetric, non-symmetric and complex problems.
  H is stored as a full (ncv, ncv) matrix; the symmetric path reads only its
  tridiagonal part (the reference's 2-column compact storage,
  SRC/dsaup2.f:48-53, is a Fortran-era memory optimization with no
  device benefit — a full small H keeps every reduced-space op a dense
  matmul).
* V is stored row-major as (ncv, n_pad): each basis vector is a contiguous
  row; projections ``V conj @ b_w`` and updates ``h @ V`` are single large
  GEMVs over static shapes — always the full ncv rows with a
  ``col <= j`` mask instead of the reference's length-j BLAS calls
  (SRC/dsaitr.f:570-583).  Static shapes keep one compiled program per
  solve; the ~2x average flop overhead is bandwidth-neutral (V is read
  once either way).
* DGKS iterative refinement with the 0.717 test and at most one extra
  correction pass mirrors SRC/dsaitr.f:656-781 exactly, as a
  ``lax.while_loop``.
* Invariant-subspace restarts (up to 3 tries of a random orthogonalized
  vector, OP-applied on the first try) mirror SRC/dsaitr.f:397-427 +
  SRC/dgetv0.f; randomness uses counter-based keys
  (``jax.random.fold_in``) instead of the reference's saved LAPACK seeds
  {1,3,5,7} (SRC/dgetv0.f:201-207).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import IRAMConfig
from ..ops.operator import Operator
from ..utils import dtypes as _dt
from ..utils.precision import hiprec
from ..utils.stats import OpCounts

# Max refinement passes in the Arnoldi step: 1 initial + 1 extra
# ("if (iter .le. 1) go to 80", SRC/dsaitr.f:771).
_MAX_DGKS_PASSES = 2
# Max refinement iterations in start-vector orthogonalization
# ("if (iter .le. 5)", SRC/dgetv0.f:~330).
_MAX_GETV0_REFINE = 5
# Max random-restart attempts on invariant-subspace breakdown
# ("if (itry .le. 3)", SRC/dsaitr.f:414).
_MAX_RESTART_TRIES = 3


class FactorizationState(NamedTuple):
    """The explicit, checkpointable solver state.

    This pytree *is* the checkpoint: serializing it and resuming reproduces
    the reference's ``info != 0`` restart-from-resid protocol
    (SRC/dsaupd.f:130-136) with strictly more fidelity (the full
    factorization is kept, not just resid).

    ``V`` layout: ``(ncv, n_pad // 128, 128)`` when :func:`v_is_3d` holds
    (the default), else ``(ncv, n_pad)``.  Rotations ``Q^T V`` and CGS
    contractions are layout-neutral (they contract / batch over the
    leading axis), and element order is identical, so
    ``V.reshape(ncv, n_pad)`` recovers the matrix view.
    """

    V: jax.Array        # basis vectors as rows; see layout note above
    H: jax.Array        # (ncv, ncv) upper-Hessenberg projection
    resid: jax.Array    # (n_pad,) current residual r_k
    b_resid: jax.Array  # (n_pad,) B @ resid (== resid for bmat='I')
    rnorm: jax.Array    # real scalar, B-norm of resid
    k: jax.Array        # int32: current factorization length
    nev_cur: jax.Array  # int32: current nev (dynamic inflation, dsaup2.f:678)
    iter: jax.Array     # int32: restart (major) iteration counter
    info: jax.Array     # int32: 0 ok; >0 invariant-subspace size; <0 error
    key: jax.Array      # PRNG key
    counts: OpCounts


def v_is_3d(cfg: IRAMConfig, mesh=None) -> bool:
    """Whether the basis uses the (ncv, n_pad//128, 128) layout (see
    FactorizationState).  Requires 128-element divisibility; under a mesh
    the panel axis is the row-sharded axis, so n_pad must split into
    whole panels per device."""
    size = int(mesh.devices.size) if mesh is not None else 1
    return cfg.n_pad % (128 * size) == 0


def v_matrix(V):
    """Host-side matrix view (ncv, n_pad) of a basis in either layout."""
    a = np.asarray(V)
    return a.reshape(a.shape[0], -1)


def rotate_basis(Q, V, acc_dtype):
    """``Q^T V`` contracting V's leading (row) axis — the dsapps
    ``V <- V Q`` update in row-major storage, layout-generic (2-D or the
    3-D layout).  Narrow (bf16) storage contracts natively with wide
    accumulation (``preferred_element_type``), so V is read at its
    stored width; XLA's CPU backend has no bf16 x bf16 -> f32 matrix
    product, so there the operands are upcast first (bf16 -> f32 is
    exact).  Returns the storage dtype of V."""
    sdt = V.dtype
    acc = jnp.dtype(acc_dtype)
    if sdt == acc:
        return lax.dot_general(Q.astype(acc), V, (((0,), (0,)), ((), ())))
    if jax.default_backend() == "cpu":
        return lax.dot_general(Q.astype(acc), V.astype(acc),
                               (((0,), (0,)), ((), ()))).astype(sdt)
    return lax.dot_general(Q.astype(sdt), V, (((0,), (0,)), ((), ())),
                           preferred_element_type=acc).astype(sdt)


#: bucket granularity for the kev-row restart rotation
_ROT_BUCKET = 8


def rotate_basis_kev(Q, V, kev, acc_dtype, need_next: bool = True):
    """Restart rotation ``Q^T V`` computing ONLY the surviving rows.

    dsapps parity: the reference updates just columns 1..kev+1 of ``V·Q``,
    exploiting that the rotated basis beyond the restart length is dead
    (SRC/dsapps.f:445-481).  Here the leading ``kev`` output rows (the
    retained basis) plus — when ``need_next`` — row ``kev`` itself (the
    vector entering the residual update, SRC/dsaup2.f:775) are computed
    and written back into V; rows past the bucket keep their stale
    values, which are never read: every downstream contraction masks
    coefficients beyond the active length to zero, and the next
    extension writes row j before reading it.  ``kev`` is traced; the
    output row count is bucketed to multiples of 8 via ``lax.switch`` so
    every branch stays a static-shape contraction (same trick as the
    bucketed CGS).  Dead rows never contribute, so results match the
    full rotation exactly up to the dot's own accumulation order.

    Traffic: (ncv reads + R writes) of V instead of (ncv + ncv).

    Returns ``(V_new, v_next_row, rows_written:int32)``; ``v_next_row``
    has the basis row shape (flatten + cast at the call site).
    """
    ncv = Q.shape[0]
    nrows = kev + (1 if need_next else 0)
    nb = max(1, -(-ncv // _ROT_BUCKET))
    rows_list = [min((b + 1) * _ROT_BUCKET, ncv) for b in range(nb)]

    def mk(R):
        if R == ncv:
            # full rotation: a plain dot, no update-slice needed
            def f(_):
                Vn = rotate_basis(Q, V, acc_dtype).astype(V.dtype)
                vn = lax.dynamic_index_in_dim(
                    Vn, jnp.minimum(kev, R - 1), axis=0, keepdims=False)
                return Vn, vn, jnp.int32(R)
            return f

        def f(_):
            top = rotate_basis(Q[:, :R], V, acc_dtype)
            Vn = lax.dynamic_update_slice(
                V, top.astype(V.dtype), (0,) * V.ndim)
            vn = lax.dynamic_index_in_dim(
                top, jnp.minimum(kev, R - 1), axis=0, keepdims=False)
            return Vn, vn, jnp.int32(R)
        return f

    if nb == 1:
        return mk(ncv)(None)
    b = jnp.minimum((jnp.maximum(nrows, 1) - 1) // _ROT_BUCKET, nb - 1)
    return lax.switch(b, [mk(R) for R in rows_list], None)


def _bnorm(r, br):
    """B-norm: sqrt(|<r, B r>|) (SRC/dsaitr.f:634-639; complex analog uses
    abs of the complex dot, SRC/znaitr.f)."""
    return jnp.sqrt(jnp.abs(jnp.vdot(r, br)))


def make_bnorm(op: Operator, cfg: IRAMConfig):
    """Norm closure.  With ``cfg.safe_norms`` and a standard problem this
    is the overflow-safe two-phase global 2-norm of PARPACK's pdnorm2
    (allreduce-MAX of |x|, then allreduce-SUM of scaled squares,
    PARPACK/SRC/MPI/pdnorm2.f:70-80) — under jit-with-shardings the max
    and the dot each lower to one collective, exactly the two phases."""
    if not (cfg.safe_norms and op.bmat == "I"):
        return _bnorm
    tiny = _dt.safmin(cfg.dtype)

    def bnorm(r, br):
        m = jnp.max(jnp.abs(r))
        msafe = jnp.maximum(m, tiny)
        scaled = r / msafe
        nrm = msafe * jnp.sqrt(jnp.abs(jnp.vdot(scaled, scaled)))
        return jnp.where(m > 0, nrm, jnp.zeros_like(nrm))

    return bnorm


def _random_vector(key, n_pad, n, dtype):
    """Uniform(-1,1) start vector (dlarnv idist=2, SRC/dgetv0.f:224-229),
    zero on the pad so the Krylov space never activates padded coordinates."""
    rdt = _dt.real_dtype(dtype)
    if _dt.is_complex(dtype):
        re = jax.random.uniform(key, (2, n_pad), rdt, -1.0, 1.0)
        v = (re[0] + 1j * re[1]).astype(dtype)
    else:
        v = jax.random.uniform(key, (n_pad,), rdt, -1.0, 1.0).astype(dtype)
    if n < n_pad:
        mask = jnp.arange(n_pad) < n
        v = jnp.where(mask, v, jnp.zeros((), dtype))
    return v


def make_init(op: Operator, cfg: IRAMConfig, v3d: Optional[bool] = None):
    """Build the jittable state initializer (dgetv0 j=1 path).

    Returns ``init(key, v0)`` where ``v0`` (optional, length n_pad) plays the
    role of the reference's user-supplied ``resid`` when ``info != 0`` on
    input to ``dsaupd`` (SRC/dsaupd.f:243-246).  ``v3d`` selects the basis
    layout (see :func:`v_is_3d`; every consumer branches on ``V.ndim`` at
    trace time, so only the initializer needs the decision).
    """
    ncv, n_pad, n = cfg.ncv, cfg.n_pad, cfg.n
    if v3d is None:
        v3d = v_is_3d(cfg)
    vshape = (ncv, n_pad // 128, 128) if v3d else (ncv, n_pad)
    dtype = jnp.dtype(cfg.dtype)
    sdt = jnp.dtype(cfg.storage_dtype) if cfg.storage_dtype is not None \
        else dtype
    rdt = _dt.real_dtype(dtype)
    is_g = op.bmat == "G"
    bnorm = make_bnorm(op, cfg)

    def init(key, v0: Optional[jax.Array] = None) -> FactorizationState:
        counts = OpCounts.zeros()
        key, sub = jax.random.split(key)
        if v0 is None:
            r0 = _random_vector(sub, n_pad, n, dtype)
        else:
            r0 = jnp.asarray(v0, dtype)
        # Force the starting vector into the range of OP (handles singular B
        # in generalized problems; SRC/dgetv0.f:233-246, ido=-1).
        br0 = op.b_apply(r0)
        counts = counts.add(nbx=jnp.int32(1 if is_g else 0))
        w, _ = op.apply(r0, br0)
        counts = counts.add(nopx=jnp.int32(1))
        resid = w
        b_resid = op.b_apply(resid) if is_g else resid
        counts = counts.add(nbx=jnp.int32(1 if is_g else 0))
        rnorm = bnorm(resid, b_resid).astype(rdt)
        # rnorm == 0 here is the reference's info = -9 (zero starting vector,
        # SRC/dsaup2.f:332-341).
        info = jnp.where(rnorm > 0, jnp.int32(0), jnp.int32(-9))
        return FactorizationState(
            V=jnp.zeros(vshape, sdt),
            H=jnp.zeros((ncv, ncv), dtype),
            resid=resid,
            b_resid=b_resid,
            rnorm=rnorm,
            k=jnp.int32(0),
            nev_cur=jnp.int32(cfg.nev),
            iter=jnp.int32(0),
            info=info,
            key=key,
            counts=counts,
        )

    # matmul-precision pin (utils/precision.py): ghost-Ritz prevention
    return hiprec(init)


def make_extend(op: Operator, cfg: IRAMConfig):
    """Build the jittable factorization extension
    ``extend(state, k_start, k_end)``: dsaitr/dnaitr equivalent.

    Extends a ``k_start``-step factorization to ``k_end`` steps.  Both bounds
    may be traced (the restart loop calls with dynamic nev due to the
    stagnation guard of SRC/dsaup2.f:678-684).
    """
    ncv, n_pad, n = cfg.ncv, cfg.n_pad, cfg.n
    dtype = jnp.dtype(cfg.dtype)
    sdt = jnp.dtype(cfg.storage_dtype) if cfg.storage_dtype is not None \
        else dtype
    mixed = sdt != dtype
    # Debug escape hatches, read ONCE at build time: these must be set
    # before solver construction; flipping them afterwards is a no-op
    # for already-built (jit-cached) solvers.
    import os as _os
    _force_full_reorth = bool(_os.environ.get("ARPACK_TPU_FULL_REORTH"))
    if mixed and _dt.is_complex(dtype):
        raise ValueError("storage_dtype is supported for real dtypes only")
    rdt = _dt.real_dtype(dtype)
    is_g = op.bmat == "G"
    eta = jnp.asarray(_dt.DGKS_ETA, rdt)
    # reorth='selective' switches the SYMMETRIC path (standard AND
    # generalized) to partial-reorthogonalization Lanczos (three-term
    # recurrence + omega tracking, see _step_pro below); everywhere else it
    # has no effect and the reference's full-CGS + DGKS step runs
    # unchanged.  (A relaxed DGKS *trigger* on the full-CGS step is
    # unsound: the new column's defect is amplified through the existing
    # basis defect ||Delta||*kappa per step, so it compounds geometrically
    # — measured blowup within a few restart cycles.)
    # bmat='G': the recurrence/omega algebra is identical in the B-inner
    # product (OP is B-self-adjoint for every symmetric mode 2-5); B@r is
    # recomputed fresh each step exactly like dsaitr's ORTH1 B*r request
    # (SRC/dsaitr.f:570-583 B-variant), so the per-step saving is the two
    # V passes, not the B apply.
    # restart='thick' keeps the omega model valid: the fused tail
    # re-tridiagonalizes the kept block (device_sym _retridiagonalize),
    # so there is no arrowhead and the three-term recurrence resumes
    # exactly.
    use_pro = (cfg.reorth == "selective" and cfg.symmetric
               and cfg.restart in ("implicit", "thick"))
    tiny = jnp.asarray(_dt.safmin(dtype), rdt)
    col_idx = jnp.arange(ncv)

    b_apply = (lambda r: op.b_apply(r)) if is_g else (lambda r: r)
    nbx1 = jnp.int32(1 if is_g else 0)
    bnorm = make_bnorm(op, cfg)

    def _proj(V, w):
        """(rows,) projection coefficients V^H w, accumulated in `dtype`
        even when V is stored narrow (mixed-precision orthogonalization:
        narrow reads, wide accumulate via preferred_element_type).
        Layout-generic: the 3-D basis contracts over its (panel, lane)
        trailing dims."""
        if V.ndim == 3:
            w = w.reshape(V.shape[1], V.shape[2])
            if not mixed:
                return lax.dot_general(V.conj(), w,
                                       (((1, 2), (0, 1)), ((), ())))
            return lax.dot_general(V, w.astype(sdt),
                                   (((1, 2), (0, 1)), ((), ())),
                                   preferred_element_type=dtype)
        if not mixed:
            return V.conj() @ w
        return lax.dot_general(V, w.astype(sdt), (((1,), (0,)), ((), ())),
                               preferred_element_type=dtype)

    def _comb(h, V):
        """(n,) combination h @ V with wide accumulation."""
        if V.ndim == 3:
            if not mixed:
                return lax.dot_general(
                    h, V, (((0,), (0,)), ((), ()))).reshape(-1)
            return lax.dot_general(
                h.astype(sdt), V, (((0,), (0,)), ((), ())),
                preferred_element_type=dtype).reshape(-1)
        if not mixed:
            return h @ V
        return lax.dot_general(h.astype(sdt), V, (((0,), (0,)), ((), ())),
                               preferred_element_type=dtype)

    def _set_row(V, v, j):
        """Write 1-D vector v as row j of the basis (layout-generic)."""
        if V.ndim == 3:
            blk = v.astype(sdt).reshape(1, V.shape[1], V.shape[2])
            z = jnp.zeros((), j.dtype)
            return lax.dynamic_update_slice(V, blk, (j, z, z))
        return lax.dynamic_update_slice(V, v.astype(sdt)[None, :],
                                        (j, jnp.zeros((), j.dtype)))

    def _get_row(V, j):
        """Read row j of the basis as a 1-D compute-dtype vector."""
        r = lax.dynamic_index_in_dim(V, j, axis=0, keepdims=False)
        return r.reshape(-1).astype(dtype)

    # ---- bucketed CGS: stream only the active rows of V ----------------
    # The masked static-shape contractions above always read the full
    # (ncv, n) basis from HBM even when only j+1 rows are active.  Since
    # the solver is V-bandwidth-bound, that overread is the
    # single largest waste in the cycle: averaged over a restart cycle the
    # active row count is ~2/3–3/4 of ncv.  Dispatching on the bucket
    # ceil((j+1)/8)*8 via lax.switch keeps every branch a static-shape
    # contraction (row counts in multiples of the f32 sublane tile) while
    # streaming only the rows that can be nonzero.  Results are bit-exact
    # vs the full masked form: excluded rows contributed exact zeros.
    _BUCKET = 8
    _nbuckets = max(1, -(-ncv // _BUCKET))
    _bucket_rows = [min((b + 1) * _BUCKET, ncv) for b in range(_nbuckets)]

    def _proj_upto(V, w, j):
        """V[:rows]^H w padded to (ncv,), rows = smallest bucket > j."""
        def mk(rows):
            def f(_):
                return jnp.pad(_proj(V[:rows], w), (0, ncv - rows))
            return f

        if _nbuckets == 1:
            return mk(ncv)(None)
        b = jnp.minimum(j // _BUCKET, _nbuckets - 1)
        return lax.switch(b, [mk(r) for r in _bucket_rows], None)

    def _update_upto(w, h, V, j):
        """w - h[:rows] @ V[:rows] — entries of h beyond j are zero, so
        this realizes the full CGS subtraction while streaming only the
        active bucket (also serves the DGKS refinement passes)."""
        def mk(rows):
            def f(_):
                return w - _comb(h[:rows], V[:rows])
            return f

        if _nbuckets == 1:
            return mk(ncv)(None)
        b = jnp.minimum(j // _BUCKET, _nbuckets - 1)
        return lax.switch(b, [mk(r) for r in _bucket_rows], None)

    def _orth_refine(V, nmask_lt, r, br, rn_prev, max_iter):
        """Shared CGS + iterative-refinement loop (dgetv0 flavor): repeatedly
        orthogonalize r against masked rows of V until the norm stops
        collapsing (0.717 test).  Returns (r, br, rnorm, nbx_done, ok)."""
        def cond(c):
            _, _, _, _, it, status = c
            return status == 0

        def body(c):
            r, br, rn_prev, nbx_done, it, _ = c
            s = jnp.where(nmask_lt, _proj(V, br), jnp.zeros((), dtype))
            r = r - _comb(s, V)
            br = b_apply(r)
            rn = bnorm(r, br).astype(rdt)
            ok = rn > eta * rn_prev
            fail = (~ok) & (it + 1 >= max_iter)
            status = jnp.where(ok, jnp.int32(1),
                               jnp.where(fail, jnp.int32(2), jnp.int32(0)))
            return (r, br, rn, nbx_done + nbx1, it + 1, status)

        r, br, rn, nbx_done, _, status = lax.while_loop(
            cond, body, (r, br, rn_prev, jnp.int32(0), jnp.int32(0),
                         jnp.int32(0)))
        failed = status == 2
        zero = jnp.zeros((), dtype)
        r = jnp.where(failed, jnp.zeros_like(r), r)
        br = jnp.where(failed, jnp.zeros_like(br), br)
        rn = jnp.where(failed, jnp.zeros_like(rn), rn)
        return r, br, rn, nbx_done, ~failed

    def _restart_vector(st: FactorizationState, j):
        """Invariant-subspace hit: draw a new random vector B-orthogonal to
        V[:j] (SRC/dsaitr.f:380-427 + dgetv0).  Up to 3 tries; OP is applied
        to the first try's vector only (dgetv0.f:236-246)."""
        counts = st.counts.add(nrstrt=jnp.int32(1))
        nmask_lt = col_idx < j

        def cond(c):
            itry, _, _, _, _, done, _ = c
            return (~done) & (itry < _MAX_RESTART_TRIES)

        def body(c):
            itry, key, _, _, _, _, counts = c
            key, sub = jax.random.split(key)
            r = _random_vector(sub, n_pad, n, dtype)

            def with_op(r):
                br = b_apply(r)
                w, _ = op.apply(r, br)
                return w, jnp.int32(1), nbx1

            def without_op(r):
                return r, jnp.int32(0), jnp.int32(0)

            r, dop, dbx = lax.cond(itry == 0, with_op, without_op, r)
            br = b_apply(r)
            rn0 = bnorm(r, br).astype(rdt)
            r, br, rn, nbx_done, ok = _orth_refine(
                V=st.V, nmask_lt=nmask_lt, r=r, br=br, rn_prev=rn0,
                max_iter=_MAX_GETV0_REFINE + 1)
            counts = counts.add(nopx=dop, nbx=dbx + nbx1 + nbx_done)
            return (itry + 1, key, r, br, rn, ok & (rn > 0), counts)

        init = (jnp.int32(0), st.key, st.resid, st.b_resid,
                jnp.zeros((), rdt), jnp.bool_(False), counts)
        _, key, r, br, rn, done, counts = lax.while_loop(cond, body, init)
        # All tries failed: the factorization stops at size j
        # (reference sets info = j and exits, SRC/dsaitr.f:418-425).
        info = jnp.where(done, st.info, j.astype(jnp.int32))
        return st._replace(resid=r, b_resid=br, rnorm=rn, key=key,
                           info=info, counts=counts)

    def _step(j, st: FactorizationState) -> FactorizationState:
        rstart = st.rnorm <= 0
        st = lax.cond(rstart & (st.info == 0),
                      lambda s: _restart_vector(s, j), lambda s: s, st)

        def do_step(st: FactorizationState) -> FactorizationState:
            counts = st.counts
            rnorm_prev = st.rnorm
            # STEP 2: v_j = r/rnorm (safe reciprocal; the reference uses
            # dlascl when rnorm < safmin, SRC/dsaitr.f:438-454).
            inv = (jnp.ones((), rdt) / jnp.maximum(st.rnorm, tiny)).astype(rdt)
            v_j = st.resid * inv
            bv_j = st.b_resid * inv if is_g else v_j
            V = _set_row(st.V, v_j, j)
            # STEP 3: w = OP v_j, with bw = B w (or A v for mode 2).
            w, bw = op.apply(v_j, bv_j)
            counts = counts.add(
                nopx=jnp.int32(1),
                nbx=jnp.int32(1 if (is_g and op.mode != 2) else 0))
            wnorm = bnorm(w, bw).astype(rdt)
            # STEP 4: classical Gram-Schmidt against all of V (masked to the
            # first j+1 rows) — the two dgemv calls of SRC/dsaitr.f:570-583
            # as full static-shape contractions.
            nmask_le = col_idx <= j
            h = jnp.where(nmask_le, _proj_upto(V, bw, j), jnp.zeros((), dtype))
            r = _update_upto(w, h, V, j)
            # Extend H: column j gets the projection coefficients; the
            # subdiagonal H[j, j-1] is beta_{j-1} = previous rnorm
            # (zero after an invariant-subspace restart).
            H = lax.dynamic_update_index_in_dim(st.H, h, j, axis=1)
            beta = jnp.where(rstart, jnp.zeros((), rdt), rnorm_prev)
            H = lax.cond(
                j > 0,
                lambda Hm: Hm.at[j, jnp.maximum(j - 1, 0)].set(
                    beta.astype(dtype)),
                lambda Hm: Hm, H)
            # ORTH1: B-norm of the new residual.
            br = b_apply(r)
            rnorm = bnorm(r, br).astype(rdt)
            counts = counts.add(nbx=nbx1)

            # STEP 5: DGKS iterative refinement (SRC/dsaitr.f:656-781).
            needs = rnorm <= eta * wnorm
            counts = counts.add(nrorth=jnp.where(needs, 1, 0).astype(jnp.int32))

            def dgks_cond(c):
                _, _, _, _, _, _, status = c
                return status == 0

            def dgks_body(c):
                r, br, rn_prev, s_tot, passes, nfail, _ = c
                s = jnp.where(nmask_le, _proj_upto(V, br, j),
                              jnp.zeros((), dtype))
                r = _update_upto(r, s, V, j)
                br = b_apply(r)
                rn = bnorm(r, br).astype(rdt)
                s_tot = s_tot + s
                accept = rn > eta * rn_prev
                give_up = (~accept) & (passes + 1 >= _MAX_DGKS_PASSES)
                status = jnp.where(accept, jnp.int32(1),
                                   jnp.where(give_up, jnp.int32(2),
                                             jnp.int32(0)))
                nfail = nfail + jnp.where(accept, 0, 1).astype(jnp.int32)
                return (r, br, rn, s_tot, passes + 1, nfail, status)

            def run_dgks(args):
                r, br, rnorm = args
                out = lax.while_loop(
                    dgks_cond, dgks_body,
                    (r, br, rnorm, jnp.zeros((ncv,), dtype), jnp.int32(0),
                     jnp.int32(0), jnp.int32(0)))
                r, br, rn, s_tot, passes, nfail, status = out
                # status==2: residual is numerically in span(V): zero it
                # (SRC/dsaitr.f:773-781).
                in_span = status == 2
                r = jnp.where(in_span, jnp.zeros_like(r), r)
                br = jnp.where(in_span, jnp.zeros_like(br), br)
                rn = jnp.where(in_span, jnp.zeros_like(rn), rn)
                return r, br, rn, s_tot, passes, nfail

            def skip_dgks(args):
                r, br, rnorm = args
                return (r, br, rnorm, jnp.zeros((ncv,), dtype), jnp.int32(0),
                        jnp.int32(0))

            r, br, rnorm, s_tot, passes, nfail = lax.cond(
                needs, run_dgks, skip_dgks, (r, br, rnorm))
            counts = counts.add(nitref=nfail,
                                nbx=(passes * nbx1).astype(jnp.int32))
            # Fold the refinement correction into H column j
            # (sym: only alpha is updated in the reference since its compact
            # storage has no other slots, SRC/dsaitr.f:694-696; nonsym adds
            # the full vector, SRC/dnaitr.f — we do the latter, which is the
            # mathematically complete update).
            H = lax.cond(
                passes > 0,
                lambda Hm: Hm.at[:, j].add(s_tot.astype(dtype)),
                lambda Hm: Hm, H)
            return st._replace(V=V, H=H, resid=r, b_resid=br, rnorm=rnorm,
                               k=j + 1, counts=counts)

        return lax.cond(st.info == 0, do_step, lambda s: s, st)

    # ---- partial-reorthogonalization Lanczos (reorth='selective') -------
    # The classical three-term recurrence r = A v_j - alpha_j v_j -
    # beta_{j-1} v_{j-1} streams ZERO rows of V on most steps (vs 2 full
    # passes for CGS + up to 2 more for DGKS) — on a V-bandwidth-bound
    # solver this removes the dominant traffic term entirely.  Exactness
    # is recovered by tracking the orthogonality defect omega_{j,i} =
    # v_j^T v_i with Simon's coupled recurrence (Simon, Math. Comp. 42
    # (1984); the PROPACK scheme) and performing a FULL bucketed CGS
    # reorthogonalization of r (plus the following step, in pairs) only
    # when max omega exceeds tau ~ sqrt(eps): the basis then stays
    # SEMI-orthogonal, which provably preserves eps-level Ritz accuracy
    # for Lanczos.  Applies to symmetric problems under implicit restarts,
    # standard AND generalized: for bmat='G' every inner product above is
    # the B-inner product (omega_{j,i} = v_j^T B v_i), B@r is recomputed
    # fresh per step (dsaitr ORTH1 semantics), and OP's B-self-adjointness
    # makes the same three-term recurrence exact.  The reference has no
    # analog (dsaitr always pays the full-CGS traffic).
    # noise floor.  The classical model charges sqrt(n)*eps per inner
    # product (sequential-summation worst case); XLA reduces with
    # blocked TREE/pairwise summation, whose rounding is
    # ~log2(n)*eps, and the *stored-vector* orthogonality error is O(eps)
    # (coordinate noise of unit vectors: <v+d1, w+d2> error ~ ||d|| ~ eps,
    # no sqrt(n)).  At n=1M the sqrt(n) model (1.2e-4) exceeded reality by
    # ~50x and the additive omega term alone forced a tau-crossing every
    # ~4 steps — the event rate was set by the noise MODEL, not by true
    # orthogonality decay (measured: 50% of steps paid a reorth event).
    # Charge 8*log2(n)*eps (safety factor 8 over the pairwise bound,
    # covering fma/segmented-reduction variation), plus the bf16 storage
    # representation error when narrow storage is on.
    # The pairwise model assumes XLA lowers the CGS inner products as
    # tree/pairwise reductions (guarded by the basis-defect property
    # test, tests/test_reorth.py, and by the ghost-Ritz check of
    # chip_smoke.py on the GPU).
    # A backend that accumulates sequentially would need the classical
    # sqrt(n)*eps bound back: ARPACK_TPU_OMEGA_NOISE_MODEL=sequential
    # restores it without a code change (build-time knob, like the
    # other hatches above).
    if _os.environ.get("ARPACK_TPU_OMEGA_NOISE_MODEL", "pairwise") \
            == "sequential":
        eps_eff = float(np.sqrt(max(float(n), 2.0)) * _dt.eps(dtype)
                        + _dt.eps(sdt))
    else:
        eps_eff = float(8.0 * np.log2(max(float(n), 2.0)) * _dt.eps(dtype)
                        + _dt.eps(sdt))
    tau = jnp.asarray(np.sqrt(eps_eff) / _dt.SELECTIVE_SAFETY, rdt)
    eps1 = jnp.asarray(eps_eff, rdt)
    # eta-subset selection for reorth EVENTS (Larsen/PROPACK): when the
    # omega recurrence fires, only rows with omega_i > eta actually lost
    # orthogonality (typically the few converged Ritz directions) —
    # reorthogonalizing against just those keeps every un-touched row
    # below eta = eps_eff^(3/4) << tau, preserving semi-orthogonality
    # while streaming K << ncv basis rows per event (events streaming
    # the full basis would dominate the flagship's counted bytes).
    # cap below tau: with narrow (bf16) storage eps_eff^(3/4) can exceed
    # the trigger threshold — the selection must always include the rows
    # that caused the event
    eta_sub = jnp.asarray(
        min(eps_eff ** 0.75,
            float(np.sqrt(eps_eff) / _dt.SELECTIVE_SAFETY) / 2.0), rdt)
    neg_inf = jnp.asarray(-jnp.inf, rdt)

    def _omega_update(a, b, wp, wc, j, wnorm, beta_j):
        """One row of Simon's omega recurrence (signed terms, abs at the
        end, additive noise eps1*wnorm):  beta_j * w_{j+1,i} =
        beta_i w_{j,i+1} + (alpha_i - alpha_j) w_{j,i}
        + beta_{i-1} w_{j,i-1} - beta_{j-1} w_{j-1,i}."""
        aj = a[j]
        bjm1 = jnp.where(j > 0, b[jnp.maximum(j - 1, 0)],
                         jnp.zeros((), rdt))
        # self-orthogonality convention: omega_{j,j} = omega_{j-1,j-1} = 1
        wc_full = jnp.where(col_idx == j, jnp.ones((), rdt), wc)
        wp_full = jnp.where((col_idx == j - 1) & (j > 0),
                            jnp.ones((), rdt), wp)
        wc_p1 = jnp.roll(wc_full, -1)          # omega_{j,i+1}
        wc_m1 = jnp.roll(wc_full, 1)           # omega_{j,i-1}
        wc_m1 = wc_m1.at[0].set(0.0)
        b_m1 = jnp.roll(b, 1).at[0].set(0.0)   # beta_{i-1}
        t = (b * wc_p1 + (a - aj) * wc_full + b_m1 * wc_m1
             - bjm1 * wp_full)
        wn = (jnp.abs(t) + eps1 * wnorm) / jnp.maximum(beta_j, tiny)
        # row j entry: local orthogonality of v_{j+1} against v_j
        wn = jnp.where(col_idx == j,
                       eps1 * wnorm / jnp.maximum(beta_j, tiny), wn)
        return jnp.where(col_idx <= j, wn, jnp.zeros((), rdt))

    def _step_pro(j, carry):
        st, wp, wc, force = carry
        rstart = st.rnorm <= 0
        st = lax.cond(rstart & (st.info == 0),
                      lambda s: _restart_vector(s, j), lambda s: s, st)
        # a fresh restart vector is fully orthogonalized: clean slate
        wp = jnp.where(rstart, jnp.full((ncv,), eps1, rdt), wp)
        wc = jnp.where(rstart, jnp.full((ncv,), eps1, rdt), wc)

        def do_step(carry):
            st, wp, wc, force = carry
            counts = st.counts
            rnorm_prev = st.rnorm
            inv = (jnp.ones((), rdt) / jnp.maximum(st.rnorm, tiny)).astype(rdt)
            v_j = st.resid * inv
            bv_j = st.b_resid * inv if is_g else v_j
            V = _set_row(st.V, v_j, j)
            w, bw = op.apply(v_j, bv_j)
            counts = counts.add(
                nopx=jnp.int32(1),
                nbx=jnp.int32(1 if (is_g and op.mode != 2) else 0))
            wnorm = bnorm(w, bw).astype(rdt)
            # three-term recurrence (reads ONE stored row: v_{j-1});
            # alpha = <v_j, B w> — bw plays B@w in every inner product
            # (mode 2 returns bw = A v = M w, same value)
            alpha = jnp.real(jnp.vdot(v_j, bw)).astype(rdt)
            beta_prev = jnp.where(rstart | (j == 0), jnp.zeros((), rdt),
                                  rnorm_prev)
            v_jm1 = _get_row(V, jnp.maximum(j - 1, 0))
            r = (w - alpha.astype(dtype) * v_j
                 - beta_prev.astype(dtype) * v_jm1)
            br = b_apply(r)
            counts = counts.add(nbx=nbx1)
            rnorm = bnorm(r, br).astype(rdt)
            # H: tridiagonal writes only
            H = st.H.at[j, j].set(alpha.astype(dtype))
            H = lax.cond(
                j > 0,
                lambda Hm: Hm.at[j, jnp.maximum(j - 1, 0)].set(
                    beta_prev.astype(dtype)
                ).at[jnp.maximum(j - 1, 0), j].set(beta_prev.astype(dtype)),
                lambda Hm: Hm, H)
            # omega recurrence with the new alpha_j, beta_j
            a_vec = jnp.real(jnp.diagonal(H)).astype(rdt).at[j].set(alpha)
            b_sub = jnp.real(jnp.diagonal(H, offset=-1)).astype(rdt)
            b_vec = jnp.concatenate([b_sub, jnp.zeros((1,), rdt)])
            b_vec = b_vec.at[j].set(rnorm)
            wn = _omega_update(a_vec, b_vec, wp, wc, j, wnorm, rnorm)
            need = (jnp.max(wn) > tau) | (force > 0)
            counts = counts.add(
                nrorth=jnp.where(need, 1, 0).astype(jnp.int32))
            rows_full = jnp.minimum((j // _BUCKET + 1) * _BUCKET,
                                    jnp.int32(ncv))

            def subset_pass(r, br):
                """One CGS pass against the eta-selected rows only
                (Larsen/PROPACK): rows with omega above eps^(3/4),
                bucketed to K by the same lax.switch trick; below-
                threshold rows padded into the top-K gather are cleaned
                too (harmless), stale rows (col > j) are masked out.

                Returns ``(r2, reset, rows)``."""
                sel_key = jnp.where(col_idx <= j, wn, neg_inf)
                order = jnp.argsort(-sel_key)
                cnt = jnp.sum(sel_key > eta_sub).astype(jnp.int32)

                def mk(K):
                    def f(_):
                        idx = order[:K]
                        valid = jnp.take(sel_key, idx) > neg_inf
                        Vg = jnp.take(V, idx, axis=0)
                        s_k = _proj(Vg, br)
                        s_k = jnp.where(valid, s_k, jnp.zeros((), dtype))
                        r2 = r - _comb(s_k, Vg)
                        reset = jnp.zeros((ncv,), bool).at[idx].set(valid)
                        return r2, reset, jnp.int32(K)
                    return f

                if _nbuckets == 1 or _force_full_reorth:
                    return mk(ncv)(None)   # debug hatch: all rows
                bket = jnp.minimum(jnp.maximum(cnt - 1, 0) // _BUCKET,
                                   _nbuckets - 1)
                return lax.switch(bket,
                                  [mk(rws) for rws in _bucket_rows], None)

            def run_reorth(args):
                r, br, rn_prev = args
                r1, reset, K = subset_pass(r, br)
                br1 = b_apply(r1)
                rn1 = bnorm(r1, br1).astype(rdt)
                accept1 = rn1 > eta * rn_prev

                def full_fallback(a):
                    # doubtful case (norm still collapsed): one FULL
                    # bucketed pass, then the reference's span-declare
                    # give-up (SRC/dsaitr.f:773-781)
                    r1, br1, rn1 = a
                    s = jnp.where(col_idx <= j, _proj_upto(V, br1, j),
                                  jnp.zeros((), dtype))
                    r2 = _update_upto(r1, s, V, j)
                    br2 = b_apply(r2)
                    rn2 = bnorm(r2, br2).astype(rdt)
                    in_span = ~(rn2 > eta * rn1)
                    r2 = jnp.where(in_span, jnp.zeros_like(r2), r2)
                    br2 = jnp.where(in_span, jnp.zeros_like(br2), br2)
                    rn2 = jnp.where(in_span, jnp.zeros_like(rn2), rn2)
                    return (r2, br2, rn2,
                            jnp.int32(1) + in_span.astype(jnp.int32),
                            jnp.int32(2), rows_full)

                def no_fb(a):
                    r1, br1, rn1 = a
                    return (r1, br1, rn1, jnp.int32(0), jnp.int32(1),
                            jnp.int32(0))

                r, br, rn, nfail, passes, extra_rows = lax.cond(
                    accept1, no_fb, full_fallback, (r1, br1, rn1))
                return (r, br, rn, nfail, passes, K + extra_rows,
                        reset | (extra_rows > 0))

            def skip_reorth(args):
                r, br, rn_prev = args
                return (r, br, rn_prev, jnp.int32(0), jnp.int32(0),
                        jnp.int32(0), jnp.zeros((ncv,), bool))

            (r, br, rnorm, nfail, rpasses, rrows, reset) = lax.cond(
                need, run_reorth, skip_reorth, (r, br, rnorm))
            counts = counts.add(nitref=nfail,
                                nbx=(rpasses * nbx1).astype(jnp.int32),
                                nrorthr=rrows)
            # post-event omega: reorthogonalized rows drop to the eps
            # floor, untouched rows keep their (sub-eta) values;
            # reorthogonalize the NEXT step too (pair rule: both
            # carriers of the three-term recurrence must be clean before
            # omega growth can restart from the eps floor) unless this
            # event WAS the forced follow-up
            wn = jnp.where(reset, jnp.full((ncv,), eps1, rdt), wn)
            if cfg.pair_rule == "clean":
                # clean-carrier suppression: the
                # eta-subset selection leaves every untouched row of
                # omega_{j+1} below eta_sub by construction; the only
                # super-eta feedback path into omega_{j+2} is the
                # -beta_j*w_{j,i} term carrying the PREVIOUS carrier
                # v_j's defect.  When that row is also below eta_sub
                # everywhere, the forced follow-up cannot be needed.
                carrier_dirty = jnp.max(
                    jnp.where(col_idx < j, wc, jnp.zeros((), rdt))
                ) > eta_sub
                force_out = jnp.where(need & (force == 0) & carrier_dirty,
                                      jnp.int32(1), jnp.int32(0))
            else:
                force_out = jnp.where(need & (force == 0), jnp.int32(1),
                                      jnp.int32(0))
            st = st._replace(V=V, H=H, resid=r, b_resid=br, rnorm=rnorm,
                             k=j + 1, counts=counts)
            return st, wc, wn, force_out

        return lax.cond(st.info == 0, do_step,
                        lambda c: (c[0], c[1], c[2], c[3]),
                        (st, wp, wc, force))

    def extend(st: FactorizationState, k_end) -> FactorizationState:
        """Extend from the state's current length ``st.k`` to ``k_end``."""
        if not use_pro:
            return lax.fori_loop(st.k, k_end, _step, st)
        # omega init: the mutual defect of the carried-over columns is
        # unknown at this boundary (restart rotations preserve but do not
        # reveal it) — start AT tau so the first step always performs one
        # full reorthogonalization, which also cleans the rotated residual.
        w0 = jnp.full((ncv,), tau, rdt)
        st, _, _, _ = lax.fori_loop(
            st.k, k_end, _step_pro,
            (st, w0, w0, jnp.int32(0)))
        return st

    # matmul-precision pin (utils/precision.py): the CGS/recurrence dots
    # at reduced precision (TF32 on the GPU) break every orthogonality
    # argument (ghost Ritz values)
    return hiprec(extend)
