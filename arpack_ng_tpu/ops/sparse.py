"""Sparse operators on device.

The reference's sparse story lives in user code (RCI matvecs) and in the
Eigen-based C++ layer (``EigSMxS`` sparse matrices read from MatrixMarket,
arpackSolver.hpp:176-215).  Here sparse matrices are first-class
operators, imported through a STRUCTURE-FIRST decision tree
(:func:`from_scipy`), chosen from the matrix alone:

* dense (one matmul) for small n;
* DIA shift-multiply streaming when the structural diagonal count is
  bounded — directly or after RCM reordering (no gathers, pure
  elementwise streams); DIA operators also carry the BLOCK apply
  (:func:`dia_block_matvec_fn`);
* gather-ELL, or hybrid ELL+COO (Bell & Garland) when hub rows would pad
  every row to the hub degree; scatter-add COO as the last resort.

PSELL (ops/psell.py: panel-tiled one-hot contractions in place of
gathers) is available by request, ``format='psell'``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..config import pad_dim
from .operator import Operator


def _to_ell(a: sp.spmatrix, n_pad: int, width: int = 0
            ) -> Tuple[np.ndarray, np.ndarray, sp.coo_matrix]:
    """Convert to ELLPACK (cols, vals) with per-row padding, vectorized.

    Padded slots point at column ``n_pad-1`` with value 0 (the pad region is
    identically zero in every solver vector, so no masking is needed in the
    inner loop).  ``width`` caps the per-row slot count: entries beyond it
    (hub-row overflow) are returned as a COO remainder — the hybrid
    ELL+COO split (HYB of Bell & Garland's SpMV taxonomy) that keeps
    power-law matrices from padding every row to the hub degree."""
    csr = a.tocsr()
    n = csr.shape[0]
    nnz_per_row = np.diff(csr.indptr)
    wmax = int(nnz_per_row.max()) if n > 0 else 0
    width = min(width, wmax) if width else wmax
    width = max(width, 1)
    # position of each nonzero within its row
    pos = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], nnz_per_row)
    rows_of = np.repeat(np.arange(n), nnz_per_row)
    in_ell = pos < width
    cols = np.full((n_pad, width), n_pad - 1, dtype=np.int32)
    vals = np.zeros((n_pad, width), dtype=csr.dtype)
    cols[rows_of[in_ell], pos[in_ell]] = csr.indices[in_ell]
    vals[rows_of[in_ell], pos[in_ell]] = csr.data[in_ell]
    ov = ~in_ell
    tail = sp.coo_matrix(
        (csr.data[ov], (rows_of[ov], csr.indices[ov].astype(np.int64))),
        shape=(n, n))
    return cols, vals, tail


def ell_matvec(cols: jax.Array, vals: jax.Array, x: jax.Array) -> jax.Array:
    """y_i = sum_k vals[i,k] * x[cols[i,k]] — gather + dense reduction."""
    return jnp.sum(vals * x[cols], axis=1)


def coo_matvec(rows: jax.Array, cols: jax.Array, vals: jax.Array,
               x: jax.Array, n_out: int) -> jax.Array:
    """Scatter-add SpMV (fallback for pathological row distributions)."""
    return jnp.zeros((n_out,), x.dtype).at[rows].add(vals * x[cols])


#: structural-diagonal count up to which the DIA fast path is preferred
DIA_MAX_DIAGONALS = 192
#: below this dimension a dense (one matmul) operator is cheapest
DENSE_MAX_N = 2048
#: switch ELL -> hybrid ELL+COO when the max row length exceeds this
#: multiple of the 95th-percentile row length (power-law/hub matrices:
#: plain ELL pads EVERY row to the hub degree — measured 473 vs p95=20
#: on a Barabasi-Albert Laplacian, a 24x traffic blowup)
HYB_WASTE_FACTOR = 3


def dia_matvec_fn(offsets, diags, n: int, n_pad: int):
    """Device closure for a DIA (diagonal-set) matvec: one shifted
    elementwise multiply per structural diagonal — streaming with no
    gather, for any matrix whose nonzeros live on a bounded set of
    diagonals (stencils, banded systems, RCM-reordered meshes).
    ``diags[k][i] = A[i, i + offsets[k]]``."""
    dev = [jnp.asarray(d) for d in diags]

    def matvec(x):
        xs = x[:n]
        y = jnp.zeros((n,), x.dtype)
        for d, diag in zip(offsets, dev):
            if d == 0:
                y = y + diag * xs
            elif d > 0:
                y = y.at[: n - d].add(diag[: n - d] * xs[d:])
            else:
                m = -d
                y = y.at[m:].add(diag[m:] * xs[: n - m])
        if n_pad == n:
            return y
        return jnp.zeros((n_pad,), x.dtype).at[:n].set(y)

    return matvec


def dia_block_matvec_fn(offsets, diags, n: int, n_pad: int):
    """Tile-interleaved ("lane-major") BLOCK DIA matvec:
    ``(b, n_pad) -> (b, n_pad)``.

    The block is viewed ``(G, b, 128)`` with ``G = n_pad // 128``:
    column j's tile group g occupies flat row ``g*b + j``, so

    * a diagonal offset ``d = s*128 + r`` becomes at most TWO contiguous
      flat shifts (by ``s*128*b + r`` and ``(s+1)*128*b + r - 128``)
      with static masks over the 128-wide groups;
    * each diagonal is READ ONCE per block and broadcast to the b
      columns by a leading-dim broadcast+collapse (no interleave
      materialization).

    The block size b is read from the operand shape at trace time.
    """
    if n_pad % 128:
        raise ValueError("n_pad must be a multiple of 128")
    G = n_pad // 128
    dev = []
    for d, diag in zip(offsets, diags):
        dp = np.zeros(n_pad, np.asarray(diag).dtype)
        dp[:n] = np.asarray(diag)
        # row-aligned: diags[k][i] = A[i, i+d]; zero where i+d out of range
        if d > 0:
            dp[max(n - d, 0):] = 0
        else:
            dp[:min(-d, n_pad)] = 0
        dev.append(jnp.asarray(dp))

    lane = jnp.arange(128)

    def apply_block(X):
        b = X.shape[0]
        N = G * b * 128

        def shift_flat(v, S):
            if S == 0:
                return v
            if S > 0:
                return jnp.pad(v[S:], (0, min(S, N)))
            return jnp.pad(v[:S], (-S, 0))

        x = jnp.transpose(X.reshape(b, G, 128), (1, 0, 2)).reshape(N)
        y = jnp.zeros((N,), x.dtype)
        for d, diag in zip(offsets, dev):
            s, r = divmod(d, 128)
            db = jnp.broadcast_to(diag.reshape(G, 1, 128),
                                  (G, b, 128)).reshape(N)
            if r == 0:
                y = y + db * shift_flat(x, s * 128 * b)
            else:
                x1 = shift_flat(x, s * 128 * b + r).reshape(-1, 128)
                x2 = shift_flat(x, (s + 1) * 128 * b + r - 128
                                ).reshape(-1, 128)
                pick = jnp.where((lane < 128 - r)[None, :], x1, x2)
                y = y + db * pick.reshape(N)
        return jnp.transpose(y.reshape(G, b, 128),
                             (1, 0, 2)).reshape(b, n_pad)

    return apply_block


def _to_dia(a: sp.spmatrix):
    """(offsets, row-aligned diagonal arrays) from a sparse matrix."""
    coo = a.tocoo()
    n = a.shape[0]
    d = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    offsets = np.unique(d)
    diags = []
    for off in offsets:
        arr = np.zeros(n, a.dtype)
        m = d == off
        arr[coo.row[m]] = coo.data[m]
        diags.append(arr)
    return [int(o) for o in offsets], diags


def structural_diagonals(a: sp.spmatrix) -> int:
    coo = a.tocoo()
    return int(np.unique(coo.col.astype(np.int64)
                         - coo.row.astype(np.int64)).size)


def from_scipy(a: sp.spmatrix, dtype=None, *, hermitian: bool = False,
               n_pad: int = 0, format: str = "auto") -> Operator:
    """Import a scipy sparse matrix as a device operator (mode 1).

    The analog of arpackSolver's ``createMatrix`` MatrixMarket ingestion
    (arpackSolver.hpp:176-215; use io/matrix_market.py for ``.mtx``).

    ``format='auto'`` picks the execution structure from the matrix's
    structure (diagonal streaming moves no indices and does no gathers,
    so it is preferred wherever the nonzeros allow it):

    1. small n              -> dense (one matmul)
    2. few structural diagonals -> DIA (shift-multiply streaming)
    3. few diagonals after Reverse-Cuthill-McKee -> DIA on the permuted
       problem (the permutation is carried on the Operator and unwound
       on extraction, invisible to the caller)
    4. bounded row lengths  -> gather-ELL
    5. hub rows (max row length > 3x the 95th percentile, power-law
       graphs) -> hybrid ELL+COO: p95-width dense gather + scatter-add
       overflow tail (Bell & Garland HYB), so hubs don't pad every row

    ``format`` may instead name a structure directly: 'dia', 'ell',
    'hyb', 'psell' (ops/psell.py) or 'coo'.  The chosen
    structure is recorded on ``Operator.format``.
    """
    a = a.tocsr().copy()   # own the buffers: canonicalization below must
    a.sum_duplicates()     # never mutate the caller's matrix
    if dtype is not None:
        a = a.astype(dtype)
    n = a.shape[0]
    # pad to whole 1024-element chunks: the PSELL view then needs no
    # per-matvec pad/trim
    n_pad = n_pad or pad_dim(n, 1024)
    perm = None

    if format == "auto":
        if n <= DENSE_MAX_N:
            from .operator import from_dense
            return from_dense(a.toarray(), n_pad=n_pad,
                              hermitian=hermitian)
        if structural_diagonals(a) <= DIA_MAX_DIAGONALS:
            format = "dia"
        else:
            from scipy.sparse.csgraph import reverse_cuthill_mckee
            p = np.asarray(reverse_cuthill_mckee(a, symmetric_mode=hermitian))
            ap = a[p][:, p]
            if structural_diagonals(ap) <= DIA_MAX_DIAGONALS:
                a, perm, format = ap.tocsr(), p, "dia"
            else:
                nnz_row = np.diff(a.indptr)
                hyb_w95 = max(int(np.ceil(np.percentile(nnz_row, 95))), 1)
                if int(nnz_row.max()) > HYB_WASTE_FACTOR * hyb_w95:
                    format = "hyb"
                else:
                    format = "ell"

    if format == "dia":
        offsets, diags = _to_dia(a)
        mv = dia_matvec_fn(offsets, diags, n, n_pad)
        blk = dia_block_matvec_fn(offsets, diags, n, n_pad) \
            if n_pad % 128 == 0 else None

        def matvec(x):
            return mv(x)
    elif format == "ell":
        cols_np, vals_np, _ = _to_ell(a, n_pad)
        cols = jnp.asarray(cols_np)
        vals = jnp.asarray(vals_np)

        def matvec(x):
            return ell_matvec(cols, vals, x)
    elif format == "hyb":
        # hybrid ELL+COO: dense-gather the p95-width body, scatter-add
        # the hub overflow (power-law degree distributions); w95 from
        # the format decision above when it ran, else recomputed
        try:
            w95 = hyb_w95
        except NameError:
            nnz_row = np.diff(a.tocsr().indptr)
            w95 = max(int(np.ceil(np.percentile(nnz_row, 95))), 1)
        cols_np, vals_np, tail = _to_ell(a, n_pad, width=w95)
        cols = jnp.asarray(cols_np)
        vals = jnp.asarray(vals_np)
        trows = jnp.asarray(tail.row.astype(np.int32))
        tcols = jnp.asarray(tail.col.astype(np.int32))
        tvals = jnp.asarray(tail.data)

        def matvec(x):
            y = ell_matvec(cols, vals, x)
            return y.at[trows].add(tvals * x[tcols])
    elif format == "psell":
        from . import psell as ps
        # the solver's n_pad stays 128-aligned; the PSELL view pads
        # further to whole chunks internally and trims on the way out
        pk = ps.pack_psell_uniform(a, n_pad=-(-n_pad // ps.CHUNK)
                                   * ps.CHUNK)
        mv_k = ps.make_psell_matvec_xla(
            pk.n_pad // ps.CHUNK, pk.W, pk.n_pad,
            str(np.dtype(a.dtype)))
        vals_d = jnp.asarray(pk.vals)
        meta_d = jnp.asarray(pk.meta)
        p_d = jnp.asarray(pk.p_idx)
        psell_pad = pk.n_pad

        def matvec(x):
            xin = x
            if psell_pad != n_pad:
                xin = jnp.pad(x, (0, psell_pad - n_pad))
            y = mv_k(vals_d, meta_d, p_d, xin)
            return y[:n_pad]
    elif format == "coo":
        coo = a.tocoo()
        rows = jnp.asarray(coo.row.astype(np.int32))
        ccols = jnp.asarray(coo.col.astype(np.int32))
        vals = jnp.asarray(coo.data)

        def matvec(x):
            return coo_matvec(rows, ccols, vals, x, n_pad)
    else:
        raise ValueError(f"unknown sparse format {format!r}")

    def apply(v, bv):
        w = matvec(v)
        return w, w

    return Operator(n=n, dtype=a.dtype, apply=apply, bmat="I", mode=1,
                    a_apply=matvec, n_pad=n_pad, hermitian=hermitian,
                    perm=perm, format=format,
                    apply_block=blk if format == "dia" else None)
