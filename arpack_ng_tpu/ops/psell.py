"""PSELL: panel-tiled sliced-ELL SpMV for IRREGULAR sparsity, written as
one-hot contractions instead of gathers.

The reference's users run irregular matrices through plain CSR
(EXAMPLES/MATRIX_MARKET/arpackSolver.hpp:233, TESTS/dnsimp.f:192-194).
This format replaces each element gather by contractions against a
one-hot selector over a 128x128 panel of x, so the whole matvec is two
batched einsums that XLA fuses.

Format (packed on host, :func:`pack_psell_uniform`):

* x is viewed as PANELS of 16384 elements (128 rows x 128 columns);
  y as CHUNKS of 1024 elements (8 x 128).
* nonzeros are grouped by (chunk, panel) and padded to tiles of 1024
  entries; every chunk is padded to the same tile count W, so the
  per-tile scatter becomes a dense sum over W.
* per entry: value + ONE packed int32
  ``sub(3) | lane_o(7) | sr(7) | lane(7)`` — the entry reads
  ``x[panel, sr, lane]`` and accumulates into ``y[chunk, sub, lane_o]``.
  8 bytes/nonzero of streamed metadata, the CSR cost.

Selected with ``from_scipy(..., format='psell')`` (ops/sparse.py).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

LANE = 128
#: x panel: PANEL_SUB x LANE elements
PANEL_SUB = 128
PANEL = PANEL_SUB * LANE           # 16384
#: y chunk: CHUNK_SUB x LANE elements
CHUNK_SUB = 8
CHUNK = CHUNK_SUB * LANE           # 1024
#: entries per tile (one (8, 128) metadata block)
TILE = 1024


class PSellU(NamedTuple):
    """Uniform-W PSELL packing: a dense (chunks, W) grid of tiles.

    Padding every chunk to the same tile count W turns the per-tile
    scatter into a dense ``sum over W`` — no scatter-add — so the whole
    matvec is expressible as two batched one-hot einsums that XLA fuses.
    """

    vals: np.ndarray      # (C*W, TILE)
    meta: np.ndarray      # (C*W, TILE) int32 packed (module doc)
    p_idx: np.ndarray     # (C*W,) int32 x-panel per tile
    W: int
    n: int
    n_pad: int            # multiple of CHUNK
    nnz: int


def pack_psell_uniform(a, n_pad: int = 0) -> PSellU:
    """Pack into the uniform-W (chunks x W tiles) grid (see PSellU)."""
    import scipy.sparse as sp

    csr = sp.csr_matrix(a)
    n = csr.shape[0]
    if n_pad == 0:
        n_pad = -(-n // CHUNK) * CHUNK
    if n_pad % CHUNK:
        raise ValueError(f"n_pad must be a multiple of {CHUNK}")
    coo = csr.tocoo()
    r = coo.row.astype(np.int64)
    c = coo.col.astype(np.int64)
    v = coo.data
    g = r // CHUNK
    q = c // PANEL
    meta_e = ((((r % CHUNK) // LANE) << 21) | ((r % LANE) << 14)
              | (((c % PANEL) // LANE) << 7) | (c % LANE)).astype(np.int32)
    order = np.lexsort((q, g))
    g, q, v, meta_e = g[order], q[order], v[order], meta_e[order]
    nch = n_pad // CHUNK
    qwidth = n_pad // PANEL + 2
    gq = g * qwidth + q
    uq, start = np.unique(gq, return_index=True)
    start = np.sort(start)
    sizes = np.diff(np.append(start, len(gq)))
    tpg = -(-sizes // TILE)
    tiles_per_chunk = np.zeros(nch, np.int64)
    np.add.at(tiles_per_chunk, (gq[start] // qwidth), tpg)
    W = max(int(tiles_per_chunk.max()), 1)
    vals = np.zeros((nch * W, TILE), dtype=v.dtype)
    meta = np.zeros((nch * W, TILE), dtype=np.int32)
    p_idx = np.zeros(nch * W, np.int32)
    slot = np.zeros(nch, np.int64)
    for gs, sz in zip(start, sizes):
        chunk = int(g[gs])
        panel = int(q[gs])
        for j in range(-(-sz // TILE)):
            lo = gs + j * TILE
            m = min(TILE, gs + sz - lo)
            t = chunk * W + slot[chunk]
            vals[t, :m] = v[lo:lo + m]
            meta[t, :m] = meta_e[lo:lo + m]
            p_idx[t] = panel
            slot[chunk] += 1
    return PSellU(vals=vals, meta=meta, p_idx=p_idx, W=W, n=n,
                  n_pad=n_pad, nnz=int(csr.nnz))


def make_psell_matvec_xla(C: int, W: int, n_pad: int, dtype: str):
    """Pure-XLA uniform-W PSELL matvec (see PSellU): two batched
    one-hot contractions, dense W-sum, no gather ops anywhere except
    one 64 KB panel fetch per tile."""
    import jax
    import jax.numpy as jnp

    dt = jnp.dtype(dtype)
    npanels = -(-n_pad // PANEL)
    hi = jax.lax.Precision.HIGHEST
    i128 = np.arange(LANE, dtype=np.int32)
    i8 = np.arange(CHUNK_SUB, dtype=np.int32)

    def matvec(vals, meta, p_idx, x):
        full = npanels * PANEL
        if full != n_pad:
            x = jnp.pad(x, (0, full - n_pad))
        X3 = x.reshape(npanels, PANEL_SUB, LANE)
        xp = X3[p_idx]                               # (T,128,128)
        lane = meta & 0x7F
        sr = (meta >> 7) & 0x7F
        lane_o = (meta >> 14) & 0x7F
        sub = (meta >> 21) & 0x7
        oh_sr = (sr[:, :, None] == i128).astype(dt)  # (T,TILE,128)
        rowsel = jnp.einsum("tns,tsl->tnl", oh_sr, xp.astype(dt),
                            precision=hi)
        gsel = jnp.sum(rowsel * (lane[:, :, None] == i128).astype(dt),
                       axis=-1) * vals.astype(dt)    # (T,TILE)
        gs = gsel[:, :, None] * (sub[:, :, None] == i8).astype(dt)
        oh_lo = (lane_o[:, :, None] == i128).astype(dt)
        ytile = jnp.einsum("tns,tnl->tsl", gs, oh_lo,
                           precision=hi)             # (T,8,128)
        y = ytile.reshape(C, W, CHUNK_SUB, LANE).sum(axis=1)
        return y.reshape(-1)

    return matvec
