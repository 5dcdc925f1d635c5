"""Distributed stencil operators with explicit halo exchange — the
PARPACK example pattern (PARPACK/EXAMPLES/MPI/pdsdrv1.f:429-480: 1-D
row-partitioned 2-D Laplacian whose matvec sends/receives nx-sized
boundary blocks between neighboring ranks) rebuilt with ``shard_map`` +
``lax.ppermute`` over the device mesh.

The reference user writes MPI_SEND/MPI_RECV inside their matvec; here the
halo exchange is a single ``ppermute`` per direction, compiled by XLA into
neighbor transfers (NCCL over NVLink on a GPU host) that can overlap with
the local stencil computation.
Missing halos at the mesh boundary arrive as zeros = Dirichlet walls.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.operator import Operator
from ..parallel.sharding import ROWS


def laplacian_2d_sharded(nx: int, ny: int, mesh: Mesh,
                         dtype=np.float32) -> Tuple[Operator, sp.spmatrix]:
    """Row-partitioned 2-D Dirichlet Laplacian over ``mesh`` (grid of
    ny rows of nx points; the y-dimension is sharded).

    Requires ``ny %% mesh_size == 0`` and ``nx %% 128 == 0`` (lane
    alignment); n = nx*ny needs no extra padding.
    """
    ndev = mesh.devices.size
    if ny % ndev != 0:
        raise ValueError(f"ny={ny} must be divisible by mesh size {ndev}")
    n = nx * ny
    fwd = [(i, i + 1) for i in range(ndev - 1)]   # send downward
    bwd = [(i + 1, i) for i in range(ndev - 1)]   # send upward

    @partial(jax.shard_map, mesh=mesh, in_specs=P(ROWS),
             out_specs=P(ROWS))
    def matvec(x_loc):
        ny_loc = ny // ndev
        u = x_loc.reshape(ny_loc, nx)
        # halo exchange: one row in each direction (the reference's
        # mpi_send/mpi_recv of nx-sized blocks, pdsdrv1.f:466-480).
        # Communication/computation overlap: the ppermute results feed
        # ONLY the two boundary-row corrections below, so the whole
        # interior stencil is independent work XLA's latency-hiding
        # scheduler can run while the transfer is in flight (the
        # reference overlaps nothing — send/recv complete before av()).
        from_above = jax.lax.ppermute(u[-1:, :], ROWS, perm=fwd)
        from_below = jax.lax.ppermute(u[:1, :], ROWS, perm=bwd)
        # interior: all terms available locally
        y = 4.0 * u
        y = y - jnp.pad(u[1:, :], ((0, 1), (0, 0)))    # below-neighbor
        y = y - jnp.pad(u[:-1, :], ((1, 0), (0, 0)))   # above-neighbor
        y = y - jnp.pad(u[:, 1:], ((0, 0), (0, 1)))
        y = y - jnp.pad(u[:, :-1], ((0, 0), (1, 0)))
        # boundary fix-up: consume the halos (zeros at the mesh edge =
        # Dirichlet walls)
        y = y.at[:1, :].add(-from_above)
        y = y.at[-1:, :].add(-from_below)
        return y.reshape(-1).astype(x_loc.dtype)

    def apply(v, bv):
        w = matvec(v)
        return w, w

    op = Operator(n=n, dtype=np.dtype(dtype), apply=apply, bmat="I",
                  mode=1, a_apply=matvec, n_pad=n, hermitian=True)

    t = sp.diags([-np.ones(nx - 1), 2 * np.ones(nx), -np.ones(nx - 1)],
                 [-1, 0, 1])
    ty = sp.diags([-np.ones(ny - 1), 2 * np.ones(ny), -np.ones(ny - 1)],
                  [-1, 0, 1])
    a = (sp.kron(sp.identity(ny), t)
         + sp.kron(ty, sp.identity(nx))).tocsr().astype(np.float64)
    return op, a
