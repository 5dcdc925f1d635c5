"""Distribution layer: PARPACK's row-block data distribution as JAX
shardings (the single parallelism strategy of the reference, re-expressed
once over a device mesh instead of duplicated MPI/BLACS source trees).

Reference model (SRC/dsaupd.f:331-348 "Data Distribution Note",
PARPACK/SRC/MPI/*):

* the problem dimension N is row-block partitioned: each rank owns
  ``nloc`` rows of resid/v/workd;
* every NCV-sized quantity (H, Ritz values, bounds, Q) is replicated;
* communication is exactly: allreduce of Gram-Schmidt coefficient vectors
  (pdsaitr.f:604-610), allreduce of norms (pdsaitr.f:575,672; overflow-safe
  two-phase pdnorm2.f:70-80), and reductions in pdgetv0.

Mapping: a 1-D mesh axis ``'rows'``; V is sharded on its column
(state-vector) axis, resid on its only axis, H and all scalars replicated.
The solver's contractions (``V conj @ w``, ``h @ V``, ``vdot``) lower to
XLA all-reduces (NCCL on GPUs) automatically under jit-with-shardings — the
explicit MPI_ALLREDUCE call sites of the reference become compiler-inserted
psums at exactly the same algebraic locations.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.arnoldi import FactorizationState
from ..utils.stats import OpCounts

ROWS = "rows"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D device mesh over the state-vector dimension.

    Multi-host: pass ``jax.devices()`` spanning all processes — the same
    code then runs with cross-host transfers handled by XLA, which is the analog
    of PARPACK running one rank per node (no source change, unlike the
    reference's separate MPI/BLACS trees)."""
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (ROWS,))


def row_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(ROWS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def state_shardings(mesh: Mesh, v3d: bool = False) -> FactorizationState:
    """Sharding pytree for :class:`FactorizationState`: V sharded over its
    state-vector axis (the panel axis in the 3-D per-row-tiled layout,
    arnoldi.v_is_3d), everything NCV-sized or scalar replicated."""
    rep = replicated(mesh)
    return FactorizationState(
        V=NamedSharding(mesh, P(None, ROWS, None) if v3d
                        else P(None, ROWS)),
        H=rep,
        resid=NamedSharding(mesh, P(ROWS)),
        b_resid=NamedSharding(mesh, P(ROWS)),
        rnorm=rep,
        k=rep,
        nev_cur=rep,
        iter=rep,
        info=rep,
        key=rep,
        counts=OpCounts(*([rep] * len(OpCounts._fields))),
    )
