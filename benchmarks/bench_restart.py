"""Thick (Krylov-Schur-class) vs implicit restart on one GPU.

The two schemes stress different things: the implicit restart chases
an np-step QR bulge through H and rotates V by a dense (ncv, ncv) Q,
while the thick restart rotates by an (ncv, nev_eff) slab and
re-tridiagonalizes the kept block.  Measured under the production
configuration (selective reorth).

Protocol: chained `_multi` windows, each ended by a host readback of a
data-dependent scalar; warmup window excluded.

Usage: python benchmarks/bench_restart.py [--nx 1024] [--cycles 30]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

import _env  # noqa: E402


def bench(restart: str, nx: int, ncv: int, nev: int, cycles: int):
    import jax
    import jax.numpy as jnp

    from arpack_ng_tpu import models
    from arpack_ng_tpu.config import IRAMConfig
    from arpack_ng_tpu.core.device_sym import FusedSymSolver

    op, _ = models.laplacian_2d(nx, dtype=np.float32)
    cfg = IRAMConfig(n=op.n, nev=nev, ncv=ncv, which="LA", symmetric=True,
                     dtype=np.dtype(np.float32), n_pad=op.n_pad, tol=1e-30,
                     max_iter=100_000, restart=restart, reorth="selective")
    s = FusedSymSolver(op, cfg)
    st = s.init_state()
    out = s._multi(st, jnp.int32(3), jnp.int32(100_000))  # warmup+compile
    st = out.state
    float(jax.device_get(st.rnorm))
    it0 = int(jax.device_get(st.iter))
    t0 = time.perf_counter()
    out = s._multi(st, jnp.int32(cycles), jnp.int32(100_000))
    st = out.state
    float(jax.device_get(st.rnorm))
    dt = time.perf_counter() - t0
    c = int(jax.device_get(st.iter)) - it0
    counts = jax.device_get(st.counts)
    return dt / max(c, 1), c, int(counts.nopx), int(counts.nrorth)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--ncv", type=int, default=32)
    ap.add_argument("--nev", type=int, default=8)
    ap.add_argument("--cycles", type=int, default=30)
    ap.add_argument("--small", action="store_true",
                    help="CPU sanity run")
    args = ap.parse_args()
    _env.setup(args.small)

    print(f"| restart | ms/cycle | cycles | matvecs | reorth events |")
    print(f"|---|---|---|---|---|")
    for restart in ("implicit", "thick"):
        per, c, mv, ro = bench(restart, args.nx, args.ncv, args.nev,
                               args.cycles)
        print(f"| {restart} | {per*1e3:.2f} | {c} | {mv} | {ro} |",
              flush=True)


if __name__ == "__main__":
    main()
