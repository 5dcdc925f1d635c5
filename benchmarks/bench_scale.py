"""Scale points beyond n=1M for the flagship fused symmetric solve on one
GPU: n = 4.2M and n = 16.8M, f32 and bf16 storage, with the HBM capacity
model.

Capacity model: the fused solver's live set is
V (ncv * n_pad * itemsize, donated in place across cycles) + a handful
of n-vectors (resid, b_resid, v_j, w, r ~ 6 * n * 4 B transient) +
O(ncv^2) noise.  At n = 16.8M, ncv = 32: V_f32 = 2.15 GB,
V_bf16 = 1.07 GB — comfortably resident; the streaming story must hold
unchanged (per-cycle time ~ linear in n at fixed ncv).

Usage: python benchmarks/bench_scale.py [--small]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

import _env  # noqa: E402


def bench_one(nx, ncv, nev, storage, cycles, reorth="dgks"):
    import jax
    import jax.numpy as jnp

    from arpack_ng_tpu import models
    from arpack_ng_tpu.config import IRAMConfig
    from arpack_ng_tpu.core.device_sym import FusedSymSolver

    op, _ = models.laplacian_2d(nx, dtype=np.float32)
    cfg = IRAMConfig(n=op.n, nev=nev, ncv=ncv, which="LA", symmetric=True,
                     dtype=np.dtype(np.float32), tol=1e-30,
                     n_pad=op.n_pad, max_iter=100_000,
                     storage_dtype=storage, reorth=reorth)
    s = FusedSymSolver(op, cfg)
    st = s.init_state(jax.random.key(5))
    out = s._multi(st, jnp.int32(2), jnp.int32(100_000))
    float(jax.device_get(out.state.rnorm))
    st = out.state
    c0 = jax.device_get(st.counts)
    it0 = int(jax.device_get(st.iter))
    t0 = time.perf_counter()
    out = s._multi(st, jnp.int32(cycles), jnp.int32(100_000))
    float(jax.device_get(out.state.rnorm))
    dt = time.perf_counter() - t0
    c1 = jax.device_get(out.state.counts)
    cyc = int(jax.device_get(out.state.iter)) - it0
    mv = int(c1.nopx) - int(c0.nopx)
    return dt / max(cyc, 1), cyc, mv, dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()

    import jax
    jax = _env.setup(args.small)

    ncv, nev = 32, 8
    sizes = [64, 128] if args.small else [1024, 2048, 4096]
    print(f"platform={jax.devices()[0].platform}  ncv={ncv} nev={nev}")
    print("| n | config | V resident | ms/cycle | ms/cycle/Mpt |")
    print("|---|---|---|---|---|")
    for nx in sizes:
        n = nx * nx
        cycles = 12 if nx >= 4096 else 20
        # dgks f32/bf16 rows (same algorithm at every n, apples-to-apples)
        # + the PRODUCTION configuration (selective reorth) to show the
        # flagship path scales
        combos = [(None, "dgks", "f32 dgks"),
                  ("bfloat16", "dgks", "bf16 dgks"),
                  (None, "selective", "f32 PRODUCTION")]
        for storage, reorth, label in combos:
            isz = 2 if storage else 4
            vgb = ncv * n * isz / 1e9
            try:
                per, cyc, mv, dt = bench_one(nx, ncv, nev, storage,
                                             cycles, reorth=reorth)
            except Exception as e:
                print(f"| {n} | {label} | {vgb:.2f} GB | "
                      f"FAILED {type(e).__name__} | |")
                continue
            print(f"| {n:>9} | {label:14s} | {vgb:5.2f} GB | "
                  f"{per*1e3:7.1f} | {per*1e3/(n/1e6):6.2f} |",
                  flush=True)


if __name__ == "__main__":
    main()
