"""Flagship-scale float64 point on one GPU: one n=1M f64 fused-symmetric
row next to the f32 flagship (the reference's native precision is
double; on an H100 f64 is native, so bytes alone predict about 2x the
f32 per-cycle cost).

Usage: python benchmarks/bench_f64_flagship.py [--small]
"""
from __future__ import annotations

import argparse

import numpy as np

import _env  # noqa: E402

from run_all import bench_sym  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    import jax
    jax = _env.setup(args.small)

    nx = 128 if args.small else 1024
    n = nx * nx
    ncv, nev = 32, 8
    plat = jax.devices()[0].platform
    print(f"## f64 flagship point (platform: {plat}, n={n}, ncv={ncv})\n")
    print("| dtype | ms/cycle | ms/matvec (np=24/cycle) | Gnnz/s | "
          "ratio vs f32 |")
    print("|---|---|---|---|---|")
    rows = {}
    for dt in (np.float32, np.float64):
        per_cycle, c = bench_sym(nx, ncv, nev, dt, cycles=12)
        per_mv = per_cycle / (ncv - nev)
        rows[dt] = per_mv
        ratio = rows[dt] / rows[np.float32]
        print(f"| {np.dtype(dt).name} | {per_cycle*1e3:.1f} "
              f"| {per_mv*1e3:.3f} | {5*n/per_mv/1e9:.2f} "
              f"| {ratio:.2f} |", flush=True)


if __name__ == "__main__":
    main()
