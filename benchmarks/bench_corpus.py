"""On-GPU eigensolve throughput per IRREGULAR structure class (the
SuiteSparse-class corpus of models/corpus.py).

For each class the matrix goes through ``from_scipy(format='auto')``
exactly as a user's would; the fused symmetric solver then runs
fixed-cycle windows at floor tolerance (the bench.py measurement
protocol: windows from several seeds) and the
sustained operator throughput is reported as Gnnz/s of the REAL nnz —
for the hybrid format that measures the padding policy, not just the
gather kernel.

Usage: python benchmarks/bench_corpus.py [--small]
Prints a markdown table: class | n | nnz | format | Gnnz/s.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

import _env



def measure(op, ncv=32, nev=8, target_cycles=12):
    import jax
    import jax.numpy as jnp
    from arpack_ng_tpu.config import IRAMConfig
    from arpack_ng_tpu.core.device_sym import FusedSymSolver

    cfg = IRAMConfig(n=op.n, nev=nev, ncv=ncv, which="LM", symmetric=True,
                     dtype=np.dtype(op.dtype), tol=1e-30, n_pad=op.n_pad,
                     max_iter=10_000, reorth="selective")
    solver = FusedSymSolver(op, cfg)
    state = solver.init_state(jax.random.key(7))
    out = solver._multi(state, jnp.int32(2), jnp.int32(10_000))
    jax.block_until_ready(out)                      # warmup/compile
    tot_dt, tot_mv, seed = 0.0, 0, 100
    cycles = 0
    while cycles < target_cycles:
        state = solver.init_state(jax.random.key(seed))
        seed += 1
        c0 = jax.device_get(state.counts)
        it0 = int(jax.device_get(state.iter))
        t0 = time.perf_counter()
        out = solver._multi(state, jnp.int32(target_cycles),
                            jnp.int32(10_000))
        jax.block_until_ready(out)
        tot_dt += time.perf_counter() - t0
        c1 = jax.device_get(out.state.counts)
        cycles += int(jax.device_get(out.state.iter)) - it0
        tot_mv += int(c1.nopx) - int(c0.nopx)
    return tot_dt, tot_mv


def table(small: bool) -> None:
    """Print the corpus table (the device is already set up)."""
    import jax
    from arpack_ng_tpu.models import corpus
    from arpack_ng_tpu.ops.sparse import from_scipy

    if small:
        cases = [("fem-p1", corpus.fem_triangulation(12_000)),
                 ("powerlaw", corpus.powerlaw_graph(12_000)),
                 ("saddle-kkt", corpus.saddle_point(70))]
    else:
        cases = [("fem-p1", corpus.fem_triangulation(200_000)),
                 ("powerlaw", corpus.powerlaw_graph(200_000)),
                 ("saddle-kkt", corpus.saddle_point(320))]

    plat = jax.devices()[0].platform
    print(f"## irregular-corpus eigensolve throughput (platform: {plat})\n")
    print("| class | n | nnz | auto format | per-matvec | Gnnz/s (real nnz) |")
    print("|---|---|---|---|---|---|")
    for name, a in cases:
        op = from_scipy(a.astype(np.float32), hermitian=True)
        dt, mv = measure(op)
        per = dt / max(mv, 1)
        gnnz = a.nnz * mv / dt / 1e9
        print(f"| {name} | {a.shape[0]} | {a.nnz} | {op.format} "
              f"| {per*1e3:.2f} ms | {gnnz:.2f} |", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    _env.setup(args.small)
    table(args.small)


if __name__ == "__main__":
    main()
