"""Block Lanczos A/B: wall-clock-to-convergence for b in {1, 2, 4}
vs the production scalar path, on one GPU.

Two operator classes at n = 2^20, chosen to separate the two traffic
regimes:

* ``stencil``  — 2-D 5-point Laplacian (the flagship): a matrix-FREE
  operator with ~8 B/point of matvec traffic.  Blocks amortize NO
  operator bytes here, and the scalar Krylov degree grows b-times
  faster per matvec — expected NEGATIVE.
* ``dia64``    — symmetric matrix with 64 structural diagonals
  (wide-band DIA): 64 diagonals x 4 B = 256 B/point of MATRIX bytes per
  matvec, an order of magnitude above the vector traffic.  A block
  matvec reads the diagonals once per b columns — expected to win
  roughly b / (matvec inflation).

Protocol: compile/warm once, then time fresh-seed solves to the same
tolerance; convergence is defined by the same eps23-floored bound test
everywhere, and converged values are cross-checked between variants.

Usage: python benchmarks/bench_block.py [--small]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

import _env  # noqa: E402


def build_dia(n, ndiag, dtype, seed=0):
    """Symmetric diagonally-dominant matrix with ``2*ndiag+1`` structural
    diagonals, as a device DIA operator (no scipy assembly at n=1M)."""
    import jax.numpy as jnp
    from arpack_ng_tpu.config import pad_dim
    from arpack_ng_tpu.ops.operator import Operator
    from arpack_ng_tpu.ops.sparse import dia_matvec_fn

    rng = np.random.default_rng(seed)
    n_pad = pad_dim(n)
    offsets, diags = [0], [
        (2.0 * ndiag + rng.standard_normal(n)).astype(dtype)]
    step = max(1, ndiag // 8)          # spread offsets, not all adjacent
    offs = sorted({(i + 1) * step for i in range(ndiag)})
    for o in offs:
        d = (rng.standard_normal(n) * 0.5).astype(dtype)
        d[n - o:] = 0.0
        offsets += [o, -o]
        # row-aligned convention: diags[k][i] = A[i, i+off]
        diags += [d, np.roll(d, o)]
    from arpack_ng_tpu.ops.sparse import dia_block_matvec_fn
    mv = dia_matvec_fn(offsets, diags, n, n_pad)
    # lane-major (tile-interleaved) block apply: diagonals read once
    # per block
    mv_block = dia_block_matvec_fn(offsets, diags, n, n_pad)

    def apply(v, bv):
        w = mv(v)
        return w, w

    nnz = n * (2 * len(offs) + 1)
    return Operator(n=n, dtype=np.dtype(dtype), apply=apply, bmat="I",
                    mode=1, a_apply=mv, n_pad=n_pad, hermitian=True,
                    format="dia", apply_block=mv_block), nnz


def time_block(op, k, b, ncv, tol, maxiter, dtype):
    import jax
    from arpack_ng_tpu.core.block import eigsh_block
    # warm (compile)
    eigsh_block(op, k=k, block_size=b, ncv=ncv, tol=tol,
                maxiter=maxiter, dtype=dtype, seed=1)
    t0 = time.perf_counter()
    vals, _, info = eigsh_block(op, k=k, block_size=b, ncv=ncv, tol=tol,
                                maxiter=maxiter, dtype=dtype, seed=2)
    dt = time.perf_counter() - t0
    return dt, info["matvecs"], info["nconv"], np.sort(vals)[-k:]


def time_scalar(op, k, ncv, tol, maxiter, dtype):
    import arpack_ng_tpu as at
    at.eigsh(op, k=k, which="LA", ncv=ncv, tol=tol, maxiter=maxiter,
             return_eigenvectors=False, return_stats=False, seed=1)
    t0 = time.perf_counter()
    vals, out = at.eigsh(op, k=k, which="LA", ncv=ncv, tol=tol,
                         maxiter=maxiter, return_eigenvectors=False,
                         return_stats=True, seed=2)
    dt = time.perf_counter() - t0
    return dt, out.stats.nopx, np.sort(np.asarray(vals))[-k:]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--only", choices=["stencil", "dia"], default=None)
    args = ap.parse_args()
    import jax
    jax = _env.setup(args.small)
    from arpack_ng_tpu import models

    dtype = np.float32
    k, ncv, tol = 8, 32, 1e-4
    nx = 128 if args.small else 1024
    ndiag_n = 1 << 14 if args.small else 1 << 20

    plat = jax.devices()[0].platform
    print(f"## block Lanczos A/B (platform: {plat}, f32, k={k}, "
          f"ncv={ncv}, tol={tol})\n")
    print("| operator | variant | wall (s) | matvecs | ms/matvec | "
          "top value |")
    print("|---|---|---|---|---|---|")

    cases = []
    if args.only in (None, "stencil"):
        op_st, _ = models.laplacian_2d(nx, dtype=dtype)
        cases.append((f"stencil n={nx*nx}", op_st))
    if args.only in (None, "dia"):
        op_dia, nnz = build_dia(ndiag_n, 32, dtype)   # 65 diagonals
        cases.append((f"dia65 n={ndiag_n}", op_dia))

    for name, op in cases:
        dt, mv, vals = time_scalar(op, k, ncv, tol, 3000, dtype)
        print(f"| {name} | scalar eigsh (selective) | {dt:.2f} | {mv} "
              f"| {dt/mv*1e3:.3f} | {vals[-1]:.5f} |", flush=True)
        ref_top = vals[-1]
        for b in (1, 2, 4):
            dt, mv, nc, vals = time_block(op, k, b, ncv, tol, 3000, dtype)
            ok = "ok" if abs(vals[-1] - ref_top) < 1e-2 * abs(ref_top) \
                else "VALUE MISMATCH"
            print(f"| {name} | block b={b} | {dt:.2f} | {mv} "
                  f"| {dt/mv*1e3:.3f} | {vals[-1]:.5f} {ok} |", flush=True)


if __name__ == "__main__":
    main()
