"""Reproducible benchmark suite (markdown report to stdout).

Measures, timing each window to a host readback that waits for the
device, in one process:

  * fused symmetric eigensolve cycles (the bench.py headline)
  * mixed-precision (bf16 storage) symmetric cycles
  * fused non-symmetric (real-arithmetic device loop) cycles
  * banded shift-invert apply
  * the irregular corpus tier (bench_corpus.py)
  * DIA SpMV

Usage:  python benchmarks/run_all.py [--small]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

import _env
import bench_corpus


def _force(x):
    import jax
    return float(jax.device_get(x))


def bench_sym(nx, ncv, nev, dtype, storage=None, cycles=20):
    import jax
    import jax.numpy as jnp

    from arpack_ng_tpu import models
    from arpack_ng_tpu.config import IRAMConfig
    from arpack_ng_tpu.core.device_sym import FusedSymSolver

    op, _ = models.laplacian_2d(nx, dtype=dtype)
    cfg = IRAMConfig(n=op.n, nev=nev, ncv=ncv, which="LA", symmetric=True,
                     dtype=np.dtype(dtype), n_pad=op.n_pad, tol=1e-30,
                     max_iter=100_000, storage_dtype=storage)
    s = FusedSymSolver(op, cfg)
    st = s.init_state()
    out = s._multi(st, jnp.int32(2), jnp.int32(100_000))
    st = out.state
    _force(st.rnorm)
    it0 = int(_force(st.iter))
    t0 = time.perf_counter()
    out = s._multi(st, jnp.int32(cycles), jnp.int32(100_000))
    st = out.state
    _force(st.rnorm)
    dt = time.perf_counter() - t0
    c = int(_force(st.iter)) - it0
    return dt / max(c, 1), c


def bench_nonsym(nx, ncv, nev, cycles=20):
    """Fused REAL non-symmetric cycles (the eigs 'auto' default path)."""
    import jax
    import jax.numpy as jnp

    from arpack_ng_tpu import models
    from arpack_ng_tpu.config import IRAMConfig
    from arpack_ng_tpu.core.device_realnonsym import FusedRealNonsymSolver

    op, _ = models.convection_diffusion_2d(nx, rho=100.0,
                                           dtype=np.float32)
    cfg = IRAMConfig(n=op.n, nev=nev, ncv=ncv, which="LM",
                     symmetric=False, dtype=np.dtype(np.float32),
                     n_pad=op.n_pad, tol=1e-30, max_iter=100_000)
    s = FusedRealNonsymSolver(op, cfg)
    st = s.init_state()
    out = s._multi(st, jnp.int32(2), jnp.int32(100_000))
    st = out.state
    _force(st.rnorm)
    it0 = int(_force(st.iter))
    t0 = time.perf_counter()
    out = s._multi(st, jnp.int32(cycles), jnp.int32(100_000))
    st = out.state
    _force(st.rnorm)
    dt = time.perf_counter() - t0
    c = int(_force(st.iter)) - it0
    return dt / max(c, 1), c


def bench_spmv(n, iters=50):
    import jax
    import jax.numpy as jnp

    from arpack_ng_tpu.ops.sparse import dia_matvec_fn

    nx = int(np.sqrt(n))
    offs = [-nx, -1, 0, 1, nx]
    rng = np.random.default_rng(0)
    diags = []
    for o in offs:
        arr = np.zeros(n, np.float32)
        m = n - abs(o)
        if o >= 0:
            arr[:m] = rng.standard_normal(m)
        else:
            arr[-o:] = rng.standard_normal(m)
        diags.append(arr)
    x0 = jnp.asarray(rng.standard_normal(n).astype(np.float32))

    def chain(f):
        g = jax.jit(lambda v: f(v) / 127.3)
        y = g(x0)
        _force(jnp.vdot(y[:2], y[:2]))
        t0 = time.perf_counter()
        y = x0
        for _ in range(iters):
            y = g(y)
        _force(jnp.vdot(y[:2], y[:2]))
        return (time.perf_counter() - t0) / iters

    return chain(dia_matvec_fn(offs, diags, n, n)), 5 * n


def bench_banded(n, iters=64):
    """BCR banded shift-invert apply (stride-free DIA device form)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from arpack_ng_tpu.config import pad_dim
    from arpack_ng_tpu.ops.bandsolve import BandedFactor, shifted_band
    from arpack_ng_tpu.utils.hoist import hoisted_jit

    ab = np.zeros((3, n))
    ab[0, 1:] = -1.0
    ab[1, :] = 2.0
    ab[2, :-1] = -1.0
    ab_s, kl, ku = shifted_band(ab, 1, 1, None, 0, 0, 0.5, n)
    fac = BandedFactor(ab_s, kl, ku, dtype=np.float32, n=n)
    n_pad = pad_dim(n)
    x0 = jnp.asarray(np.random.default_rng(0)
                     .standard_normal(n_pad).astype(np.float32))

    def chained(x):
        def body(i, x):
            y = fac.solve(x)
            y = y / jnp.sqrt(jnp.maximum(jnp.vdot(y, y), 1e-30))
            return y + 1e-6 * jnp.abs(y)
        x = lax.fori_loop(0, iters, body, x)
        return x, jnp.vdot(x[:8], x[:8])

    f = hoisted_jit(chained)
    x, s = f(x0)
    _force(s)
    t0 = time.perf_counter()
    x, s = f(x)
    _force(s)
    return (time.perf_counter() - t0) / iters, fac.method


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="CPU-sized problems (sanity run)")
    args = ap.parse_args()

    jax = _env.setup(args.small)

    plat = jax.devices()[0].platform
    nx = 128 if args.small else 1024
    nx_ns = 64 if args.small else 512
    print(f"## arpack_ng_tpu benchmarks  (platform: {plat}, "
          f"n_sym={nx*nx}, n_nonsym={nx_ns*nx_ns})\n")
    print("| benchmark | per restart cycle / matvec | note |")
    print("|---|---|---|")

    dt, c = bench_sym(nx, 32, 8, np.float32)
    print(f"| sym fused f32 | {dt*1e3:.1f} ms/cycle | {c} cycles |")
    dt, c = bench_sym(nx, 32, 8, np.float32, storage="bfloat16")
    print(f"| sym fused f32 + bf16 storage | {dt*1e3:.1f} ms/cycle "
          f"| {c} cycles |")
    dt, c = bench_nonsym(nx_ns, 32, 8)
    print(f"| nonsym fused real f32 | {dt*1e3:.1f} ms/cycle "
          f"| {c} cycles |")
    try:
        dtb, meth = bench_banded(4096 if args.small else (1 << 20))
        print(f"| banded shift-invert apply ({meth}) | {dtb*1e6:.0f} "
              f"us/solve | n={4096 if args.small else 1 << 20} tridiag |")
    except Exception as e:
        print(f"| banded shift-invert apply | n/a | {type(e).__name__} |")
    print()
    bench_corpus.table(args.small)
    print()
    v, nnz = bench_spmv(nx * nx)
    print("| spmv | per matvec | rate |")
    print("|---|---|---|")
    print(f"| dia (XLA) | {v*1e3:.3f} ms | {nnz/v/1e9:.2f} Gnnz/s |")


if __name__ == "__main__":
    main()
