"""Decompose the selective-Lanczos step into its HBM passes (one GPU).

The production solver (partial-reorth Lanczos, core/arnoldi.py:_step_pro)
is timed against its own traffic model in bench.py.  This bench isolates
each constituent pass so a gap can be attributed and attacked:

  stencil      y = A x                       (5-pt Laplacian, ~8 B/pt)
  step         the full recurrence step body (normalize + DUS into V +
               stencil + alpha/wnorm + 3-term update + rnorm)
  step_nodus   same without the V row write / v_{j-1} read
  reorth       one full CGS pass pair at ncv rows (proj + update + norm)
  rotation     V <- Q^T V  (the end-of-cycle basis rotation)

Protocol: one jitted fori_loop dispatch per timed window, ended by a
host readback of a data-dependent scalar; nonlinear chaining
(y + 1e-6*|y|) so XLA cannot hoist or strength-reduce; window sizes make
the per-dispatch overhead <= ~10% of the window.  Speed of light (SoL)
is the model's bytes over the card's published HBM bandwidth
(bench.HBM_PEAK, keyed by device_kind).

Usage: python benchmarks/bench_step_breakdown.py [--nx 1024] [--small]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

import _env


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--ncv", type=int, default=32)
    ap.add_argument("--small", action="store_true",
                    help="CPU sanity run (no SoL: no device peak)")
    args = ap.parse_args()

    jax = _env.setup(args.small)
    import jax.numpy as jnp
    from jax import lax

    if args.small:
        BW = float("nan")
    else:
        from bench import HBM_PEAK
        BW = HBM_PEAK[jax.devices()[0].device_kind]

    nx, ncv = args.nx, args.ncv
    n = nx * nx

    def stencil(x):
        u = x.reshape(nx, nx)
        y = 4.0 * u
        y = y - jnp.pad(u[1:, :], ((0, 1), (0, 0)))
        y = y - jnp.pad(u[:-1, :], ((1, 0), (0, 0)))
        y = y - jnp.pad(u[:, 1:], ((0, 0), (0, 1)))
        y = y - jnp.pad(u[:, :-1], ((0, 0), (1, 0)))
        return y.reshape(-1)

    def chain(y):
        return y + 1e-6 * jnp.abs(y)

    rng = np.random.default_rng(0)
    x0 = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    V0 = jnp.asarray(rng.standard_normal((ncv, n)).astype(np.float32)
                     * 1e-3)

    results = {}

    def timeit(name, make_fn, state, model_bytes, iters):
        """make_fn(iters) -> jitted fn: state -> (state, scalar)."""
        f = jax.jit(make_fn(iters))
        st, s = f(state)                        # compile + warmup
        float(jax.device_get(s))
        t0 = time.perf_counter()
        st, s = f(st)                           # timed, chained input
        float(jax.device_get(s))
        wall = time.perf_counter() - t0
        per_it = wall / iters
        sol = model_bytes / BW
        eff = sol / per_it
        results[name] = (per_it, sol, eff)
        print(f"{name:14s} {per_it*1e6:9.1f} us/iter  "
              f"model {model_bytes/1e6:7.1f} MB -> SoL {sol*1e6:7.1f} us  "
              f"eff {eff:5.2f}   (window {iters} it, "
              f"{wall*1e3:.0f} ms)", flush=True)
        return st

    # 1. bare stencil matvec ------------------------------------------------
    def mk_stencil(iters):
        def f(x):
            def body(i, x):
                return chain(stencil(x))
            x = lax.fori_loop(0, iters, body, x)
            return x, jnp.vdot(x[:8], x[:8])
        return f

    timeit("stencil", mk_stencil, x0, 8 * n, iters=4096)

    # 2. full selective step body ------------------------------------------
    def mk_step(iters):
        def f(c):
            def body(i, c):
                V, r, rn = c
                j = jnp.mod(i, ncv)
                inv = 1.0 / jnp.maximum(rn, 1e-30)
                v = r * inv
                V = lax.dynamic_update_slice(V, v[None, :], (j, 0))
                w = stencil(v)
                alpha = jnp.vdot(v, w)
                vjm1 = lax.dynamic_index_in_dim(
                    V, jnp.maximum(j - 1, 0), axis=0, keepdims=False)
                r2 = w - alpha * v - rn * vjm1
                rn2 = jnp.sqrt(jnp.vdot(r2, r2))
                return V, chain(r2), rn2
            V, r, rn = lax.fori_loop(0, iters, body, c)
            return (V, r, rn), rn
        return f

    timeit("step", mk_step, (V0, x0, jnp.float32(1.0)), 32 * n, iters=2048)

    # 3. step without the basis write / v_{j-1} read ------------------------
    def mk_step_nodus(iters):
        def f(c):
            def body(i, c):
                r, rp, rn = c
                inv = 1.0 / jnp.maximum(rn, 1e-30)
                v = r * inv
                w = stencil(v)
                alpha = jnp.vdot(v, w)
                r2 = w - alpha * v - rn * rp
                rn2 = jnp.sqrt(jnp.vdot(r2, r2))
                return chain(r2), v, rn2
            r, rp, rn = lax.fori_loop(0, iters, body, c)
            return (r, rp, rn), rn
        return f

    timeit("step_nodus", mk_step_nodus, (x0, x0, jnp.float32(1.0)),
           24 * n, iters=2048)

    # 4. one full-CGS reorth pass pair at ncv rows ---------------------------
    def mk_reorth(iters):
        def f(c):
            def body(i, c):
                V, r = c
                s = V @ r
                r2 = r - s @ V
                rn2 = jnp.vdot(r2, r2)
                return V, chain(r2 / jnp.sqrt(jnp.maximum(rn2, 1e-30)))
            V, r = lax.fori_loop(0, iters, body, c)
            return (V, r), jnp.vdot(r[:8], r[:8])
        return f

    timeit("reorth", mk_reorth, (V0, x0), (2 * ncv * 4) * n, iters=512)

    # 5. basis rotation V <- Q^T V -------------------------------------------
    Q0 = jnp.asarray(np.linalg.qr(
        rng.standard_normal((ncv, ncv)))[0].astype(np.float32))

    def mk_rot(iters):
        def f(c):
            def body(i, c):
                V, Q = c
                V2 = Q.T @ V
                return V2 + 1e-6 * jnp.abs(V2), Q
            V, Q = lax.fori_loop(0, iters, body, c)
            return (V, Q), jnp.vdot(V[0, :8], V[0, :8])
        return f

    timeit("rotation", mk_rot, (V0, Q0), (2 * ncv * 4) * n, iters=256)

    print(f"platform={jax.devices()[0].platform}")


if __name__ == "__main__":
    main()
