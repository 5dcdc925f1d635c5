"""Shift-invert inner solves at scale on one GPU:

1. banded shift-invert via block cyclic reduction at n = 2^20 —
   per-apply device cost (the dgbtrs analog, EXAMPLES/BAND/dsband.f:456-463)
   and whole fused eigensolve restart cycles through it;
2. the pivoted-LU host FALLBACK per-apply cost (one pure_callback round
   trip per inner apply);
3. ILU(0)-preconditioned BiCGSTAB shift-invert eigensolve at n = 2^20
   (arpackmm --slv BiCG --slvItrPC ILU analog) vs unpreconditioned.

Protocol: one data-dependent scalar readback ends each timed window;
chained inputs.

Usage: python benchmarks/bench_banded_ilu.py [--small]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

import _env  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from jax import lax

    jax = _env.setup(args.small)

    import scipy.sparse as sp

    from arpack_ng_tpu.config import IRAMConfig, pad_dim
    from arpack_ng_tpu.core.device_sym import FusedSymSolver
    from arpack_ng_tpu.ops.bandsolve import BandedFactor, shifted_band
    from arpack_ng_tpu.ops.solvers import (ilu0_preconditioner,
                                           make_iterative_solve)
    from arpack_ng_tpu.ops.transforms import shift_invert_operator
    from arpack_ng_tpu.utils.hoist import hoisted_jit

    n = 2**14 if args.small else 2**20
    n_pad = pad_dim(n)
    dtype = np.float32
    print(f"n = {n}  platform = {jax.devices()[0].platform}", flush=True)

    # ---- 1. BCR banded shift-invert ------------------------------------
    # 1-D Laplacian tridiagonal, interior shift sigma=0.5 (indefinite
    # A - sigma I; the CPU validation case of tests/test_bandsolve.py)
    ab = np.zeros((3, n))
    ab[0, 1:] = -1.0
    ab[1, :] = 2.0
    ab[2, :-1] = -1.0
    sigma = 0.5
    ab_s, kl, ku = shifted_band(ab, 1, 1, None, 0, 0, sigma, n)
    t0 = time.perf_counter()
    fac = BandedFactor(ab_s, kl, ku, dtype=dtype, n=n)
    t_factor = time.perf_counter() - t0
    print(f"BCR factor: method={fac.method} host time {t_factor:.2f}s "
          f"probe {fac.probe_residual:.2e}", flush=True)

    rng = np.random.default_rng(0)
    x0 = jnp.asarray(rng.standard_normal(n_pad).astype(dtype))
    iters = 64 if args.small else 256

    def chained_apply(x):
        def body(i, x):
            y = fac.solve(x)
            y = y / jnp.sqrt(jnp.maximum(jnp.vdot(y, y), 1e-30))
            return y + 1e-6 * jnp.abs(y)
        x = lax.fori_loop(0, iters, body, x)
        return x, jnp.vdot(x[:8], x[:8])

    f = hoisted_jit(chained_apply)
    x, s = f(x0)
    float(jax.device_get(s))
    t0 = time.perf_counter()
    x, s = f(x)
    float(jax.device_get(s))
    per_apply = (time.perf_counter() - t0) / iters
    print(f"BCR apply (device, n=2^20 tridiag): {per_apply*1e6:.1f} us "
          f"per solve", flush=True)

    # whole eigensolve through it: fused sym, which='LM' on OP
    op_si = shift_invert_operator(
        n, dtype, fac.solve, sigma=sigma, mode=3, n_pad=n_pad,
        hermitian=True)
    cfg = IRAMConfig(n=n, nev=4, ncv=16, which="LM", symmetric=True,
                     dtype=np.dtype(dtype), tol=1e-30, n_pad=n_pad,
                     max_iter=10_000)
    sol = FusedSymSolver(op_si, cfg)
    st = sol.init_state(jax.random.key(0))
    out = sol._multi(st, jnp.int32(2), jnp.int32(10_000))
    float(jax.device_get(out.state.rnorm))
    it0 = int(jax.device_get(out.state.iter))
    t0 = time.perf_counter()
    out = sol._multi(out.state, jnp.int32(12), jnp.int32(10_000))
    float(jax.device_get(out.state.rnorm))
    dt = time.perf_counter() - t0
    cyc = int(jax.device_get(out.state.iter)) - it0
    print(f"BCR fused shift-invert eigensolve: {dt/max(cyc,1)*1e3:.1f} "
          f"ms/restart cycle ({cyc} cycles)", flush=True)
    # converged interior values sanity (eigs of tridiag near 0.5)
    ritz = np.asarray(jax.device_get(out.ritz_s))[-4:]
    lam = 1.0 / ritz + sigma
    exact = 2.0 - 2.0 * np.cos(np.pi * np.arange(1, n + 1) / (n + 1.0))
    err = [np.min(np.abs(exact - l)) for l in lam]
    print(f"  nearest-sigma eigenvalues err: {max(err):.2e}", flush=True)

    # ---- 2. the host-LU fallback per-apply cost -------------------------
    # tridiag(-1,2,-1) at sigma=2.0: the documented CR breakdown case ->
    # factor falls back to host pivoted LU, one pure_callback per apply
    ab_b, kl2, ku2 = shifted_band(ab, 1, 1, None, 0, 0, 2.0, n)
    fac_lu = BandedFactor(ab_b, kl2, ku2, dtype=dtype, n=n)
    print(f"fallback factor method: {fac_lu.method}", flush=True)
    try:
        g = hoisted_jit(lambda v: fac_lu.solve(v))
        y = g(x0)
        float(jax.device_get(y[0]))
        t0 = time.perf_counter()
        k_applies = 4
        for _ in range(k_applies):
            y = g(y / jnp.sqrt(jnp.maximum(jnp.vdot(y, y), 1e-30)))
            float(jax.device_get(y[0]))
        per_lu = (time.perf_counter() - t0) / k_applies
        print(f"LU-fallback apply (host pure_callback): "
              f"{per_lu*1e3:.2f} ms per solve "
              f"({per_lu/max(per_apply,1e-12):.0f}x the BCR device "
              f"apply)", flush=True)
    except Exception as e:
        print(f"LU-fallback apply: NOT EXECUTABLE on this backend "
              f"({type(e).__name__}: {str(e)[:90]})", flush=True)

    # ---- 3. ILU(0)-preconditioned BiCGSTAB shift-invert at n=2^20 -------
    nx = int(np.sqrt(n))
    t = sp.diags([-np.ones(nx - 1), 2 * np.ones(nx), -np.ones(nx - 1)],
                 [-1, 0, 1])
    eye = sp.identity(nx)
    a2 = (sp.kron(eye, t) + sp.kron(t, eye)).tocsr()
    sigma2 = -0.5                       # definite shift: A + 0.5 I is SPD
    shifted = (a2 - sigma2 * sp.identity(n)).tocsc()

    def shifted_mv(x):
        u = x[:n].reshape(nx, nx)
        y = (4.0 - sigma2) * u
        y = y - jnp.pad(u[1:, :], ((0, 1), (0, 0)))
        y = y - jnp.pad(u[:-1, :], ((1, 0), (0, 0)))
        y = y - jnp.pad(u[:, 1:], ((0, 0), (0, 1)))
        y = y - jnp.pad(u[:, :-1], ((0, 0), (1, 0)))
        out = jnp.zeros((n_pad,), x.dtype)
        return out.at[:n].set(y.reshape(-1).astype(x.dtype))

    t0 = time.perf_counter()
    pc_ilu = ilu0_preconditioner(shifted, n_pad=n_pad, dtype=dtype,
                                 symmetric=False)
    print(f"ILU(0) host factor: {time.perf_counter()-t0:.1f}s", flush=True)

    for name, pc, inner_it in (("ILU(0)", pc_ilu, 24), ("none", None, 24)):
        solve = make_iterative_solve(shifted_mv, symmetric=False,
                                     tol=1e-6, maxiter=inner_it,
                                     precond=pc)
        op2 = shift_invert_operator(n, dtype, solve, sigma=sigma2,
                                    mode=3, n_pad=n_pad, hermitian=True)
        cfg2 = IRAMConfig(n=n, nev=4, ncv=16, which="LM", symmetric=True,
                          dtype=np.dtype(dtype), tol=1e-4, n_pad=n_pad,
                          max_iter=200)
        sol2 = FusedSymSolver(op2, cfg2)
        st = sol2.init_state(jax.random.key(1))
        out = sol2._multi(st, jnp.int32(1), jnp.int32(200))
        float(jax.device_get(out.state.rnorm))
        it0 = int(jax.device_get(out.state.iter))
        t0 = time.perf_counter()
        out = sol2._multi(out.state, jnp.int32(6), jnp.int32(200))
        float(jax.device_get(out.state.rnorm))
        dt = time.perf_counter() - t0
        cyc = int(jax.device_get(out.state.iter)) - it0
        ritz = np.asarray(jax.device_get(out.ritz_s))[-1]
        lam = 1.0 / ritz + sigma2
        print(f"BiCGSTAB({inner_it}) + {name}: "
              f"{dt/max(cyc,1)*1e3:.1f} ms/restart cycle ({cyc} cycles), "
              f"top recovered eigenvalue {lam:.5f} "
              f"(exact smallest {2*(2-2*np.cos(np.pi/(nx+1))):.5f})",
              flush=True)


if __name__ == "__main__":
    main()
