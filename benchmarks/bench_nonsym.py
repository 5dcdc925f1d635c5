"""Non-symmetric drivers on one GPU: per-cycle cost of the fused real
device loop (``--fused``) or of the hybrid host/device split.

Measures wall per restart cycle for the dnsimp-class 2-D convection-
diffusion operator at n ~ 1M, f32, ncv=32 — comparable to bench.py's
symmetric fused number to quantify the host-sync overhead that remains
after the single-batched-readback optimization (core/iram.py)."""
import sys
import time

import numpy as np

import _env  # noqa: E402


def main():
    jax = _env.setup("--small" in sys.argv)

    import jax.numpy as jnp
    from arpack_ng_tpu import models
    from arpack_ng_tpu.config import IRAMConfig
    from arpack_ng_tpu.core.device_realnonsym import FusedRealNonsymSolver
    from arpack_ng_tpu.core.iram import IRAMSolver
    from arpack_ng_tpu.utils.stats import Timers

    nx = 1024
    op, _ = models.convection_diffusion_2d(nx, dtype=np.float32)
    cfg = IRAMConfig(n=op.n, nev=8, ncv=32, which="LM", symmetric=False,
                     dtype=np.dtype(np.float32), n_pad=op.n_pad, tol=1e-30,
                     max_iter=10_000)

    if "--fused" in sys.argv:
        solver = FusedRealNonsymSolver(op, cfg)
        state = solver.init_state()
        out = solver._multi(state, jnp.int32(2), jnp.int32(10_000))
        state = out.state
        float(jax.device_get(state.rnorm))
        iter0 = int(jax.device_get(state.iter))
        t0 = time.perf_counter()
        out = solver._multi(state, jnp.int32(20), jnp.int32(10_000))
        state = out.state
        float(jax.device_get(state.rnorm))
        dt = time.perf_counter() - t0
        cycles = int(jax.device_get(state.iter)) - iter0
        print(f"fused real nonsym n={cfg.n} ncv=32: "
              f"{dt/max(cycles,1)*1e3:.1f} ms/cycle ({cycles} cycles, "
              f"wall {dt:.2f}s) platform={jax.devices()[0].platform}")
        return

    solver = IRAMSolver(op, cfg)
    timers = Timers()
    state = solver.init_state()
    # warmup: 2 cycles (compiles extend + tail)
    for _ in range(2):
        state, res = solver.iterate(state, timers)
        assert res is None
    cycles = 10
    t0 = time.perf_counter()
    for _ in range(cycles):
        state, res = solver.iterate(state, timers)
        assert res is None, res.info
    dt = time.perf_counter() - t0
    print(f"hybrid nonsym n={cfg.n} ncv=32: {dt/cycles*1e3:.1f} ms/cycle "
          f"({cycles} cycles, wall {dt:.2f}s) "
          f"platform={jax.devices()[0].platform}")


if __name__ == "__main__":
    main()
