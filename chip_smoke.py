"""Smoke test of the eigensolver on an NVIDIA GPU, through the public API.

    python chip_smoke.py          # one card: every single-card phase
    python chip_smoke.py --four   # a 4-card host: the row-sharded path only

Phases (one process; any failure makes the exit code non-zero):

* device   — the first JAX device must be a GPU (no CPU fallback); prints
  the card's name and power limit as ``nvidia-smi`` reports them.
* flagship — ``eigsh`` on the dssimp-class 2-D Dirichlet Laplacian at
  nx = 1024 (n = 2^20), f32, k = 8, ncv = 32, which = 'LA', tol = 1e-5:
  each value lies in the top k+8 of the closed-form spectrum, none
  exceeds lambda_max (the ghost-Ritz check), and the host float64
  residual ||A v - lambda v|| / |lambda| is <= 1e-4.
* bf16     — the same problem with bfloat16 basis storage at tol = 1e-2:
  every value within 1% of the closed-form spectrum, no ghost above
  lambda_max (1 + tol), host residual <= 2 tol.  At this tolerance the
  solve does not resolve the top of the (clustered) spectrum, so the
  distance to its top k+8 values is printed for information, beside the
  same solve with f32 storage.
* nonsym   — ``eigs`` on the 2-D convection-diffusion operator at
  nx = 512, k = 6, tol = 1e-5, f32: host residual <= 1e-4 max(1, |lambda|).
* four     — (``--four`` only) ``eigsh`` over a 4-device mesh on the halo
  ``ppermute`` Laplacian and on the GSPMD-sharded Laplacian at nx = 2048,
  both checked against the closed-form spectrum, and V split into n/4
  shards over the 4 devices.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Times printed on the way are informational and claim nothing.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

#: closed-form top-of-spectrum window the membership check searches
EXTRA = 8


# ---------------------------------------------------------------- checks

def laplacian_2d_top(nx: int, m: int, ny: int | None = None) -> np.ndarray:
    """The ``m`` largest eigenvalues (descending, with multiplicity) of
    the 2-D Dirichlet Laplacian on an nx-by-ny grid:
    ``4 - 2cos(i pi/(nx+1)) - 2cos(j pi/(ny+1))``."""
    ny = nx if ny is None else ny
    i = np.arange(1, nx + 1)[-m:]
    j = np.arange(1, ny + 1)[-m:]
    ex = 2.0 - 2.0 * np.cos(i * np.pi / (nx + 1))
    ey = 2.0 - 2.0 * np.cos(j * np.pi / (ny + 1))
    return np.sort((ex[:, None] + ey[None, :]).ravel())[::-1][:m]


def laplacian_2d_max(nx: int, ny: int | None = None) -> float:
    """True lambda_max of the 2-D Dirichlet Laplacian."""
    ny = nx if ny is None else ny
    return float(4.0 + 2.0 * np.cos(np.pi / (nx + 1))
                 + 2.0 * np.cos(np.pi / (ny + 1)))


def membership_error(vals, ref) -> float:
    """Largest relative distance from a value to its nearest reference
    value (doublets make an exact-set comparison wrong)."""
    vals = np.asarray(vals, np.float64)
    ref = np.asarray(ref, np.float64)
    d = np.abs(vals[:, None] - ref[None, :]).min(axis=1)
    return float(np.max(d / np.maximum(np.abs(vals), 1e-300)))


def laplacian_2d_distance(nx: int, vals) -> np.ndarray:
    """Relative distance from each value to the nearest eigenvalue of the
    whole closed-form nx-by-nx spectrum ``e_i + e_j``."""
    e = np.sort(2.0 - 2.0 * np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1)))
    out = []
    for v in np.asarray(vals, np.float64):
        t = v - e                            # e_j wanted near v - e_i
        pos = np.clip(np.searchsorted(e, t), 1, nx - 1)
        d = np.minimum(np.abs(e[pos] - t), np.abs(e[pos - 1] - t))
        out.append(d.min() / max(abs(v), 1e-300))
    return np.array(out)


def ghost_excess(vals, lam_max: float) -> float:
    """Largest relative excess of a value over the true lambda_max
    (> 0 only for a ghost Ritz value above the spectrum)."""
    vals = np.asarray(vals, np.float64)
    return float(np.max((vals - lam_max) / np.maximum(np.abs(vals), 1e-300)))


def residuals(a, vals, vecs, floor: float = 0.0) -> np.ndarray:
    """Host float64 ``||A v - lambda v|| / (||v|| max(floor, |lambda|))``
    per pair, against the scipy matrix the model returns."""
    vals = np.asarray(vals)
    cplx = np.iscomplexobj(vals) or np.iscomplexobj(vecs)
    wdt = np.complex128 if cplx else np.float64
    V = np.asarray(vecs, dtype=wdt)
    R = a.astype(wdt) @ V - V * vals[None, :].astype(wdt)
    scale = np.maximum(np.abs(vals), floor) * np.linalg.norm(V, axis=0)
    return np.linalg.norm(R, axis=0) / np.maximum(scale, 1e-300)


def _report(name: str, ok: bool, **fields) -> bool:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{'PASS' if ok else 'FAIL'}] {name}: {body}", flush=True)
    return ok


# ---------------------------------------------------------------- phases

def _timed_eigsh(op, **kw):
    import arpack_ng_tpu as at
    t0 = time.perf_counter()
    vals, vecs, out = at.eigsh(op, return_stats=True, **kw)
    return vals, vecs, out, time.perf_counter() - t0


def phase_flagship(nx: int = 1024, k: int = 8, ncv: int = 32,
                   tol: float = 1e-5) -> bool:
    from arpack_ng_tpu import models
    op, a = models.laplacian_2d(nx)
    kw = dict(k=k, ncv=ncv, which="LA", tol=tol)
    vals, vecs, out, t_first = _timed_eigsh(op, **kw)
    _, _, _, t_second = _timed_eigsh(op, **kw)
    member = membership_error(vals, laplacian_2d_top(nx, k + EXTRA))
    ghost = ghost_excess(vals, laplacian_2d_max(nx))
    res = float(np.max(residuals(a, vals, vecs)))
    ok = member <= 1e-4 and ghost <= 1e-4 and res <= 10 * tol
    return _report(f"flagship nx={nx} n={nx * nx}", ok,
                   nvals=len(vals), member=f"{member:.3e}",
                   ghost=f"{ghost:.3e}", residual=f"{res:.3e}",
                   first_call_s=f"{t_first:.3f}",
                   second_call_s=f"{t_second:.3f}",
                   compile_estimate_s=f"{t_first - t_second:.3f}",
                   matvecs=out.stats.nopx, restarts=out.n_iter)


def phase_bf16(nx: int = 1024, k: int = 8, ncv: int = 32,
               tol: float = 1e-2) -> bool:
    import jax.numpy as jnp
    from arpack_ng_tpu import models
    op, a = models.laplacian_2d(nx)
    kw = dict(k=k, ncv=ncv, which="LA", tol=tol)
    vals, vecs, out, t = _timed_eigsh(op, storage_dtype=jnp.bfloat16, **kw)
    vals32, _, out32, _ = _timed_eigsh(op, storage_dtype=None, **kw)
    member = float(np.max(laplacian_2d_distance(nx, vals)))
    ghost = ghost_excess(vals, laplacian_2d_max(nx))
    res = float(np.max(residuals(a, vals, vecs)))
    top = laplacian_2d_top(nx, k + EXTRA)
    ok = (member <= tol and ghost <= tol and res <= 2 * tol
          and len(vals) == k)
    return _report(f"bf16 storage nx={nx} tol={tol}", ok, nvals=len(vals),
                   member=f"{member:.3e}", ghost=f"{ghost:.3e}",
                   residual=f"{res:.3e}", call_s=f"{t:.3f}",
                   matvecs=out.stats.nopx,
                   top_window_bf16=f"{membership_error(vals, top):.3e}",
                   top_window_f32=f"{membership_error(vals32, top):.3e}",
                   matvecs_f32=out32.stats.nopx)


def phase_nonsym(nx: int = 512, k: int = 6, tol: float = 1e-5) -> bool:
    import arpack_ng_tpu as at
    from arpack_ng_tpu import models
    op, a = models.convection_diffusion_2d(nx)
    t0 = time.perf_counter()
    vals, vecs, out = at.eigs(op, k=k, tol=tol, return_stats=True)
    t = time.perf_counter() - t0
    res = float(np.max(residuals(a, vals, vecs, floor=1.0)))
    # a trailing complex-conjugate pair may add one value (dneupd)
    ok = res <= 10 * tol and len(vals) >= k
    return _report(f"nonsym nx={nx}", ok, nvals=len(vals),
                   residual=f"{res:.3e}", call_s=f"{t:.3f}",
                   matvecs=out.stats.nopx)


def _shard_report(solver, mesh, label: str) -> bool:
    """V of a fresh sharded state: one n/4 shard per mesh device."""
    st = solver.init_state()
    ndev = mesh.devices.size
    shards = st.V.addressable_shards
    devs = {sh.device for sh in shards}
    rows = [int(np.prod(sh.data.shape[1:])) for sh in shards]
    n_pad = int(np.prod(st.V.shape[1:]))
    ok = (len(devs) == ndev and set(mesh.devices.flat) == devs
          and all(r == n_pad // ndev for r in rows))
    return _report(f"four {label} V shards", ok, devices=len(devs),
                   shard_elems=sorted(set(rows)), n_pad=n_pad)


def phase_four(nx: int = 2048, k: int = 8, ncv: int = 32,
               tol: float = 1e-5) -> bool:
    import arpack_ng_tpu as at
    from arpack_ng_tpu import models
    from arpack_ng_tpu.core.device_sym import FusedSymSolver
    from arpack_ng_tpu.models.distributed import laplacian_2d_sharded
    from arpack_ng_tpu.parallel.sharding import make_mesh
    mesh = make_mesh(4)
    ref = laplacian_2d_top(nx, k + EXTRA)
    lmax = laplacian_2d_max(nx)
    ok_all = True
    for label, (op, a) in (
            ("halo ppermute", laplacian_2d_sharded(nx, nx, mesh)),
            ("GSPMD", models.laplacian_2d(nx))):
        vals, vecs, out, t = _timed_eigsh(op, k=k, ncv=ncv, which="LA",
                                          tol=tol, mesh=mesh)
        member = membership_error(vals, ref)
        ghost = ghost_excess(vals, lmax)
        res = float(np.max(residuals(a, vals, vecs)))
        peaks = [d.memory_stats().get("peak_bytes_in_use", 0)
                 if d.memory_stats() else 0 for d in mesh.devices.flat]
        ok = member <= 1e-4 and ghost <= 1e-4 and res <= 10 * tol
        ok_all &= _report(f"four {label} nx={nx}", ok, nvals=len(vals),
                          member=f"{member:.3e}", ghost=f"{ghost:.3e}",
                          residual=f"{res:.3e}", call_s=f"{t:.3f}",
                          matvecs=out.stats.nopx, peak_bytes=peaks)
        cfg = at.IRAMConfig(n=op.n, nev=k, ncv=ncv, which="LA",
                            symmetric=True, tol=tol, n_pad=op.n_pad,
                            reorth="selective")
        ok_all &= _shard_report(FusedSymSolver(op, cfg, mesh=mesh), mesh,
                                label)
    return ok_all


# ---------------------------------------------------------------- driver

def _nvidia_smi() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-device row-sharded path")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform "
              f"{devices[0].platform!r}); nothing was run", file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2

    import arpack_ng_tpu as at
    at.enable_compile_cache()
    for line in _nvidia_smi():
        print(line, flush=True)
    print(f"jax {jax.__version__} device_kind={devices[0].device_kind} "
          f"count={len(devices)}", flush=True)

    if args.four:
        phases = [phase_four]
    else:
        phases = [phase_flagship, phase_bf16, phase_nonsym]
    ok = True
    for ph in phases:
        try:
            ok &= bool(ph())
        except Exception as e:  # report every phase, then fail
            import traceback
            traceback.print_exc()
            ok &= _report(ph.__name__, False, error=repr(e)[:300])
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
