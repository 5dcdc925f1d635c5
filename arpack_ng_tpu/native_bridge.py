"""Protocol layer between the C ABI (native/src/capi.cc) and the solver.

The reference exposes its Fortran core to C through ISO_C_BINDING shims
covering all four dtypes (ICB/arpack.h:10-21), plus stat/debug control
(ICB/stat_c.h:12-16, debug_c.h:6-9).  Here the C shared library embeds
CPython and calls THIS module with raw memoryviews + a JSON option
string; everything dtype- and mode-specific lives in Python where it is
unit-testable (tests/test_capi.py drives this module directly, and the
compiled client test native/tests/test_capi.c drives it through the C
symbols).

Entry points (stable protocol, keep signatures in sync with capi.cc):

* :func:`solve` — full eigensolve on a concrete dense/CSR matrix, any of
  dtypes s/d/c/z, sym or nonsym, standard/generalized/shift-invert,
  Ritz or Schur vectors, optional checkpoint dump/restart.
* :func:`get_stats` — counters + per-phase timers of the LAST solve
  (the stat_c() analog; 31 values in stat_c.h order).
* :func:`set_debug` — per-module trace levels (the debug_c() analog).
* :func:`stats_reset` — the sstats_c/sstatn_c/cstatn_c analog.
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np

_DTYPES = {"s": np.float32, "d": np.float64,
           "c": np.complex64, "z": np.complex128}

#: stats of the most recent :func:`solve` (the /timing/ common analog —
#: module-global exactly like the reference's common block).
_last_stats = None
_last_sym = True
_last_complex = False


def _np_from_buffer(buf, dtype, count=None):
    a = np.frombuffer(buf, dtype=dtype)
    return a if count is None else a[:count]


def device_count() -> int:
    """The MPI_Comm_size analog for the C ABI (atpu_device_count)."""
    import jax
    return len(jax.devices())


def solve(options: str, buf_a=None, buf_p=None, buf_i=None, buf_v=None,
          buf_m=None, buf_mp=None, buf_mi=None, buf_mv=None):
    """Run one eigensolve.  Returns a dict of plain-Python/bytes values.

    ``options`` (JSON): dtype ('s'|'d'|'c'|'z'), symmetric (bool), n,
    k, which, ncv (0=auto), maxiter (0=auto), tol, sigma_re, sigma_im,
    has_sigma, generalized (bool), schur (bool), rvec (bool),
    dump (path|''), restart (path|''), seed, dense (bool).

    Dense input: ``buf_a`` (and ``buf_m``) row-major n*n scalars of the
    dtype.  CSR input: ``buf_p`` (int64 indptr, n+1), ``buf_i`` (int64
    indices), ``buf_v`` (scalars); ``buf_mp/mi/mv`` likewise for M.
    Output vals/vecs are bytes in the problem's real scalar type, with
    separate real/imag blocks (the dneupd packed-pair convention
    flattened: C sees two parallel arrays).
    """
    global _last_stats, _last_sym, _last_complex
    import jax

    opt = json.loads(options)
    iwidth = int(opt.get("iwidth", 64))
    idt = np.int32 if iwidth == 32 else np.int64
    dt = np.dtype(_DTYPES[opt["dtype"]])
    rdt = np.float32 if dt.itemsize == 4 or dt == np.complex64 else \
        np.float64
    if dt in (np.float32, np.complex64):
        rdt = np.float32
    else:
        rdt = np.float64
    n = int(opt["n"])
    sym = bool(opt.get("symmetric", True))
    is_cplx = np.issubdtype(dt, np.complexfloating)
    if sym and is_cplx:
        sym = True                        # Hermitian path handles complex

    if rdt == np.float64:
        jax.config.update("jax_enable_x64", True)

    # ---- matrix ingestion ----
    import scipy.sparse as sp

    if buf_a is not None:
        a = _np_from_buffer(buf_a, dt, n * n).reshape(n, n).copy()
        a_in = a
    else:
        indptr = _np_from_buffer(buf_p, idt, n + 1)
        indices = _np_from_buffer(buf_i, idt)
        data = _np_from_buffer(buf_v, dt)
        a_in = sp.csr_matrix(
            (data.copy(), indices.astype(np.int64).copy(),
             indptr.astype(np.int64).copy()), shape=(n, n))
    m_in = None
    if buf_m is not None:
        m_in = _np_from_buffer(buf_m, dt, n * n).reshape(n, n).copy()
    elif buf_mp is not None:
        mp = _np_from_buffer(buf_mp, idt, n + 1)
        mi = _np_from_buffer(buf_mi, idt)
        mv = _np_from_buffer(buf_mv, dt)
        m_in = sp.csr_matrix((mv.astype(dt).copy(),
                              mi.astype(np.int64).copy(),
                              mp.astype(np.int64).copy()), shape=(n, n))

    sigma = None
    if opt.get("has_sigma"):
        sigma = complex(opt.get("sigma_re", 0.0), opt.get("sigma_im", 0.0))
        if sym and not is_cplx:
            sigma = sigma.real

    from . import api
    from .config import IRAMConfig, default_ncv
    from .core.extract import extract
    from .core.iram import IRAMSolver
    from .io import checkpoint as ckpt
    from .ops import transforms
    from .ops.operator import from_dense
    from .ops.sparse import from_scipy

    k = int(opt["k"])
    which = opt.get("which", "LM")
    tol = float(opt.get("tol", 0.0))
    ncv = int(opt.get("ncv", 0)) or default_ncv(n, k, sym)
    maxiter = int(opt.get("maxiter", 0)) or max(10 * n, 300)

    # ---- mesh (the parpack comm argument, ICB/parpack.h:10-39) ----
    # n_devices: 1 = sequential, 0 = all visible devices, k = first k.
    n_devices = int(opt.get("n_devices", 1))
    mesh = None
    if n_devices != 1:
        import math

        from .parallel.sharding import make_mesh
        avail = len(jax.devices())
        if n_devices == 0:
            n_devices = avail
        if n_devices < 0 or n_devices > avail:
            return {"info": -9998, "nconv": 0}
        mesh = make_mesh(n_devices)
    # row partition requires n_pad % n_devices == 0 (and 128-lane tiles)
    pad_mult = 128 if mesh is None else \
        128 * n_devices // math.gcd(128, n_devices)

    from .config import pad_dim
    n_pad = pad_dim(n, pad_mult)
    if sigma is not None or m_in is not None:
        build = transforms.build_sym_operator if sym \
            else transforms.build_nonsym_operator
        op = build(a_in, M=m_in, sigma=sigma, dtype=dt,
                   n_pad=n_pad if mesh is not None else 0)
    elif sp.issparse(a_in):
        op = from_scipy(a_in, hermitian=sym,
                        n_pad=n_pad if mesh is not None else 0)
    else:
        op = from_dense(a_in, hermitian=sym,
                        n_pad=n_pad if mesh is not None else 0)

    try:
        cfg = IRAMConfig(n=op.n, nev=k, ncv=min(ncv, op.n), which=which,
                         bmat=op.bmat, mode=op.mode, tol=tol,
                         max_iter=maxiter, symmetric=sym,
                         dtype=np.dtype(op.dtype), n_pad=op.n_pad,
                         seed=int(opt.get("seed", 0)))
    except ValueError as e:
        # config validation carries the reference info code in its message
        # ("reference info = -3" etc.); surface it as the C return code
        import re
        m = re.search(r"info\s*=\s*(-\d+)", str(e))
        return {"info": int(m.group(1)) if m else -9999, "nconv": 0}
    solver = IRAMSolver(op, cfg, mesh=mesh)

    state = None
    v0 = None
    if opt.get("restart"):
        state, meta = ckpt.load_state(opt["restart"], cfg=None)
        if state is None:
            v0 = meta["resid"]
    res = solver.solve(v0=v0, state=state)
    if opt.get("dump"):
        ckpt.save_state(opt["dump"], res.state, cfg)

    _last_stats = res.stats
    _last_sym = sym and not is_cplx
    _last_complex = is_cplx
    if res.info < 0:
        return {"info": int(res.info), "nconv": 0}

    rvec = bool(opt.get("rvec", True))
    # howmny='S' select mask from C (atpu_set_select): '0'/'1' string,
    # positional over the final factorization's Ritz values
    sel_s = opt.get("select") or ""
    select = None
    if sel_s:
        select = np.zeros(cfg.ncv, dtype=bool)
        m_len = min(len(sel_s), cfg.ncv)
        select[:m_len] = np.frombuffer(
            sel_s[:m_len].encode(), dtype=np.uint8) == ord("1")
    out = extract(op, cfg, res, rvec=rvec,
                  howmny="P" if opt.get("schur")
                  else ("S" if select is not None else "A"),
                  select=select)
    vals = np.atleast_1d(np.asarray(out.values))
    nconv = int(out.nconv)
    ret = {
        "info": int(out.info), "nconv": nconv,
        "vals_re": np.ascontiguousarray(vals.real, rdt).tobytes(),
        "vals_im": np.ascontiguousarray(np.imag(vals), rdt).tobytes(),
    }
    if rvec and out.vectors is not None:
        # column-major per-eigenvector blocks (C reads vector j at
        # offset j*n), matching the reference's z(ldz, nev) layout
        z = np.asarray(out.vectors)        # (n, nconv)
        ret["vecs_re"] = np.ascontiguousarray(z.real.T, rdt).tobytes()
        ret["vecs_im"] = np.ascontiguousarray(np.imag(z).T, rdt).tobytes()
    return ret


def solve_matvec(options: str, fn_addr: int, ctx_addr: int):
    """Matrix-free eigensolve driven by a C function pointer — the RCI
    (ido-loop) capability of the reference's C surface
    (ICB/arpack.h:10-21; the ido contract SRC/dsaupd.f:68-97), exposed as
    ``atpu_eigsh_matvec_*`` / ``atpu_eigs_matvec_*``.

    ``fn_addr``: address of ``void fn(atpu_int n, const T *x, T *y,
    void *ctx)`` computing ``y = A @ x``; ``ctx_addr``: opaque user
    context passed through verbatim.  Real dtypes only ('s'/'d').

    Cost model (documented honesty): every ``OP*x`` crosses
    device -> host -> C and back through ``jax.pure_callback`` — exactly
    the reference's reverse-communication data path, and exactly as
    serializing.  The solve runs on the hybrid driver (host reduced
    space, the natural host for a host-bound matvec) on the process's
    default JAX backend.  For device-speed solves, hand the C side's
    matrix to the concrete dense/CSR entry points instead.
    """
    global _last_stats, _last_sym, _last_complex
    import ctypes

    import jax

    opt = json.loads(options)
    dt = np.dtype(_DTYPES[opt["dtype"]])
    if np.issubdtype(dt, np.complexfloating):
        return {"info": -9997, "nconv": 0}   # real dtypes only
    rdt = np.float32 if dt.itemsize == 4 else np.float64
    if rdt == np.float64:
        jax.config.update("jax_enable_x64", True)
    n = int(opt["n"])
    sym = bool(opt.get("symmetric", True))

    cscalar = ctypes.c_float if dt.itemsize == 4 else ctypes.c_double
    cfunc_t = ctypes.CFUNCTYPE(None, ctypes.c_longlong,
                               ctypes.POINTER(cscalar),
                               ctypes.POINTER(cscalar), ctypes.c_void_p)
    cfn = cfunc_t(int(fn_addr))
    ctx = ctypes.c_void_p(int(ctx_addr) or None)

    from .config import IRAMConfig, default_ncv, pad_dim
    from .core.extract import extract
    from .core.iram import IRAMSolver
    from .ops.operator import from_matvec

    n_pad = pad_dim(n)

    def host_matvec(x):
        xb = np.ascontiguousarray(np.asarray(x)[:n], dt)
        y = np.zeros(n, dt)
        cfn(n, xb.ctypes.data_as(ctypes.POINTER(cscalar)),
            y.ctypes.data_as(ctypes.POINTER(cscalar)), ctx)
        out = np.zeros(n_pad, dt)
        out[:n] = y
        return out

    def matvec(v):
        return jax.pure_callback(
            host_matvec, jax.ShapeDtypeStruct((n_pad,), dt), v,
            vmap_method="sequential")

    op = from_matvec(matvec, n, dt, n_pad=n_pad, hermitian=sym)
    k = int(opt["k"])
    which = opt.get("which", "LM")
    ncv = int(opt.get("ncv", 0)) or default_ncv(n, k, sym)
    maxiter = int(opt.get("maxiter", 0)) or max(10 * n, 300)
    try:
        cfg = IRAMConfig(n=n, nev=k, ncv=min(ncv, n), which=which,
                         tol=float(opt.get("tol", 0.0)),
                         max_iter=maxiter, symmetric=sym, dtype=dt,
                         n_pad=n_pad, seed=int(opt.get("seed", 0)))
    except ValueError as e:
        import re
        m = re.search(r"info\s*=\s*(-\d+)", str(e))
        return {"info": int(m.group(1)) if m else -9999, "nconv": 0}
    res = IRAMSolver(op, cfg).solve()
    _last_stats = res.stats
    _last_sym = sym
    _last_complex = False
    if res.info < 0:
        return {"info": int(res.info), "nconv": 0}
    rvec = bool(opt.get("rvec", True))
    out = extract(op, cfg, res, rvec=rvec, howmny="A")
    vals = np.atleast_1d(np.asarray(out.values))
    ret = {
        "info": int(out.info), "nconv": int(out.nconv),
        "vals_re": np.ascontiguousarray(vals.real, rdt).tobytes(),
        "vals_im": np.ascontiguousarray(np.imag(vals), rdt).tobytes(),
    }
    if rvec and out.vectors is not None:
        z = np.asarray(out.vectors)
        ret["vecs_re"] = np.ascontiguousarray(z.real.T, rdt).tobytes()
        ret["vecs_im"] = np.ascontiguousarray(np.imag(z).T, rdt).tobytes()
    return ret


def mm_query(path: str):
    """Matrix-market probe (arpackSolver createMatrix phase 1,
    arpackSolver.hpp:176-215): [n_rows, n_cols, nnz, is_complex].
    Symmetric storage is expanded (nnz is the EXPANDED count, which is
    what the read call will deliver in CSR)."""
    import numpy as np

    from .io.matrix_market import read_matrix
    a = read_matrix(path).tocsr()
    return [int(a.shape[0]), int(a.shape[1]), int(a.nnz),
            1 if np.iscomplexobj(a.data) else 0]


def mm_read(path: str, want_complex: int, iwidth: int = 64):
    """Matrix-market CSR payload: dict of bytes (indptr, indices, data).
    Real data as float64; complex as interleaved (re, im) float64 pairs
    (C99 double _Complex layout)."""
    import numpy as np

    from .io.matrix_market import read_matrix
    a = read_matrix(path).tocsr()
    idt = np.int32 if int(iwidth) == 32 else np.int64
    data = a.data.astype(np.complex128 if want_complex else np.float64)
    return {
        "indptr": a.indptr.astype(idt).tobytes(),
        "indices": a.indices.astype(idt).tobytes(),
        "data": data.tobytes(),
    }


def check_eigvec(options: str, buf_p=None, buf_i=None, buf_v=None,
                 buf_mp=None, buf_mi=None, buf_mv=None,
                 buf_valr=None, buf_vali=None, buf_vecr=None,
                 buf_veci=None):
    """Residual verifier (arpackSolver::checkEigVec,
    arpackSolver.hpp:297-323): max_i ||A v_i - lambda_i B v_i|| /
    max(|lambda_i| ||v_i||, tiny) over the supplied pairs.

    ``options`` (JSON): dtype 'd'|'z', n, nnz, m_nnz (0 = B = I), nconv,
    diff_tol, dense (bool: buf_v/buf_mv hold row-major n*n), iwidth.
    Real dtype: vals/vecs as split re/im arrays (dneupd pair storage
    flattened); complex: buf_valr/buf_vecr interleaved, im buffers None.
    Returns {"max_res": float, "ok": 0|1}.
    """
    import numpy as np
    import scipy.sparse as sp

    opt = json.loads(options)
    dt = np.complex128 if opt["dtype"] == "z" else np.float64
    idt = np.int32 if int(opt.get("iwidth", 64)) == 32 else np.int64
    n = int(opt["n"])
    nconv = int(opt["nconv"])
    dense = bool(opt.get("dense", False))

    def load_mat(bp, bi, bv, nnz):
        if bv is None:
            return None
        if dense or bp is None:
            return _np_from_buffer(bv, dt, n * n).reshape(n, n)
        indptr = _np_from_buffer(bp, idt, n + 1).astype(np.int64)
        indices = _np_from_buffer(bi, idt, nnz).astype(np.int64)
        data = _np_from_buffer(bv, dt, nnz)
        return sp.csr_matrix((data, indices, indptr), shape=(n, n))

    a = load_mat(buf_p, buf_i, buf_v, int(opt["nnz"]))
    m = load_mat(buf_mp, buf_mi, buf_mv, int(opt.get("m_nnz", 0))) \
        if int(opt.get("m_nnz", 0)) or (dense and buf_mv is not None) \
        else None

    if opt["dtype"] == "z":
        vals = _np_from_buffer(buf_valr, np.complex128, nconv)
        vecs = _np_from_buffer(buf_vecr, np.complex128,
                               n * nconv).reshape(nconv, n)
    else:
        vr = _np_from_buffer(buf_valr, np.float64, nconv)
        vi = (_np_from_buffer(buf_vali, np.float64, nconv)
              if buf_vali is not None else np.zeros(nconv))
        vals = vr + 1j * vi
        zr = _np_from_buffer(buf_vecr, np.float64,
                             n * nconv).reshape(nconv, n)
        zi = (_np_from_buffer(buf_veci, np.float64,
                              n * nconv).reshape(nconv, n)
              if buf_veci is not None else np.zeros_like(zr))
        vecs = zr + 1j * zi

    max_res = 0.0
    for i in range(nconv):
        v = vecs[i]
        av = a @ v
        bv = m @ v if m is not None else v
        num = np.linalg.norm(av - vals[i] * bv)
        den = max(abs(vals[i]) * np.linalg.norm(v), 1e-300)
        max_res = max(max_res, float(num / den))
    tol = float(opt.get("diff_tol", 1e-6))
    return {"max_res": max_res, "ok": 1 if max_res <= tol else 0}


def get_stats():
    """stat_c() analog: 5 counters + 26 timer slots, stat_c.h:12-16 order.

    The framework's dtype-parametric timers fill the slot family matching
    the last solve (s*/n*/c*); unused families stay zero, exactly like
    the reference where only the family you ran is nonzero.
    """
    s = _last_stats
    if s is None:
        return [0] * 5 + [0.0] * 26
    t = s.timers
    fam = [t.taupd, getattr(t, "taup2", 0.0), t.taitr, t.teigt, t.tgets,
           t.tapps, t.tconv]
    zeros = [0.0] * 7
    if _last_complex:
        fams = zeros + zeros + fam
    elif _last_sym:
        fams = fam + zeros + zeros
    else:
        fams = zeros + fam + zeros
    mv = [getattr(t, "tmvopx", 0.0), getattr(t, "tmvbx", 0.0),
          t.tgetv0, t.titref, getattr(t, "trvec", 0.0)]
    return ([int(s.nopx), int(s.nbx), int(s.nrorth), int(s.nitref),
             int(s.nrstrt)] + [float(x) for x in fams + mv])


def stats_reset():
    """sstats_c/sstatn_c/cstatn_c analog."""
    global _last_stats
    _last_stats = None


def set_debug(logfil: int, ndigit: int, mgetv0: int, maupd: int,
              maup2: int, maitr: int, meigt: int, mapps: int,
              mgets: int, meupd: int):
    """debug_c() analog.

    The reference takes one level per routine per dtype family
    (debug_c.h:6-9); the dtype-parametric engine collapses the families,
    so each level applies to every dtype (pass the max of the family
    levels when porting a debug_c call)."""
    from .utils.debug import debug
    debug.ndigit = int(ndigit) or debug.ndigit
    for name, val in [("mgetv0", mgetv0), ("maupd", maupd),
                      ("maup2", maup2), ("maitr", maitr),
                      ("meigt", meigt), ("mapps", mapps),
                      ("mgets", mgets), ("meupd", meupd)]:
        setattr(debug, name, int(val))
    return 0
