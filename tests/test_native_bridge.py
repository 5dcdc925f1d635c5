"""Protocol tests for the C-ABI bridge (arpack_ng_tpu/native_bridge.py).

The compiled client tests (native/tests/test_capi.c / test_capi_cpp.cc)
drive the same module through the C symbols; these Python-side tests pin
the protocol itself — dtype coverage s/d/c/z (ICB/arpack.h:10-21 parity),
stats getter slots (stat_c.h:12-16), debug setter, checkpoint
dump/restart, Schur option and the error path — without a compile step.
"""
import json

import numpy as np
import pytest

from arpack_ng_tpu import native_bridge as nb


def _solve(opt, **bufs):
    return nb.solve(json.dumps(opt), **bufs)


def _diag_problem(n, dtype):
    a = np.diag(np.arange(1.0, n + 1)).astype(dtype)
    a[0, 1] = a[1, 0] = dtype(0.5) if not np.issubdtype(
        np.dtype(dtype), np.complexfloating) else 0.5
    return a


class TestDtypes:
    def test_d_symmetric_dense(self):
        n = 60
        a = _diag_problem(n, np.float64)
        r = _solve(dict(dtype="d", symmetric=True, n=n, k=4, which="LA",
                        tol=1e-10), buf_a=memoryview(a.tobytes()))
        vals = np.frombuffer(r["vals_re"], np.float64)
        assert r["nconv"] >= 4
        assert vals[-1] == pytest.approx(60.0, abs=1e-8)
        z = np.frombuffer(r["vecs_re"], np.float64).reshape(r["nconv"], n)
        res = [np.linalg.norm(a @ z[i] - vals[i] * z[i])
               for i in range(r["nconv"])]
        assert max(res) < 1e-7

    def test_s_symmetric_dense(self):
        n = 60
        a = _diag_problem(n, np.float32)
        r = _solve(dict(dtype="s", symmetric=True, n=n, k=4, which="LA",
                        tol=1e-5), buf_a=memoryview(a.tobytes()))
        vals = np.frombuffer(r["vals_re"], np.float32)
        assert vals[-1] == pytest.approx(60.0, abs=1e-3)

    def test_z_nonsym_dense(self, rng):
        n = 50
        a = (rng.standard_normal((n, n))
             + 1j * rng.standard_normal((n, n))) / np.sqrt(n)
        a = a.astype(np.complex128) + np.diag(np.arange(1.0, n + 1))
        r = _solve(dict(dtype="z", symmetric=False, n=n, k=3, which="LM",
                        tol=1e-10), buf_a=memoryview(a.tobytes()))
        lam = (np.frombuffer(r["vals_re"], np.float64)
               + 1j * np.frombuffer(r["vals_im"], np.float64))
        zr = np.frombuffer(r["vecs_re"], np.float64).reshape(-1, n)
        zi = np.frombuffer(r["vecs_im"], np.float64).reshape(-1, n)
        for i in range(r["nconv"]):
            v = zr[i] + 1j * zi[i]
            assert np.linalg.norm(a @ v - lam[i] * v) < 1e-7

    def test_c_nonsym_dense(self, rng):
        n = 50
        a = ((rng.standard_normal((n, n))
              + 1j * rng.standard_normal((n, n))) / np.sqrt(n)
             + np.diag(np.arange(1.0, n + 1))).astype(np.complex64)
        r = _solve(dict(dtype="c", symmetric=False, n=n, k=3, which="LM",
                        tol=1e-4), buf_a=memoryview(a.tobytes()))
        assert r["nconv"] >= 3
        vals = np.frombuffer(r["vals_re"], np.float32)
        assert vals[0] == pytest.approx(50.0, abs=0.5)

    def test_csr_input(self):
        import scipy.sparse as sp
        n = 200
        T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr()
        r = _solve(dict(dtype="d", symmetric=True, n=n, k=3, which="LA",
                        tol=1e-10),
                   buf_p=memoryview(T.indptr.astype(np.int64).tobytes()),
                   buf_i=memoryview(T.indices.astype(np.int64).tobytes()),
                   buf_v=memoryview(T.data.tobytes()))
        vals = np.frombuffer(r["vals_re"], np.float64)
        assert vals[-1] == pytest.approx(4.0, abs=1e-3)

    def test_generalized_dense(self):
        n = 80
        a = np.diag(np.arange(1.0, n + 1))
        m = np.eye(n) * 2.0
        r = _solve(dict(dtype="d", symmetric=True, n=n, k=3, which="LA",
                        tol=1e-10),
                   buf_a=memoryview(a.tobytes()),
                   buf_m=memoryview(m.tobytes()))
        vals = np.frombuffer(r["vals_re"], np.float64)
        assert vals[-1] == pytest.approx(n / 2.0, abs=1e-6)

    def test_shift_invert(self):
        n = 120
        a = np.zeros((n, n))
        for i in range(n):
            a[i, i] = 2.0
            if i + 1 < n:
                a[i, i + 1] = a[i + 1, i] = -1.0
        r = _solve(dict(dtype="d", symmetric=True, n=n, k=2, which="LM",
                        tol=1e-10, has_sigma=True, sigma_re=1.0),
                   buf_a=memoryview(a.tobytes()))
        vals = np.frombuffer(r["vals_re"], np.float64)
        assert np.all(np.abs(vals - 1.0) < 0.1)


class TestControl:
    def test_stats_family_slots(self):
        n = 40
        a = _diag_problem(n, np.float64)
        _solve(dict(dtype="d", symmetric=True, n=n, k=3, which="LA",
                    tol=1e-8), buf_a=memoryview(a.tobytes()))
        st = nb.get_stats()
        assert len(st) == 31
        assert st[0] > 0                       # nopx
        assert st[5] > 0.0                     # tsaupd (sym family)
        assert st[12] == 0.0                   # tnaupd (unused family)
        # nonsym solve moves the family
        r = _solve(dict(dtype="d", symmetric=False, n=n, k=3,
                        which="LM", tol=1e-8),
                   buf_a=memoryview(a.tobytes()))
        st = nb.get_stats()
        assert st[12] > 0.0 and st[5] == 0.0
        nb.stats_reset()
        assert nb.get_stats()[0] == 0

    def test_debug_setter(self):
        from arpack_ng_tpu.utils.debug import debug
        nb.set_debug(6, 4, 1, 2, 0, 0, 0, 0, 0, 0)
        assert debug.ndigit == 4
        assert debug.mgetv0 == 1 and debug.maupd == 2
        nb.set_debug(6, 6, 0, 0, 0, 0, 0, 0, 0, 0)

    def test_checkpoint_roundtrip(self, tmp_path):
        n = 60
        a = _diag_problem(n, np.float64)
        ck = str(tmp_path / "ck.npz")
        _solve(dict(dtype="d", symmetric=True, n=n, k=3, which="LA",
                    tol=1e-10, dump=ck), buf_a=memoryview(a.tobytes()))
        r = _solve(dict(dtype="d", symmetric=True, n=n, k=3, which="LA",
                        tol=1e-10, restart=ck),
                   buf_a=memoryview(a.tobytes()))
        assert r["nconv"] >= 3

    def test_schur_option(self, rng):
        n = 60
        a = rng.standard_normal((n, n)) * 0.2 + np.diag(
            np.arange(1.0, n + 1))
        r = _solve(dict(dtype="d", symmetric=False, n=n, k=3, which="LM",
                        tol=1e-8, schur=True),
                   buf_a=memoryview(a.tobytes()))
        assert r["nconv"] >= 3 and "vecs_re" in r

    def test_error_info_code(self):
        # k >= n triggers the reference's -3 validation
        n = 10
        a = np.eye(n)
        r = _solve(dict(dtype="d", symmetric=True, n=n, k=10, ncv=11,
                        which="LA", tol=1e-8),
                   buf_a=memoryview(a.tobytes()))
        assert r["info"] < 0 and r["nconv"] == 0


class TestMMAndVerifier:
    """arpackSolver createMatrix/checkEigVec analogs at the protocol
    level (arpackSolver.hpp:176-215, :297-323); the C clients drive the
    same functions through atpu_mm_*/atpu_check_eigvec_*."""

    def _write_mtx(self, tmp_path, n=40):
        import scipy.io as sio
        import scipy.sparse as sp
        a = sp.diags([-np.ones(n - 1), 2.0 * np.ones(n),
                      -np.ones(n - 1)], [-1, 0, 1]).tocoo()
        p = tmp_path / "a.mtx"
        sio.mmwrite(str(p), a, symmetry="symmetric")
        return str(p), a.tocsr()

    def test_query_read_roundtrip(self, tmp_path):
        path, a = self._write_mtx(tmp_path)
        n, nc, nnz, is_cplx = nb.mm_query(path)
        assert (n, nc, nnz, is_cplx) == (40, 40, a.nnz, 0)
        blobs = nb.mm_read(path, 0)
        indptr = np.frombuffer(blobs["indptr"], np.int64)
        indices = np.frombuffer(blobs["indices"], np.int64)
        data = np.frombuffer(blobs["data"], np.float64)
        import scipy.sparse as sp
        b = sp.csr_matrix((data, indices, indptr), shape=(n, n))
        assert (b != a).nnz == 0

    def test_check_eigvec(self, tmp_path):
        path, a = self._write_mtx(tmp_path)
        vals, vecs = np.linalg.eigh(a.toarray())
        k = 3
        vr = np.ascontiguousarray(vals[-k:])
        zr = np.ascontiguousarray(vecs[:, -k:].T)
        opts = json.dumps(dict(dtype="d", n=40, nnz=a.nnz, m_nnz=0,
                               nconv=k, diff_tol=1e-10))
        r = nb.check_eigvec(
            opts,
            buf_p=memoryview(a.indptr.astype(np.int64).tobytes()),
            buf_i=memoryview(a.indices.astype(np.int64).tobytes()),
            buf_v=memoryview(a.data.tobytes()),
            buf_valr=memoryview(vr.tobytes()),
            buf_vecr=memoryview(zr.tobytes()))
        assert r["ok"] == 1 and r["max_res"] < 1e-12
        vr2 = vr.copy()
        vr2[0] += 0.3
        r = nb.check_eigvec(
            opts,
            buf_p=memoryview(a.indptr.astype(np.int64).tobytes()),
            buf_i=memoryview(a.indices.astype(np.int64).tobytes()),
            buf_v=memoryview(a.data.tobytes()),
            buf_valr=memoryview(vr2.tobytes()),
            buf_vecr=memoryview(zr.tobytes()))
        assert r["ok"] == 0 and r["max_res"] > 1e-3

    def test_check_eigvec_complex_generalized_dense(self, rng):
        n, k = 30, 3
        a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        a = (a + a.conj().T) / 2
        m = np.eye(n) * 2.0
        import scipy.linalg as sla_
        vals, vecs = sla_.eigh(a, m)
        vr = np.ascontiguousarray(vals[-k:].astype(np.complex128))
        zr = np.ascontiguousarray(vecs[:, -k:].T.astype(np.complex128))
        opts = json.dumps(dict(dtype="z", n=n, nnz=0, m_nnz=0,
                               nconv=k, diff_tol=1e-9, dense=True))
        r = nb.check_eigvec(
            opts,
            buf_v=memoryview(a.astype(np.complex128).tobytes()),
            buf_mv=memoryview(m.astype(np.complex128).tobytes()),
            buf_valr=memoryview(vr.tobytes()),
            buf_vecr=memoryview(zr.tobytes()))
        assert r["ok"] == 1 and r["max_res"] < 1e-10


class TestDistributed:
    """parpack.h-analog protocol: explicit mesh size per solve
    (ICB/parpack.h:10-39; the C clients drive the same options through
    atpu_peigsh_* / atpu_device_count)."""

    def test_device_count(self):
        assert nb.device_count() >= 8   # conftest provides 8 virtual

    def test_world_and_submesh_match_sequential(self):
        n = 300
        a = _diag_problem(n, np.float64)
        vals = {}
        for nd in (1, 2, 0):            # sequential, sub-mesh, world
            r = _solve(dict(dtype="d", symmetric=True, n=n, k=4,
                            which="LM", tol=1e-10, n_devices=nd),
                       buf_a=memoryview(a.tobytes()))
            assert r["info"] == 0 and r["nconv"] >= 4
            vals[nd] = np.frombuffer(r["vals_re"], np.float64)[:4]
        np.testing.assert_allclose(vals[2], vals[1], rtol=1e-10)
        np.testing.assert_allclose(vals[0], vals[1], rtol=1e-10)

    def test_distributed_generalized_shift_invert(self):
        n = 200
        a = _diag_problem(n, np.float64)
        m = np.eye(n)
        r = _solve(dict(dtype="d", symmetric=True, n=n, k=3, which="LM",
                        tol=1e-10, has_sigma=True, sigma_re=50.2,
                        n_devices=4),
                   buf_a=memoryview(a.tobytes()),
                   buf_m=memoryview(m.tobytes()))
        assert r["info"] == 0 and r["nconv"] >= 3
        vals = np.frombuffer(r["vals_re"], np.float64)[:3]
        assert np.min(np.abs(vals - 50.0)) < 1e-8

    def test_non_pow2_mesh_padding(self):
        # 3 devices: n_pad must become a multiple of lcm(128, 3)
        n = 100
        a = _diag_problem(n, np.float64)
        r = _solve(dict(dtype="d", symmetric=True, n=n, k=3, which="LM",
                        tol=1e-10, n_devices=3),
                   buf_a=memoryview(a.tobytes()))
        assert r["info"] == 0 and r["nconv"] >= 3
        vals = np.frombuffer(r["vals_re"], np.float64)[:3]
        assert vals[-1] == pytest.approx(np.max(np.linalg.eigvalsh(a)),
                                         abs=1e-8)

    def test_oversubscription_rejected(self):
        n = 50
        a = _diag_problem(n, np.float64)
        r = _solve(dict(dtype="d", symmetric=True, n=n, k=3, which="LM",
                        tol=1e-10, n_devices=10_000),
                   buf_a=memoryview(a.tobytes()))
        assert r["info"] == -9998 and r["nconv"] == 0

    def test_iwidth32_csr(self):
        # ATPU_INTERFACE64=0 clients send 32-bit indptr/indices
        n = 80
        import scipy.sparse as sp
        a = sp.diags([-np.ones(n - 1), 2.0 * np.ones(n),
                      -np.ones(n - 1)], [-1, 0, 1]).tocsr()
        r = _solve(dict(dtype="d", symmetric=True, n=n, k=3, which="LA",
                        tol=1e-10, iwidth=32),
                   buf_p=memoryview(a.indptr.astype(np.int32).tobytes()),
                   buf_i=memoryview(a.indices.astype(np.int32).tobytes()),
                   buf_v=memoryview(a.data.astype(np.float64).tobytes()))
        assert r["info"] == 0 and r["nconv"] >= 3
        vals = np.frombuffer(r["vals_re"], np.float64)
        exact = 2.0 - 2.0 * np.cos(np.pi * np.arange(n, n - 3, -1)
                                   / (n + 1))
        np.testing.assert_allclose(np.sort(vals[-3:]), np.sort(exact),
                                   rtol=1e-8)


class TestSolveMatvec:
    """Matrix-free solve through the C-function-pointer protocol
    (native_bridge.solve_matvec; the ido-loop capability of
    ICB/arpack.h:10-21 / SRC/dsaupd.f:68-97) driven from Python via a
    ctypes-manufactured C callback — the same address-based path the
    compiled C client uses."""

    def _tridiag_callback(self, n, cscalar):
        import ctypes
        cfunc_t = ctypes.CFUNCTYPE(None, ctypes.c_longlong,
                                   ctypes.POINTER(cscalar),
                                   ctypes.POINTER(cscalar),
                                   ctypes.c_void_p)

        def py_matvec(nn, xp, yp, ctx):
            x = np.ctypeslib.as_array(xp, shape=(nn,))
            y = np.ctypeslib.as_array(yp, shape=(nn,))
            y[:] = 2.0 * x
            y[:-1] -= x[1:]
            y[1:] -= x[:-1]

        cb = cfunc_t(py_matvec)
        addr = ctypes.cast(cb, ctypes.c_void_p).value
        return cb, addr

    def test_sym_d_matches_analytic(self):
        import ctypes
        import json
        from arpack_ng_tpu import native_bridge as nb
        n, k = 300, 4
        cb, addr = self._tridiag_callback(n, ctypes.c_double)
        opt = json.dumps({"dtype": "d", "symmetric": True, "n": n,
                          "k": k, "which": "LA", "ncv": 20,
                          "maxiter": 2000, "tol": 1e-10, "rvec": True})
        ret = nb.solve_matvec(opt, addr, 0)
        assert ret["info"] == 0
        assert ret["nconv"] >= k
        vals = np.sort(np.frombuffer(ret["vals_re"], np.float64)[:k])
        analytic = 2.0 - 2.0 * np.cos(
            np.pi * np.arange(1, n + 1) / (n + 1))
        np.testing.assert_allclose(vals, np.sort(analytic)[-k:],
                                   rtol=1e-8)
        # residual oracle on the returned vectors (column blocks)
        vecs = np.frombuffer(ret["vecs_re"], np.float64).reshape(-1, n)
        v0 = vecs[np.argsort(
            np.frombuffer(ret["vals_re"], np.float64)[:k])[-1]]
        lam = vals[-1]
        av = 2.0 * v0
        av[:-1] -= v0[1:]
        av[1:] -= v0[:-1]
        assert np.linalg.norm(av - lam * v0) < 1e-7

    def test_nonsym_s(self):
        import ctypes
        import json
        from arpack_ng_tpu import native_bridge as nb
        n, k = 200, 3
        cfunc_t = ctypes.CFUNCTYPE(None, ctypes.c_longlong,
                                   ctypes.POINTER(ctypes.c_float),
                                   ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_void_p)

        def py_matvec(nn, xp, yp, ctx):
            x = np.ctypeslib.as_array(xp, shape=(nn,))
            y = np.ctypeslib.as_array(yp, shape=(nn,))
            c = 0.2
            y[:] = 2.0 * x
            y[:-1] += (-1.0 + c) * x[1:]
            y[1:] += (-1.0 - c) * x[:-1]

        cb = cfunc_t(py_matvec)
        addr = ctypes.cast(cb, ctypes.c_void_p).value
        opt = json.dumps({"dtype": "s", "symmetric": False, "n": n,
                          "k": k, "which": "LM", "ncv": 20,
                          "maxiter": 2000, "tol": 1e-4, "rvec": False})
        ret = nb.solve_matvec(opt, addr, 0)
        assert ret["info"] == 0
        assert ret["nconv"] >= k
        vr = np.frombuffer(ret["vals_re"], np.float32)[:k]
        # spectrum: 2 - 2*sqrt(1-c^2)*cos(j pi/(n+1)) — top near 3.98
        assert abs(np.max(np.abs(vr)) - (2 + 2 * np.sqrt(1 - 0.04))) < 2e-2

    def test_complex_rejected(self):
        import json
        from arpack_ng_tpu import native_bridge as nb
        ret = nb.solve_matvec(json.dumps({"dtype": "z", "n": 10, "k": 2}),
                              0, 0)
        assert ret["info"] == -9997

    def test_runs_on_default_backend(self, monkeypatch):
        """The matrix-free path solves on the process's own JAX backend:
        it must not switch ``jax_platforms`` (no hidden CPU)."""
        import ctypes
        import json

        import jax
        from arpack_ng_tpu import native_bridge as nb
        seen = []
        real_update = jax.config.update

        def spy(name, value):
            seen.append(name)
            return real_update(name, value)

        monkeypatch.setattr(jax.config, "update", spy)
        n, k = 120, 2
        cb, addr = self._tridiag_callback(n, ctypes.c_double)
        opt = json.dumps({"dtype": "d", "symmetric": True, "n": n,
                          "k": k, "which": "LA", "ncv": 12,
                          "maxiter": 2000, "tol": 1e-10, "rvec": False})
        ret = nb.solve_matvec(opt, addr, 0)
        assert ret["info"] == 0 and ret["nconv"] >= k
        assert "jax_platforms" not in seen
        vals = np.sort(np.frombuffer(ret["vals_re"], np.float64)[:k])
        analytic = 2.0 - 2.0 * np.cos(np.pi * np.arange(1, n + 1) / (n + 1))
        np.testing.assert_allclose(vals, np.sort(analytic)[-k:], rtol=1e-8)
