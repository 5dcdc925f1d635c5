// Full-solver C ABI: the ICB (Xsaupd_c/Xseupd_c) analog for the JAX
// framework, covering all four dtypes s/d/c/z plus stat/debug control and
// checkpoint dump/restart — the surface of ICB/arpack.h:10-21,
// stat_c.h:12-16 and debug_c.h:6-9.  The reference exposes Fortran through
// ISO_C_BINDING shims; here the solver core is Python/JAX, so this shared
// library embeds a CPython interpreter and marshals raw buffers + a JSON
// option string to arpack_ng_tpu.native_bridge (where all dtype/mode logic
// lives and is unit-tested from Python).
//
// Granularity note: the reference's RCI-level capability (caller-supplied
// operator, SRC/dsaupd.f:68-97) IS covered — atpu_*_matvec_* take a C
// function pointer + context, bridged per call through
// jax.pure_callback (run_solve_matvec below).  Per-matvec host round
// trips make that the documented SLOW path (the same serialization the
// reference's ido loop imposes); the concrete-matrix entry points
// (dense and CSR, standard/generalized/shift-invert, Ritz or Schur
// vectors) are the device-speed surface.

#include "arpack_tpu_solver.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <dlfcn.h>

#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>

namespace {

std::mutex g_mu;
bool g_inited = false;
std::string g_dump;     // checkpoint path for the NEXT solve ("" = off)
std::string g_restart;  // restart path for the NEXT solve
std::string g_select;   // howmny='S' select mask ('0'/'1' chars) for the
                        // NEXT solve ("" = howmny 'A'/'P' per `schur`)

// Locate the arpack_ng_tpu package relative to this shared library
// (native/build/lib*.so -> repo root two levels up), plus any paths from
// $ARPACK_TPU_PATH, and put them on sys.path of the embedded interpreter.
void add_package_paths() {
  std::string code =
      "import sys, os\n"
      "for _p in os.environ.get('ARPACK_TPU_PATH', '').split(':'):\n"
      "    if _p and _p not in sys.path:\n"
      "        sys.path.insert(0, _p)\n";
  Dl_info info;
  if (dladdr(reinterpret_cast<void *>(&add_package_paths), &info)
      && info.dli_fname) {
    std::string so(info.dli_fname);
    auto cut = so.find_last_of('/');
    if (cut != std::string::npos) {
      std::string dir = so.substr(0, cut);  // native/build
      code += "for _p in ['" + dir + "/../..', '" + dir + "']:\n"
              "    _p = os.path.abspath(_p)\n"
              "    if _p not in sys.path:\n"
              "        sys.path.insert(0, _p)\n";
    }
  }
  PyRun_SimpleString(code.c_str());
}

bool ensure_python() {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    add_package_paths();
  } else if (!g_inited) {
    add_package_paths();
  }
  g_inited = true;
  return true;
}

PyObject *bridge_attr(const char *name) {
  PyObject *mod = PyImport_ImportModule("arpack_ng_tpu.native_bridge");
  if (!mod) { PyErr_Print(); return nullptr; }
  PyObject *fn = PyObject_GetAttrString(mod, name);
  Py_DECREF(mod);
  if (!fn) PyErr_Print();
  return fn;
}

PyObject *mv_or_none(const void *ptr, size_t bytes) {
  if (ptr == nullptr) { Py_RETURN_NONE; }
  return PyMemoryView_FromMemory(
      reinterpret_cast<char *>(const_cast<void *>(ptr)),
      static_cast<Py_ssize_t>(bytes), PyBUF_READ);
}

bool json_safe(const char *s) {
  for (const char *p = s; *p; ++p)
    if (*p == '"' || *p == '\\' || *p < 0x20) return false;
  return true;
}

size_t scalar_bytes(char dtype) {
  switch (dtype) {
    case 's': return 4;
    case 'd': return 8;
    case 'c': return 8;   // interleaved complex64
    default:  return 16;  // interleaved complex128
  }
}

// Copy a bytes object out into dst (dst may be null => skip).
void copy_bytes(PyObject *dict, const char *key, void *dst, size_t cap) {
  if (!dst) return;
  PyObject *obj = PyDict_GetItemString(dict, key);  // borrowed
  if (!obj || !PyBytes_Check(obj)) return;
  char *buf; Py_ssize_t len;
  PyBytes_AsStringAndSize(obj, &buf, &len);
  std::memcpy(dst, buf, std::min(static_cast<size_t>(len), cap));
}

// Interleave separate re/im byte blocks into a complex output buffer.
template <typename T>
void interleave(PyObject *dict, const char *rkey, const char *ikey,
                T *dst, size_t count) {
  if (!dst) return;
  PyObject *ro = PyDict_GetItemString(dict, rkey);
  PyObject *io = PyDict_GetItemString(dict, ikey);
  if (!ro || !io) return;
  char *rb, *ib; Py_ssize_t rl, il;
  PyBytes_AsStringAndSize(ro, &rb, &rl);
  PyBytes_AsStringAndSize(io, &ib, &il);
  const T *re = reinterpret_cast<const T *>(rb);
  const T *im = reinterpret_cast<const T *>(ib);
  size_t m = std::min(count, static_cast<size_t>(rl) / sizeof(T));
  for (size_t j = 0; j < m; ++j) {
    dst[2 * j] = re[j];
    dst[2 * j + 1] = im[j];
  }
}

// The generic solve runner.  Real dtypes write split re/im outputs;
// complex dtypes write interleaved outputs.  n_devices follows the
// parpack comm argument semantics (see arpack_tpu_solver.h): 1 =
// sequential, 0 = whole visible device set, k = first k devices.
atpu_int run_solve(char dtype, int symmetric, int schur, atpu_int n,
                   const void *dense_a, const atpu_int *indptr,
                   const atpu_int *indices, const void *data, atpu_int nnz,
                   const void *dense_m, atpu_int nev, const char *which,
                   double sigma_re, double sigma_im, int has_sigma,
                   double tol, atpu_int ncv, atpu_int max_iter,
                   void *evals_re, void *evals_im, void *evecs_re,
                   void *evecs_im, atpu_int *nconv_out,
                   atpu_int n_devices = 1) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (!ensure_python()) return -9999;
  if (!which || std::strlen(which) != 2 || !json_safe(which)) return -5;
  PyGILState_STATE gil = PyGILState_Ensure();
  atpu_int rc = 0;
  do {
    char opts[1024];
    std::snprintf(
        opts, sizeof(opts),
        "{\"dtype\":\"%c\",\"symmetric\":%s,\"schur\":%s,\"n\":%lld,"
        "\"k\":%lld,\"which\":\"%s\",\"ncv\":%lld,\"maxiter\":%lld,"
        "\"tol\":%.17g,\"sigma_re\":%.17g,\"sigma_im\":%.17g,"
        "\"has_sigma\":%s,\"rvec\":%s,\"dump\":\"%s\",\"restart\":\"%s\","
        "\"n_devices\":%lld,\"iwidth\":%d}",
        dtype, symmetric ? "true" : "false", schur ? "true" : "false",
        static_cast<long long>(n), static_cast<long long>(nev), which,
        static_cast<long long>(ncv), static_cast<long long>(max_iter), tol,
        sigma_re, sigma_im, has_sigma ? "true" : "false",
        (evecs_re != nullptr) ? "true" : "false", g_dump.c_str(),
        g_restart.c_str(), static_cast<long long>(n_devices),
        static_cast<int>(sizeof(atpu_int) * 8));
    g_dump.clear();
    g_restart.clear();
    std::string opts_s(opts);
    if (!g_select.empty()) {
      // inject the select mask (howmny='S', ICB/arpack.hpp:44-48): a
      // compact '0'/'1' string, positional over the final
      // factorization's Ritz values
      size_t close = opts_s.find_last_of('}');
      if (close != std::string::npos) {
        opts_s.erase(close);  // strip the closing '}' (robust to any
                              // trailing bytes, unlike pop_back)
        opts_s += ",\"select\":\"" + g_select + "\"}";
      }
      g_select.clear();
    }

    PyObject *fn = bridge_attr("solve");
    if (!fn) { rc = -9999; break; }
    size_t sb = scalar_bytes(dtype);
    PyObject *opt = PyUnicode_FromString(opts_s.c_str());
    PyObject *mA = mv_or_none(dense_a, size_t(n) * size_t(n) * sb);
    PyObject *mP = mv_or_none(indptr, sizeof(atpu_int) * size_t(n + 1));
    PyObject *mI = mv_or_none(indices, sizeof(atpu_int) * size_t(nnz));
    PyObject *mV = mv_or_none(data, size_t(nnz) * sb);
    PyObject *mM = mv_or_none(dense_m, size_t(n) * size_t(n) * sb);
    PyObject *res = PyObject_CallFunctionObjArgs(
        fn, opt, mA, mP, mI, mV, mM, nullptr);
    Py_DECREF(fn); Py_DECREF(opt);
    Py_XDECREF(mA); Py_XDECREF(mP); Py_XDECREF(mI); Py_XDECREF(mV);
    Py_XDECREF(mM);
    if (!res) { PyErr_Print(); rc = -9999; break; }

    PyObject *info = PyDict_GetItemString(res, "info");
    PyObject *nc = PyDict_GetItemString(res, "nconv");
    long long nconv = nc ? PyLong_AsLongLong(nc) : 0;
    long long info_v = info ? PyLong_AsLongLong(info) : -9999;
    if (nconv_out) *nconv_out = nconv;
    if (info_v < 0) { rc = info_v; Py_DECREF(res); break; }
    rc = info_v;

    bool cplx = (dtype == 'c' || dtype == 'z');
    size_t rsb = (dtype == 's' || dtype == 'c') ? 4 : 8;
    if (!cplx) {
      copy_bytes(res, "vals_re", evals_re, size_t(nconv) * rsb);
      copy_bytes(res, "vals_im", evals_im, size_t(nconv) * rsb);
      copy_bytes(res, "vecs_re", evecs_re,
                 size_t(n) * size_t(nconv) * rsb);
      copy_bytes(res, "vecs_im", evecs_im,
                 size_t(n) * size_t(nconv) * rsb);
    } else if (rsb == 4) {
      interleave<float>(res, "vals_re", "vals_im",
                        reinterpret_cast<float *>(evals_re),
                        size_t(nconv));
      interleave<float>(res, "vecs_re", "vecs_im",
                        reinterpret_cast<float *>(evecs_re),
                        size_t(n) * size_t(nconv));
    } else {
      interleave<double>(res, "vals_re", "vals_im",
                         reinterpret_cast<double *>(evals_re),
                         size_t(nconv));
      interleave<double>(res, "vecs_re", "vecs_im",
                         reinterpret_cast<double *>(evecs_re),
                         size_t(n) * size_t(nconv));
    }
    Py_DECREF(res);
  } while (false);
  PyGILState_Release(gil);
  return rc;
}

// Matrix-free runner: the ido-loop capability of the reference's C
// surface (ICB/arpack.h:10-21; ido contract SRC/dsaupd.f:68-97) as a
// function-pointer matvec.  The pointer + context ride to Python as
// integers; arpack_ng_tpu.native_bridge.solve_matvec wraps them in a
// ctypes callback inside a jax.pure_callback operator.  Per-matvec
// host round trips make this the documented SLOW path (exactly the
// reference's RCI data path); concrete-matrix entries are the fast ones.
atpu_int run_solve_matvec(char dtype, int symmetric, atpu_int n,
                          void (*fn)(), void *ctx, atpu_int nev,
                          const char *which, double tol, atpu_int ncv,
                          atpu_int max_iter, void *evals_re,
                          void *evals_im, void *evecs_re, void *evecs_im,
                          atpu_int *nconv_out) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (!ensure_python()) return -9999;
  if (!which || std::strlen(which) != 2 || !json_safe(which)) return -5;
  if (!fn) return -9996;
  PyGILState_STATE gil = PyGILState_Ensure();
  atpu_int rc = 0;
  do {
    char opts[512];
    std::snprintf(
        opts, sizeof(opts),
        "{\"dtype\":\"%c\",\"symmetric\":%s,\"n\":%lld,\"k\":%lld,"
        "\"which\":\"%s\",\"ncv\":%lld,\"maxiter\":%lld,\"tol\":%.17g,"
        "\"rvec\":%s,\"iwidth\":%d}",
        dtype, symmetric ? "true" : "false", static_cast<long long>(n),
        static_cast<long long>(nev), which, static_cast<long long>(ncv),
        static_cast<long long>(max_iter), tol,
        (evecs_re != nullptr) ? "true" : "false",
        static_cast<int>(sizeof(atpu_int) * 8));
    PyObject *pfn = bridge_attr("solve_matvec");
    if (!pfn) { rc = -9999; break; }
    PyObject *opt = PyUnicode_FromString(opts);
    PyObject *addr = PyLong_FromVoidPtr(reinterpret_cast<void *>(fn));
    PyObject *pctx = PyLong_FromVoidPtr(ctx);
    PyObject *res = PyObject_CallFunctionObjArgs(pfn, opt, addr, pctx,
                                                 nullptr);
    Py_DECREF(pfn); Py_DECREF(opt); Py_DECREF(addr); Py_DECREF(pctx);
    if (!res) { PyErr_Print(); rc = -9999; break; }
    PyObject *info = PyDict_GetItemString(res, "info");
    PyObject *nc = PyDict_GetItemString(res, "nconv");
    long long nconv = nc ? PyLong_AsLongLong(nc) : 0;
    long long info_v = info ? PyLong_AsLongLong(info) : -9999;
    if (nconv_out) *nconv_out = nconv;
    if (info_v < 0) { rc = info_v; Py_DECREF(res); break; }
    rc = info_v;
    size_t rsb = (dtype == 's') ? 4 : 8;
    copy_bytes(res, "vals_re", evals_re, size_t(nconv) * rsb);
    copy_bytes(res, "vals_im", evals_im, size_t(nconv) * rsb);
    copy_bytes(res, "vecs_re", evecs_re, size_t(n) * size_t(nconv) * rsb);
    copy_bytes(res, "vecs_im", evecs_im, size_t(n) * size_t(nconv) * rsb);
    Py_DECREF(res);
  } while (false);
  PyGILState_Release(gil);
  return rc;
}

}  // namespace

extern "C" {

/* ---- matrix-free (user-operator) entries: the reference's defining
 *      C capability — any caller-supplied operator, here as a function
 *      pointer instead of the ido loop (ICB/arpack.h:10-21,
 *      SRC/dsaupd.f:68-97).  Per-matvec host-callback cost: see
 *      native_bridge.solve_matvec. ------------------------------------ */

atpu_int atpu_eigsh_matvec_d(atpu_int n, atpu_matvec_d op, void *ctx,
                             atpu_int nev, const char *which, double tol,
                             atpu_int ncv, atpu_int max_iter,
                             double *evals, double *evecs,
                             atpu_int *nconv) {
  return run_solve_matvec('d', 1, n, reinterpret_cast<void (*)()>(op),
                          ctx, nev, which, tol, ncv, max_iter, evals,
                          nullptr, evecs, nullptr, nconv);
}

atpu_int atpu_eigsh_matvec_s(atpu_int n, atpu_matvec_s op, void *ctx,
                             atpu_int nev, const char *which, double tol,
                             atpu_int ncv, atpu_int max_iter,
                             float *evals, float *evecs,
                             atpu_int *nconv) {
  return run_solve_matvec('s', 1, n, reinterpret_cast<void (*)()>(op),
                          ctx, nev, which, tol, ncv, max_iter, evals,
                          nullptr, evecs, nullptr, nconv);
}

atpu_int atpu_eigs_matvec_d(atpu_int n, atpu_matvec_d op, void *ctx,
                            atpu_int nev, const char *which, double tol,
                            atpu_int ncv, atpu_int max_iter,
                            double *evals_re, double *evals_im,
                            double *evecs_re, double *evecs_im,
                            atpu_int *nconv) {
  return run_solve_matvec('d', 0, n, reinterpret_cast<void (*)()>(op),
                          ctx, nev, which, tol, ncv, max_iter, evals_re,
                          evals_im, evecs_re, evecs_im, nconv);
}

atpu_int atpu_eigs_matvec_s(atpu_int n, atpu_matvec_s op, void *ctx,
                            atpu_int nev, const char *which, double tol,
                            atpu_int ncv, atpu_int max_iter,
                            float *evals_re, float *evals_im,
                            float *evecs_re, float *evecs_im,
                            atpu_int *nconv) {
  return run_solve_matvec('s', 0, n, reinterpret_cast<void (*)()>(op),
                          ctx, nev, which, tol, ncv, max_iter, evals_re,
                          evals_im, evecs_re, evecs_im, nconv);
}

/* ---- symmetric real ---------------------------------------------------- */

atpu_int atpu_eigsh_dense_d(atpu_int n, const double *a, const double *m,
                            atpu_int nev, const char *which, double sigma,
                            int has_sigma, double tol, atpu_int ncv,
                            atpu_int max_iter, double *evals,
                            double *evecs, atpu_int *nconv) {
  return run_solve('d', 1, 0, n, a, nullptr, nullptr, nullptr, 0, m, nev,
                   which, sigma, 0.0, has_sigma, tol, ncv, max_iter,
                   evals, nullptr, evecs, nullptr, nconv);
}

atpu_int atpu_eigsh_dense_s(atpu_int n, const float *a, const float *m,
                            atpu_int nev, const char *which, double sigma,
                            int has_sigma, double tol, atpu_int ncv,
                            atpu_int max_iter, float *evals,
                            float *evecs, atpu_int *nconv) {
  return run_solve('s', 1, 0, n, a, nullptr, nullptr, nullptr, 0, m, nev,
                   which, sigma, 0.0, has_sigma, tol, ncv, max_iter,
                   evals, nullptr, evecs, nullptr, nconv);
}

atpu_int atpu_eigsh_csr_d(atpu_int n, const atpu_int *indptr,
                          const atpu_int *indices, const double *data,
                          atpu_int nnz, atpu_int nev, const char *which,
                          double tol, atpu_int ncv, atpu_int max_iter,
                          double *evals, double *evecs, atpu_int *nconv) {
  return run_solve('d', 1, 0, n, nullptr, indptr, indices, data, nnz,
                   nullptr, nev, which, 0.0, 0.0, 0, tol, ncv, max_iter,
                   evals, nullptr, evecs, nullptr, nconv);
}

atpu_int atpu_eigsh_csr_s(atpu_int n, const atpu_int *indptr,
                          const atpu_int *indices, const float *data,
                          atpu_int nnz, atpu_int nev, const char *which,
                          double tol, atpu_int ncv, atpu_int max_iter,
                          float *evals, float *evecs, atpu_int *nconv) {
  return run_solve('s', 1, 0, n, nullptr, indptr, indices, data, nnz,
                   nullptr, nev, which, 0.0, 0.0, 0, tol, ncv, max_iter,
                   evals, nullptr, evecs, nullptr, nconv);
}

/* ---- non-symmetric real (split re/im outputs) --------------------------- */

atpu_int atpu_eigs_dense_d(atpu_int n, const double *a, const double *m,
                           atpu_int nev, const char *which, double sigma,
                           int has_sigma, double tol, atpu_int ncv,
                           atpu_int max_iter, int schur, double *evals_re,
                           double *evals_im, double *evecs_re,
                           double *evecs_im, atpu_int *nconv) {
  return run_solve('d', 0, schur, n, a, nullptr, nullptr, nullptr, 0, m,
                   nev, which, sigma, 0.0, has_sigma, tol, ncv, max_iter,
                   evals_re, evals_im, evecs_re, evecs_im, nconv);
}

atpu_int atpu_eigs_dense_s(atpu_int n, const float *a, const float *m,
                           atpu_int nev, const char *which, double sigma,
                           int has_sigma, double tol, atpu_int ncv,
                           atpu_int max_iter, int schur, float *evals_re,
                           float *evals_im, float *evecs_re,
                           float *evecs_im, atpu_int *nconv) {
  return run_solve('s', 0, schur, n, a, nullptr, nullptr, nullptr, 0, m,
                   nev, which, sigma, 0.0, has_sigma, tol, ncv, max_iter,
                   evals_re, evals_im, evecs_re, evecs_im, nconv);
}

atpu_int atpu_eigs_csr_d(atpu_int n, const atpu_int *indptr,
                         const atpu_int *indices, const double *data,
                         atpu_int nnz, atpu_int nev, const char *which,
                         double tol, atpu_int ncv, atpu_int max_iter,
                         int schur, double *evals_re, double *evals_im,
                         double *evecs_re, double *evecs_im,
                         atpu_int *nconv) {
  return run_solve('d', 0, schur, n, nullptr, indptr, indices, data, nnz,
                   nullptr, nev, which, 0.0, 0.0, 0, tol, ncv, max_iter,
                   evals_re, evals_im, evecs_re, evecs_im, nconv);
}

/* ---- complex (interleaved re,im buffers, C99-complex compatible) -------- */

atpu_int atpu_eigs_dense_z(atpu_int n, const double *a, const double *m,
                           atpu_int nev, const char *which,
                           double sigma_re, double sigma_im, int has_sigma,
                           double tol, atpu_int ncv, atpu_int max_iter,
                           int schur, double *evals, double *evecs,
                           atpu_int *nconv) {
  return run_solve('z', 0, schur, n, a, nullptr, nullptr, nullptr, 0, m,
                   nev, which, sigma_re, sigma_im, has_sigma, tol, ncv,
                   max_iter, evals, nullptr, evecs, nullptr, nconv);
}

atpu_int atpu_eigs_dense_c(atpu_int n, const float *a, const float *m,
                           atpu_int nev, const char *which,
                           double sigma_re, double sigma_im, int has_sigma,
                           double tol, atpu_int ncv, atpu_int max_iter,
                           int schur, float *evals, float *evecs,
                           atpu_int *nconv) {
  return run_solve('c', 0, schur, n, a, nullptr, nullptr, nullptr, 0, m,
                   nev, which, sigma_re, sigma_im, has_sigma, tol, ncv,
                   max_iter, evals, nullptr, evecs, nullptr, nconv);
}

atpu_int atpu_eigs_csr_z(atpu_int n, const atpu_int *indptr,
                         const atpu_int *indices, const double *data,
                         atpu_int nnz, atpu_int nev, const char *which,
                         double tol, atpu_int ncv, atpu_int max_iter,
                         int schur, double *evals, double *evecs,
                         atpu_int *nconv) {
  return run_solve('z', 0, schur, n, nullptr, indptr, indices, data, nnz,
                   nullptr, nev, which, 0.0, 0.0, 0, tol, ncv, max_iter,
                   evals, nullptr, evecs, nullptr, nconv);
}

/* ---- distributed entry points (ICB/parpack.h:10-39 analog) --------------
 * The mesh size is the communicator: threaded per call, exactly like
 * pdsaupd_c's MPI_Fint comm (PARPACK/SRC/MPI/icbpdn.F90:3-13). */

atpu_int atpu_device_count(void) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (!ensure_python()) return -1;
  PyGILState_STATE gil = PyGILState_Ensure();
  atpu_int count = -1;
  PyObject *fn = bridge_attr("device_count");
  if (fn) {
    PyObject *r = PyObject_CallFunctionObjArgs(fn, nullptr);
    if (r) count = PyLong_AsLongLong(r);
    else PyErr_Print();
    Py_XDECREF(r);
    Py_DECREF(fn);
  }
  PyGILState_Release(gil);
  return count;
}

atpu_int atpu_peigsh_dense_d(atpu_int nd, atpu_int n, const double *a,
                             const double *m, atpu_int nev,
                             const char *which, double sigma, int has_sigma,
                             double tol, atpu_int ncv, atpu_int max_iter,
                             double *evals, double *evecs, atpu_int *nconv) {
  return run_solve('d', 1, 0, n, a, nullptr, nullptr, nullptr, 0, m, nev,
                   which, sigma, 0.0, has_sigma, tol, ncv, max_iter,
                   evals, nullptr, evecs, nullptr, nconv, nd);
}

atpu_int atpu_peigsh_dense_s(atpu_int nd, atpu_int n, const float *a,
                             const float *m, atpu_int nev,
                             const char *which, double sigma, int has_sigma,
                             double tol, atpu_int ncv, atpu_int max_iter,
                             float *evals, float *evecs, atpu_int *nconv) {
  return run_solve('s', 1, 0, n, a, nullptr, nullptr, nullptr, 0, m, nev,
                   which, sigma, 0.0, has_sigma, tol, ncv, max_iter,
                   evals, nullptr, evecs, nullptr, nconv, nd);
}

atpu_int atpu_peigsh_csr_d(atpu_int nd, atpu_int n, const atpu_int *indptr,
                           const atpu_int *indices, const double *data,
                           atpu_int nnz, atpu_int nev, const char *which,
                           double tol, atpu_int ncv, atpu_int max_iter,
                           double *evals, double *evecs, atpu_int *nconv) {
  return run_solve('d', 1, 0, n, nullptr, indptr, indices, data, nnz,
                   nullptr, nev, which, 0.0, 0.0, 0, tol, ncv, max_iter,
                   evals, nullptr, evecs, nullptr, nconv, nd);
}

atpu_int atpu_peigsh_csr_s(atpu_int nd, atpu_int n, const atpu_int *indptr,
                           const atpu_int *indices, const float *data,
                           atpu_int nnz, atpu_int nev, const char *which,
                           double tol, atpu_int ncv, atpu_int max_iter,
                           float *evals, float *evecs, atpu_int *nconv) {
  return run_solve('s', 1, 0, n, nullptr, indptr, indices, data, nnz,
                   nullptr, nev, which, 0.0, 0.0, 0, tol, ncv, max_iter,
                   evals, nullptr, evecs, nullptr, nconv, nd);
}

atpu_int atpu_peigs_dense_d(atpu_int nd, atpu_int n, const double *a,
                            const double *m, atpu_int nev,
                            const char *which, double sigma, int has_sigma,
                            double tol, atpu_int ncv, atpu_int max_iter,
                            int schur, double *evals_re, double *evals_im,
                            double *evecs_re, double *evecs_im,
                            atpu_int *nconv) {
  return run_solve('d', 0, schur, n, a, nullptr, nullptr, nullptr, 0, m,
                   nev, which, sigma, 0.0, has_sigma, tol, ncv, max_iter,
                   evals_re, evals_im, evecs_re, evecs_im, nconv, nd);
}

atpu_int atpu_peigs_dense_s(atpu_int nd, atpu_int n, const float *a,
                            const float *m, atpu_int nev,
                            const char *which, double sigma, int has_sigma,
                            double tol, atpu_int ncv, atpu_int max_iter,
                            int schur, float *evals_re, float *evals_im,
                            float *evecs_re, float *evecs_im,
                            atpu_int *nconv) {
  return run_solve('s', 0, schur, n, a, nullptr, nullptr, nullptr, 0, m,
                   nev, which, sigma, 0.0, has_sigma, tol, ncv, max_iter,
                   evals_re, evals_im, evecs_re, evecs_im, nconv, nd);
}

atpu_int atpu_peigs_csr_d(atpu_int nd, atpu_int n, const atpu_int *indptr,
                          const atpu_int *indices, const double *data,
                          atpu_int nnz, atpu_int nev, const char *which,
                          double tol, atpu_int ncv, atpu_int max_iter,
                          int schur, double *evals_re, double *evals_im,
                          double *evecs_re, double *evecs_im,
                          atpu_int *nconv) {
  return run_solve('d', 0, schur, n, nullptr, indptr, indices, data, nnz,
                   nullptr, nev, which, 0.0, 0.0, 0, tol, ncv, max_iter,
                   evals_re, evals_im, evecs_re, evecs_im, nconv, nd);
}

atpu_int atpu_peigs_dense_z(atpu_int nd, atpu_int n, const double *a,
                            const double *m, atpu_int nev,
                            const char *which, double sigma_re,
                            double sigma_im, int has_sigma, double tol,
                            atpu_int ncv, atpu_int max_iter, int schur,
                            double *evals, double *evecs, atpu_int *nconv) {
  return run_solve('z', 0, schur, n, a, nullptr, nullptr, nullptr, 0, m,
                   nev, which, sigma_re, sigma_im, has_sigma, tol, ncv,
                   max_iter, evals, nullptr, evecs, nullptr, nconv, nd);
}

atpu_int atpu_peigs_dense_c(atpu_int nd, atpu_int n, const float *a,
                            const float *m, atpu_int nev,
                            const char *which, double sigma_re,
                            double sigma_im, int has_sigma, double tol,
                            atpu_int ncv, atpu_int max_iter, int schur,
                            float *evals, float *evecs, atpu_int *nconv) {
  return run_solve('c', 0, schur, n, a, nullptr, nullptr, nullptr, 0, m,
                   nev, which, sigma_re, sigma_im, has_sigma, tol, ncv,
                   max_iter, evals, nullptr, evecs, nullptr, nconv, nd);
}

atpu_int atpu_peigs_csr_z(atpu_int nd, atpu_int n, const atpu_int *indptr,
                          const atpu_int *indices, const double *data,
                          atpu_int nnz, atpu_int nev, const char *which,
                          double tol, atpu_int ncv, atpu_int max_iter,
                          int schur, double *evals, double *evecs,
                          atpu_int *nconv) {
  return run_solve('z', 0, schur, n, nullptr, indptr, indices, data, nnz,
                   nullptr, nev, which, 0.0, 0.0, 0, tol, ncv, max_iter,
                   evals, nullptr, evecs, nullptr, nconv, nd);
}

/* ---- matrix-market reader + residual verifier (arpackSolver.hpp:176-215,
 *      :297-323 analogs) --------------------------------------------------- */

atpu_int atpu_mm_query(const char *path, atpu_int *n_rows,
                       atpu_int *n_cols, atpu_int *nnz, int *is_complex) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (!ensure_python() || !path) return -1;
  PyGILState_STATE gil = PyGILState_Ensure();
  atpu_int rc = -1;
  PyObject *fn = bridge_attr("mm_query");
  if (fn) {
    PyObject *r = PyObject_CallFunction(fn, "s", path);
    if (r && PySequence_Check(r) && PySequence_Size(r) >= 4) {
      long long v[4];
      for (int j = 0; j < 4; ++j) {
        PyObject *it = PySequence_GetItem(r, j);
        v[j] = PyLong_AsLongLong(it);
        Py_XDECREF(it);
      }
      if (n_rows) *n_rows = v[0];
      if (n_cols) *n_cols = v[1];
      if (nnz) *nnz = v[2];
      if (is_complex) *is_complex = static_cast<int>(v[3]);
      rc = 0;
    } else if (!r) {
      PyErr_Print();
    }
    Py_XDECREF(r);
    Py_DECREF(fn);
  }
  PyGILState_Release(gil);
  return rc;
}

namespace {
atpu_int mm_read_impl(const char *path, int want_complex,
                      atpu_int *indptr, atpu_int *indices, double *data) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (!ensure_python() || !path) return -1;
  PyGILState_STATE gil = PyGILState_Ensure();
  atpu_int rc = -1;
  PyObject *fn = bridge_attr("mm_read");
  if (fn) {
    PyObject *r = PyObject_CallFunction(
        fn, "sii", path, want_complex,
        static_cast<int>(sizeof(atpu_int) * 8));
    if (r && PyDict_Check(r)) {
      // capacities unknown here: bridge produced exactly query-sized
      // payloads; copy whatever it sent
      copy_bytes(r, "indptr", indptr, SIZE_MAX);
      copy_bytes(r, "indices", indices, SIZE_MAX);
      copy_bytes(r, "data", data, SIZE_MAX);
      rc = 0;
    } else if (!r) {
      PyErr_Print();
    }
    Py_XDECREF(r);
    Py_DECREF(fn);
  }
  PyGILState_Release(gil);
  return rc;
}

atpu_int check_eigvec_impl(char dtype, atpu_int n, int dense,
                           const atpu_int *indptr, const atpu_int *indices,
                           const double *a, atpu_int nnz,
                           const atpu_int *m_indptr,
                           const atpu_int *m_indices, const double *m,
                           atpu_int m_nnz, atpu_int nconv,
                           const double *valr, const double *vali,
                           const double *vecr, const double *veci,
                           double diff_tol, double *max_res) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (!ensure_python() || !a || !valr || !vecr) return -1;
  PyGILState_STATE gil = PyGILState_Ensure();
  atpu_int rc = -1;
  do {
    PyObject *fn = bridge_attr("check_eigvec");
    if (!fn) break;
    char opts[512];
    std::snprintf(
        opts, sizeof(opts),
        "{\"dtype\":\"%c\",\"n\":%lld,\"nnz\":%lld,\"m_nnz\":%lld,"
        "\"nconv\":%lld,\"diff_tol\":%.17g,\"dense\":%s,\"iwidth\":%d}",
        dtype, static_cast<long long>(n), static_cast<long long>(nnz),
        static_cast<long long>(m_nnz), static_cast<long long>(nconv),
        diff_tol, dense ? "true" : "false",
        static_cast<int>(sizeof(atpu_int) * 8));
    size_t sb = (dtype == 'z') ? 16 : 8;
    size_t a_bytes = dense ? size_t(n) * size_t(n) * sb
                           : size_t(nnz) * sb;
    size_t m_bytes = dense ? size_t(n) * size_t(n) * sb
                           : size_t(m_nnz) * sb;
    size_t vsb = (dtype == 'z') ? 16 : 8;
    PyObject *opt = PyUnicode_FromString(opts);
    PyObject *mP = mv_or_none(dense ? nullptr : indptr,
                              sizeof(atpu_int) * size_t(n + 1));
    PyObject *mI = mv_or_none(dense ? nullptr : indices,
                              sizeof(atpu_int) * size_t(nnz));
    PyObject *mV = mv_or_none(a, a_bytes);
    PyObject *mMP = mv_or_none(dense ? nullptr : m_indptr,
                               sizeof(atpu_int) * size_t(n + 1));
    PyObject *mMI = mv_or_none(dense ? nullptr : m_indices,
                               sizeof(atpu_int) * size_t(m_nnz));
    PyObject *mMV = mv_or_none(m, m_bytes);
    PyObject *mVR = mv_or_none(valr, size_t(nconv) * vsb);
    PyObject *mVI = mv_or_none(vali, size_t(nconv) * 8);
    PyObject *mZR = mv_or_none(vecr, size_t(n) * size_t(nconv) * vsb);
    PyObject *mZI = mv_or_none(veci, size_t(n) * size_t(nconv) * 8);
    PyObject *res = PyObject_CallFunctionObjArgs(
        fn, opt, mP, mI, mV, mMP, mMI, mMV, mVR, mVI, mZR, mZI, nullptr);
    Py_DECREF(fn); Py_DECREF(opt);
    Py_XDECREF(mP); Py_XDECREF(mI); Py_XDECREF(mV);
    Py_XDECREF(mMP); Py_XDECREF(mMI); Py_XDECREF(mMV);
    Py_XDECREF(mVR); Py_XDECREF(mVI); Py_XDECREF(mZR); Py_XDECREF(mZI);
    if (!res) { PyErr_Print(); break; }
    PyObject *mr = PyDict_GetItemString(res, "max_res");
    PyObject *ok = PyDict_GetItemString(res, "ok");
    if (max_res && mr) *max_res = PyFloat_AsDouble(mr);
    rc = (ok && PyLong_AsLong(ok)) ? 0 : 1;
    Py_DECREF(res);
  } while (false);
  PyGILState_Release(gil);
  return rc;
}
}  // namespace

atpu_int atpu_mm_read_d(const char *path, atpu_int *indptr,
                        atpu_int *indices, double *data) {
  return mm_read_impl(path, 0, indptr, indices, data);
}

atpu_int atpu_mm_read_z(const char *path, atpu_int *indptr,
                        atpu_int *indices, double *data) {
  return mm_read_impl(path, 1, indptr, indices, data);
}

atpu_int atpu_check_eigvec_d(atpu_int n, int dense,
                             const atpu_int *indptr,
                             const atpu_int *indices, const double *a,
                             atpu_int nnz, const atpu_int *m_indptr,
                             const atpu_int *m_indices, const double *m,
                             atpu_int m_nnz, atpu_int nconv,
                             const double *evals_re,
                             const double *evals_im,
                             const double *evecs_re,
                             const double *evecs_im, double diff_tol,
                             double *max_res) {
  return check_eigvec_impl('d', n, dense, indptr, indices, a, nnz,
                           m_indptr, m_indices, m, m_nnz, nconv, evals_re,
                           evals_im, evecs_re, evecs_im, diff_tol,
                           max_res);
}

atpu_int atpu_check_eigvec_z(atpu_int n, int dense,
                             const atpu_int *indptr,
                             const atpu_int *indices, const double *a,
                             atpu_int nnz, const atpu_int *m_indptr,
                             const atpu_int *m_indices, const double *m,
                             atpu_int m_nnz, atpu_int nconv,
                             const double *evals, const double *evecs,
                             double diff_tol, double *max_res) {
  return check_eigvec_impl('z', n, dense, indptr, indices, a, nnz,
                           m_indptr, m_indices, m, m_nnz, nconv, evals,
                           nullptr, evecs, nullptr, diff_tol, max_res);
}

/* ---- stat/debug control (stat_c.h:12-16, debug_c.h:6-9 analogs) --------- */

void atpu_stats_reset(void) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (!ensure_python()) return;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *fn = bridge_attr("stats_reset");
  if (fn) {
    PyObject *r = PyObject_CallFunctionObjArgs(fn, nullptr);
    Py_XDECREF(r);
    Py_DECREF(fn);
  }
  PyGILState_Release(gil);
}

void atpu_stat_c(atpu_int *nopx, atpu_int *nbx, atpu_int *nrorth,
                 atpu_int *nitref, atpu_int *nrstrt, float *tsaupd,
                 float *tsaup2, float *tsaitr, float *tseigt,
                 float *tsgets, float *tsapps, float *tsconv,
                 float *tnaupd, float *tnaup2, float *tnaitr,
                 float *tneigh, float *tngets, float *tnapps,
                 float *tnconv, float *tcaupd, float *tcaup2,
                 float *tcaitr, float *tceigh, float *tcgets,
                 float *tcapps, float *tcconv, float *tmvopx,
                 float *tmvbx, float *tgetv0, float *titref,
                 float *trvec) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (!ensure_python()) return;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *fn = bridge_attr("get_stats");
  if (fn) {
    PyObject *r = PyObject_CallFunctionObjArgs(fn, nullptr);
    if (r && PySequence_Check(r) && PySequence_Size(r) >= 31) {
      atpu_int *ints[5] = {nopx, nbx, nrorth, nitref, nrstrt};
      for (int j = 0; j < 5; ++j) {
        PyObject *it = PySequence_GetItem(r, j);
        if (ints[j]) *ints[j] = PyLong_AsLongLong(it);
        Py_XDECREF(it);
      }
      float *flts[26] = {tsaupd, tsaup2, tsaitr, tseigt, tsgets, tsapps,
                         tsconv, tnaupd, tnaup2, tnaitr, tneigh, tngets,
                         tnapps, tnconv, tcaupd, tcaup2, tcaitr, tceigh,
                         tcgets, tcapps, tcconv, tmvopx, tmvbx, tgetv0,
                         titref, trvec};
      for (int j = 0; j < 26; ++j) {
        PyObject *it = PySequence_GetItem(r, 5 + j);
        if (flts[j]) *flts[j] = static_cast<float>(PyFloat_AsDouble(it));
        Py_XDECREF(it);
      }
    }
    Py_XDECREF(r);
    Py_DECREF(fn);
  }
  PyGILState_Release(gil);
}

void atpu_debug_c(atpu_int logfil, atpu_int ndigit, atpu_int mgetv0,
                  atpu_int maupd, atpu_int maup2, atpu_int maitr,
                  atpu_int meigt, atpu_int mapps, atpu_int mgets,
                  atpu_int meupd) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (!ensure_python()) return;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *fn = bridge_attr("set_debug");
  if (fn) {
    PyObject *r = PyObject_CallFunction(
        fn, "llllllllll", static_cast<long>(logfil),
        static_cast<long>(ndigit), static_cast<long>(mgetv0),
        static_cast<long>(maupd), static_cast<long>(maup2),
        static_cast<long>(maitr), static_cast<long>(meigt),
        static_cast<long>(mapps), static_cast<long>(mgets),
        static_cast<long>(meupd));
    Py_XDECREF(r);
    Py_DECREF(fn);
  }
  PyGILState_Release(gil);
}

/* ---- checkpoint dump/restart (arpackSolver dumpToFile/restartFromFile,
 *      arpackSolver.hpp:153-154; applies to the NEXT solve) -------------- */

atpu_int atpu_set_checkpoint(const char *dump_path,
                             const char *restart_path) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (dump_path && !json_safe(dump_path)) return -1;
  if (restart_path && !json_safe(restart_path)) return -1;
  g_dump = dump_path ? dump_path : "";
  g_restart = restart_path ? restart_path : "";
  return 0;
}

/* ---- howmny='S' select mask (ICB/arpack.hpp:44-48 ritz_specified; the
 *      reference Fortran core documents but rejects it — here it works).
 *      Applies to the NEXT solve; mask[i] != 0 selects the i-th Ritz
 *      value of the final factorization (converged entries only).
 *      Pass NULL/0 to clear. ------------------------------------------- */

atpu_int atpu_set_select(const atpu_int *mask, atpu_int len) {
  std::lock_guard<std::mutex> lk(g_mu);
  g_select.clear();
  if (!mask || len <= 0) return 0;
  if (len > 4096) return -1;  /* ncv-sized; reject absurd lengths */
  g_select.reserve(static_cast<size_t>(len));
  for (atpu_int i = 0; i < len; ++i) g_select += mask[i] ? '1' : '0';
  return 0;
}

}  // extern "C"
