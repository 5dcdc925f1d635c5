/* arpack_tpu.h — C ABI for the native reduced-space kernels of the
 * arpack_ng_tpu framework (the ICB/arpack.h analog of the reference:
 * a stable C interface over the numerical core, here covering the
 * replicated NCV-sized host subproblem that partners the device code).
 *
 * All matrices are row-major.  Integer width follows the reference's
 * INTERFACE64/a_int switch (arpackdef.h.in:6-44): 64-bit by default
 * (the superset; the reference defaults to 32), compile with
 * -DATPU_INTERFACE64=0 for a 32-bit `atpu_int` ABI.  The width is
 * baked into the library at build time exactly like libarpackILP64 vs
 * libarpack — client and library must agree.
 */
#ifndef ARPACK_TPU_H
#define ARPACK_TPU_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#ifndef ATPU_INTERFACE64
#define ATPU_INTERFACE64 1
#endif

#if ATPU_INTERFACE64
typedef int64_t atpu_int;
#else
typedef int32_t atpu_int;
#endif

/* Library version (reference: arpackdef.h.in / CMake version fields). */
const char *atpu_version(void);

/* Eigenvalues of a symmetric tridiagonal matrix plus the LAST component
 * of every eigenvector — the dstqrb equivalent (SRC/dstqrb.f:6-11):
 *   d[n]   in: diagonal          out: eigenvalues (ascending)
 *   e[n-1] in: subdiagonal       out: destroyed
 *   z[n]   out: last eigenvector components, matched to d's order
 * Returns 0 on success, >0 = index of an eigenvalue that failed to
 * converge (the dsteqr info convention). */
atpu_int atpu_stqrb_d(atpu_int n, double *d, double *e, double *z);
atpu_int atpu_stqrb_s(atpu_int n, float *d, float *e, float *z);

/* Apply np implicit shifts to a symmetric tridiagonal matrix by Givens
 * bulge-chasing, accumulating the orthogonal Q — the dsapps equivalent
 * (SRC/dsapps.f): block-aware chase, deflation test
 * |e_i| <= eps*(|d_i|+|d_{i+1}|), non-negative subdiagonal normalization.
 *   d[n], e[n-1] in/out;  shifts[np] in;  q[n*n] out (row-major).
 * Returns 0. */
atpu_int atpu_sym_shift_q_d(atpu_int n, double *d, double *e,
                            atpu_int np, const double *shifts, double *q);

/* Full eigen-decomposition of a symmetric tridiagonal (eigenvalues
 * ascending + full eigenvector matrix, row-major s[n*n]; dsteqr-class,
 * used by the extraction phase). */
atpu_int atpu_steqr_d(atpu_int n, double *d, double *e, double *s);

#ifdef __cplusplus
}
#endif

#endif /* ARPACK_TPU_H */
