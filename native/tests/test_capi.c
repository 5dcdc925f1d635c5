/* C-ABI test: the icb_arpack_c.c analog (TESTS/icb_arpack_c.c: diagonal
 * matrix, largest eigenvalues, checks values and convergence count) —
 * extended over the full surface: s/d/c/z dtypes, CSR input,
 * shift-invert, Schur option, stat_c/debug_c analogs, and checkpoint
 * dump/restart. */
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "arpack_tpu_solver.h"

static int failures = 0;
#define CHECK(cond, msg)                                        \
  do {                                                          \
    if (!(cond)) {                                              \
      fprintf(stderr, "FAIL: %s\n", msg);                       \
      ++failures;                                               \
    }                                                           \
  } while (0)

static void test_dense_d(void) {
  const atpu_int n = 200, nev = 4;
  double *a = calloc((size_t)(n * n), sizeof(double));
  for (atpu_int i = 0; i < n; ++i) a[i * n + i] = (double)(i + 1);
  double evals[8] = {0};
  double *evecs = malloc(sizeof(double) * (size_t)n * 8);
  atpu_int nconv = 0;
  atpu_int rc = atpu_eigsh_dense_d(n, a, NULL, nev, "LM", 0.0, 0, 1e-10,
                                   20, 500, evals, evecs, &nconv);
  CHECK(rc == 0, "dense_d rc");
  CHECK(nconv >= nev, "dense_d nconv");
  for (atpu_int i = 0; i < nev; ++i)
    CHECK(fabs(evals[i] - (double)(n - nev + 1 + i)) < 1e-6,
          "dense_d eigenvalue");
  free(a);
  free(evecs);
}

static void test_dense_s(void) {
  const atpu_int n = 150, nev = 3;
  float *a = calloc((size_t)(n * n), sizeof(float));
  for (atpu_int i = 0; i < n; ++i) a[i * n + i] = (float)(i + 1);
  float evals[8] = {0};
  atpu_int nconv = 0;
  atpu_int rc = atpu_eigsh_dense_s(n, a, NULL, nev, "LM", 0.0, 0, 1e-4,
                                   16, 500, evals, NULL, &nconv);
  CHECK(rc == 0, "dense_s rc");
  CHECK(nconv >= nev, "dense_s nconv");
  CHECK(fabsf(evals[nev - 1] - (float)n) < 1e-2f, "dense_s top value");
  free(a);
}

static void test_csr_d_and_stats(void) {
  /* 1-D Laplacian tridiagonal in CSR */
  const atpu_int n = 400, nev = 3;
  atpu_int nnz_cap = 3 * n;
  atpu_int *indptr = malloc(sizeof(atpu_int) * (size_t)(n + 1));
  atpu_int *indices = malloc(sizeof(atpu_int) * (size_t)nnz_cap);
  double *data = malloc(sizeof(double) * (size_t)nnz_cap);
  atpu_int k = 0;
  for (atpu_int i = 0; i < n; ++i) {
    indptr[i] = k;
    if (i > 0) { indices[k] = i - 1; data[k++] = -1.0; }
    indices[k] = i; data[k++] = 2.0;
    if (i + 1 < n) { indices[k] = i + 1; data[k++] = -1.0; }
  }
  indptr[n] = k;
  double evals[8] = {0};
  atpu_int nconv = 0;
  atpu_int rc = atpu_eigsh_csr_d(n, indptr, indices, data, k, nev, "LA",
                                 1e-10, 24, 800, evals, NULL, &nconv);
  CHECK(rc == 0, "csr_d rc");
  CHECK(nconv >= nev, "csr_d nconv");
  CHECK(fabs(evals[nev - 1] - 4.0) < 1e-3, "csr_d top near 4");

  /* stat_c analog: counters of THAT solve must be populated */
  atpu_int nopx = 0, nbx = 0, nrorth = 0, nitref = 0, nrstrt = 0;
  float t[26];
  memset(t, 0, sizeof(t));
  atpu_stat_c(&nopx, &nbx, &nrorth, &nitref, &nrstrt, &t[0], &t[1],
              &t[2], &t[3], &t[4], &t[5], &t[6], &t[7], &t[8], &t[9],
              &t[10], &t[11], &t[12], &t[13], &t[14], &t[15], &t[16],
              &t[17], &t[18], &t[19], &t[20], &t[21], &t[22], &t[23],
              &t[24], &t[25]);
  CHECK(nopx > 0, "stat_c nopx > 0");
  CHECK(t[0] > 0.0f, "stat_c tsaupd > 0 (symmetric family)");
  CHECK(t[7] == 0.0f, "stat_c tnaupd == 0 (unused family)");
  atpu_stats_reset();
  atpu_stat_c(&nopx, &nbx, &nrorth, &nitref, &nrstrt, &t[0], &t[1],
              &t[2], &t[3], &t[4], &t[5], &t[6], &t[7], &t[8], &t[9],
              &t[10], &t[11], &t[12], &t[13], &t[14], &t[15], &t[16],
              &t[17], &t[18], &t[19], &t[20], &t[21], &t[22], &t[23],
              &t[24], &t[25]);
  CHECK(nopx == 0, "stats_reset zeroes counters");
  free(indptr); free(indices); free(data);
}

static void test_nonsym_d_schur(void) {
  /* small upper-triangular-ish matrix: eigenvalues = diagonal */
  const atpu_int n = 80, nev = 3;
  double *a = calloc((size_t)(n * n), sizeof(double));
  for (atpu_int i = 0; i < n; ++i) {
    a[i * n + i] = (double)(i + 1);
    if (i + 1 < n) a[i * n + i + 1] = 0.3;
  }
  double vr[8] = {0}, vi[8] = {0};
  double *zr = malloc(sizeof(double) * (size_t)n * 8);
  double *zi = malloc(sizeof(double) * (size_t)n * 8);
  atpu_int nconv = 0;
  atpu_int rc = atpu_eigs_dense_d(n, a, NULL, nev, "LM", 0.0, 0, 1e-8,
                                  20, 800, 0, vr, vi, zr, zi, &nconv);
  CHECK(rc == 0, "eigs_d rc");
  CHECK(nconv >= nev, "eigs_d nconv");
  CHECK(fabs(vr[0] - (double)n) < 1e-5, "eigs_d top value");
  CHECK(fabs(vi[0]) < 1e-8, "eigs_d real spectrum");
  /* Schur option */
  nconv = 0;
  rc = atpu_eigs_dense_d(n, a, NULL, nev, "LM", 0.0, 0, 1e-8, 20, 800,
                         1, vr, vi, zr, zi, &nconv);
  CHECK(rc == 0, "eigs_d schur rc");
  CHECK(nconv >= nev, "eigs_d schur nconv");
  free(a); free(zr); free(zi);
}

static void test_dense_z(void) {
  /* Hermitian-ish complex diagonal: diag(k + 0i), via the z nonsym path */
  const atpu_int n = 100, nev = 3;
  double *a = calloc((size_t)(2 * n * n), sizeof(double));
  for (atpu_int i = 0; i < n; ++i) {
    a[2 * (i * n + i)] = (double)(i + 1);       /* re */
    if (i + 1 < n) a[2 * (i * n + i + 1) + 1] = 0.1;  /* small imag coupling */
  }
  double evals[16] = {0};   /* interleaved */
  atpu_int nconv = 0;
  atpu_int rc = atpu_eigs_dense_z(n, a, NULL, nev, "LM", 0.0, 0.0, 0,
                                  1e-8, 20, 800, 0, evals, NULL, &nconv);
  CHECK(rc == 0, "eigs_z rc");
  CHECK(nconv >= nev, "eigs_z nconv");
  CHECK(fabs(evals[0] - (double)n) < 1e-4, "eigs_z top value re");
  free(a);
}

static void test_shift_invert_and_checkpoint(void) {
  const atpu_int n = 120, nev = 2;
  double *a = calloc((size_t)(n * n), sizeof(double));
  for (atpu_int i = 0; i < n; ++i) {
    a[i * n + i] = 2.0;
    if (i + 1 < n) { a[i * n + i + 1] = -1.0; a[(i + 1) * n + i] = -1.0; }
  }
  double evals[8] = {0};
  atpu_int nconv = 0;
  /* interior eigenvalues near 1.0 via shift-invert */
  atpu_int rc = atpu_eigsh_dense_d(n, a, NULL, nev, "LM", 1.0, 1, 1e-10,
                                   20, 500, evals, NULL, &nconv);
  CHECK(rc == 0, "shift-invert rc");
  CHECK(nconv >= nev, "shift-invert nconv");
  CHECK(fabs(evals[0] - 1.0) < 0.1, "shift-invert targets sigma");

  /* dump, then restart from the checkpoint */
  CHECK(atpu_set_checkpoint("/tmp/atpu_c_ck.npz", NULL) == 0,
        "set dump path");
  rc = atpu_eigsh_dense_d(n, a, NULL, nev, "LA", 0.0, 0, 1e-10, 20, 500,
                          evals, NULL, &nconv);
  CHECK(rc == 0, "dump solve rc");
  CHECK(atpu_set_checkpoint(NULL, "/tmp/atpu_c_ck.npz") == 0,
        "set restart path");
  rc = atpu_eigsh_dense_d(n, a, NULL, nev, "LA", 0.0, 0, 1e-10, 20, 500,
                          evals, NULL, &nconv);
  CHECK(rc == 0, "restart solve rc");
  CHECK(nconv >= nev, "restart nconv");
  free(a);
}

static void test_parallel_mesh(void) {
  /* The ICB/parpack.h analog (icb_parpack_c.c: rows split across ranks,
   * same eigenvalues as sequential; issue46.f: solve on a
   * sub-communicator).  Mesh size is the explicit communicator arg. */
  atpu_int ndev = atpu_device_count();
  printf("visible devices: %lld\n", (long long)ndev);
  CHECK(ndev >= 1, "device_count");
  if (ndev < 2) {
    printf("SKIP parallel tests (single device)\n");
    return;
  }
  const atpu_int n = 300, nev = 4;
  double *a = calloc((size_t)(n * n), sizeof(double));
  for (atpu_int i = 0; i < n; ++i) a[i * n + i] = (double)(i + 1);
  double evals[8] = {0};
  atpu_int nconv = 0;
  /* whole world (n_devices = 0 -> MPI_COMM_WORLD analog) */
  atpu_int rc = atpu_peigsh_dense_d(0, n, a, NULL, nev, "LM", 0.0, 0,
                                    1e-10, 20, 500, evals, NULL, &nconv);
  CHECK(rc == 0, "p world rc");
  CHECK(nconv >= nev, "p world nconv");
  for (atpu_int i = 0; i < nev; ++i)
    CHECK(fabs(evals[i] - (double)(n - nev + 1 + i)) < 1e-6,
          "p world eigenvalue");
  /* sub-communicator (issue46 pattern): first 2 devices only */
  double evals2[8] = {0};
  nconv = 0;
  rc = atpu_peigsh_dense_d(2, n, a, NULL, nev, "LM", 0.0, 0, 1e-10,
                           20, 500, evals2, NULL, &nconv);
  CHECK(rc == 0, "p sub rc");
  CHECK(nconv >= nev, "p sub nconv");
  for (atpu_int i = 0; i < nev; ++i)
    CHECK(fabs(evals2[i] - evals[i]) < 1e-8, "p sub == p world values");
  /* distributed generalized shift-invert through the same entry */
  double *m = calloc((size_t)(n * n), sizeof(double));
  for (atpu_int i = 0; i < n; ++i) m[i * n + i] = 1.0;
  nconv = 0;
  rc = atpu_peigsh_dense_d(2, n, a, m, nev, "LM", 10.2, 1, 1e-10,
                           20, 500, evals2, NULL, &nconv);
  CHECK(rc == 0, "p gen shift-invert rc");
  CHECK(nconv >= nev, "p gen shift-invert nconv");
  /* the nev nearest eigenvalues to sigma=10.2 are {9,10,11,12} */
  for (atpu_int i = 0; i < nev; ++i)
    CHECK(fabs(evals2[i] - 10.2) < 2.3, "p shift-invert targets sigma");
  /* oversubscription must fail loudly, not fall back silently */
  rc = atpu_peigsh_dense_d(ndev + 1, n, a, NULL, nev, "LM", 0.0, 0,
                           1e-10, 20, 500, evals, NULL, &nconv);
  CHECK(rc == -9998, "oversubscribed mesh rejected");
  free(a);
  free(m);
}

static void test_mm_and_check(void) {
  /* arpackSolver createMatrix + checkEigVec, C-reachable: write a small
   * symmetric .mtx, query/read it, solve, verify residuals with the
   * independent checker (arpackSolver.hpp:176-215, :297-323). */
  const char *path = "/tmp/atpu_c_test.mtx";
  FILE *f = fopen(path, "w");
  CHECK(f != NULL, "mm write");
  if (!f) return;
  const int N = 60;
  fprintf(f, "%%%%MatrixMarket matrix coordinate real symmetric\n");
  fprintf(f, "%d %d %d\n", N, N, 2 * N - 1);
  for (int i = 1; i <= N; ++i) fprintf(f, "%d %d 2.0\n", i, i);
  for (int i = 1; i < N; ++i) fprintf(f, "%d %d -1.0\n", i + 1, i);
  fclose(f);

  atpu_int n = 0, nc = 0, nnz = 0;
  int is_cplx = 1;
  CHECK(atpu_mm_query(path, &n, &nc, &nnz, &is_cplx) == 0, "mm_query rc");
  CHECK(n == N && nc == N, "mm_query dims");
  CHECK(nnz == 3 * N - 2, "mm_query expanded nnz");  /* sym expanded */
  CHECK(is_cplx == 0, "mm_query real");

  atpu_int *indptr = malloc(sizeof(atpu_int) * (size_t)(n + 1));
  atpu_int *indices = malloc(sizeof(atpu_int) * (size_t)nnz);
  double *data = malloc(sizeof(double) * (size_t)nnz);
  CHECK(atpu_mm_read_d(path, indptr, indices, data) == 0, "mm_read rc");
  CHECK(indptr[n] == nnz, "mm_read indptr tail");

  const atpu_int nev = 3;
  double evals[8] = {0};
  double *evecs = malloc(sizeof(double) * (size_t)n * 8);
  atpu_int nconv = 0;
  atpu_int rc = atpu_eigsh_csr_d(n, indptr, indices, data, nnz, nev,
                                 "LA", 1e-10, 16, 500, evals, evecs,
                                 &nconv);
  CHECK(rc == 0 && nconv >= nev, "mm solve");

  double max_res = 1.0;
  rc = atpu_check_eigvec_d(n, 0, indptr, indices, data, nnz, NULL, NULL,
                           NULL, 0, nev, evals, NULL, evecs, NULL, 1e-8,
                           &max_res);
  CHECK(rc == 0, "check_eigvec passes");
  CHECK(max_res < 1e-8, "check_eigvec residual small");
  /* corrupt an eigenvalue: the checker must fail loudly */
  evals[0] += 0.5;
  rc = atpu_check_eigvec_d(n, 0, indptr, indices, data, nnz, NULL, NULL,
                           NULL, 0, nev, evals, NULL, evecs, NULL, 1e-8,
                           &max_res);
  CHECK(rc == 1 && max_res > 1e-3, "check_eigvec catches corruption");
  free(indptr); free(indices); free(data); free(evecs);
  remove(path);
}

static void test_select_mask(void) {
  /* howmny='S' via atpu_set_select (ICB/arpack.hpp:44-48 ritz_specified:
   * the reference documents it but its core returns info=-12; here it
   * works).  Mask is positional over the exit-ordered Ritz values. */
  const atpu_int n = 200, nev = 4;
  double *a = calloc((size_t)(n * n), sizeof(double));
  for (atpu_int i = 0; i < n; ++i) a[i * n + i] = (double)(i + 1);
  double evals[8] = {0};
  double *evecs = malloc(sizeof(double) * (size_t)n * 8);
  atpu_int nconv = 0;
  atpu_int mask[20] = {0};
  mask[0] = 1; mask[2] = 1;   /* Ritz #0 and #2 of the exit ordering */
  CHECK(atpu_set_select(mask, 20) == 0, "set_select rc");
  atpu_int rc = atpu_eigsh_dense_d(n, a, NULL, nev, "LA", 0.0, 0, 1e-10,
                                   20, 500, evals, evecs, &nconv);
  CHECK(rc == 0, "select rc");
  CHECK(nconv == 2, "select count");
  for (atpu_int j = 0; j < nconv; ++j) {
    CHECK(evals[j] > (double)(n - nev) && evals[j] < (double)n + 1e-6,
          "select value in wanted set");
    /* diagonal operator: residual |A v - lambda v| must vanish */
    double res = 0.0, nrm = 0.0;
    for (atpu_int i = 0; i < n; ++i) {
      double d = ((double)(i + 1) - evals[j]) * evecs[j * n + i];
      res += d * d;
      nrm += evecs[j * n + i] * evecs[j * n + i];
    }
    CHECK(nrm > 0.5 && res < 1e-12, "select vec residual");
  }
  CHECK(fabs(evals[0] - evals[1]) > 0.5, "select distinct values");
  /* the mask is one-shot: the next solve returns the full wanted set */
  rc = atpu_eigsh_dense_d(n, a, NULL, nev, "LA", 0.0, 0, 1e-10,
                          20, 500, evals, evecs, &nconv);
  CHECK(rc == 0 && nconv >= nev, "mask cleared after solve");
  free(a);
  free(evecs);
}

/* Matrix-free stencil via the function-pointer entries (the ido-loop
 * capability, SRC/dsaupd.f:68-97): 1-D Laplacian tridiag(-1, 2, -1)
 * applied by a C function, no matrix ever materialized.  Analytic
 * spectrum: 2 - 2 cos(j pi / (n+1)). */
static void lap1d_matvec_d(atpu_int n, const double *x, double *y,
                           void *ctx) {
  (void)ctx;
  for (atpu_int i = 0; i < n; ++i) {
    double v = 2.0 * x[i];
    if (i > 0) v -= x[i - 1];
    if (i + 1 < n) v -= x[i + 1];
    y[i] = v;
  }
}

struct shift_ctx { double shift; };

static void lap1d_matvec_shift_s(atpu_int n, const float *x, float *y,
                                 void *ctx) {
  /* ctx carries a diagonal shift: checks the context pointer plumbing */
  float sh = (float)((struct shift_ctx *)ctx)->shift;
  for (atpu_int i = 0; i < n; ++i) {
    float v = (2.0f + sh) * x[i];
    if (i > 0) v -= x[i - 1];
    if (i + 1 < n) v -= x[i + 1];
    y[i] = v;
  }
}

static void test_matvec_entries(void) {
  const atpu_int n = 300, nev = 3;
  double evals[8] = {0};
  double *evecs = malloc(sizeof(double) * (size_t)n * 8);
  atpu_int nconv = 0;
  atpu_int rc = atpu_eigsh_matvec_d(n, lap1d_matvec_d, NULL, nev, "LA",
                                    1e-10, 20, 2000, evals, evecs,
                                    &nconv);
  CHECK(rc == 0, "matvec_d rc");
  CHECK(nconv >= nev, "matvec_d nconv");
  double pi = 3.14159265358979323846;
  double top = 2.0 - 2.0 * cos(pi * (double)n / (double)(n + 1));
  CHECK(fabs(evals[nev - 1] - top) < 1e-6, "matvec_d top value");
  /* residual oracle with an independent application */
  double *v = evecs + (size_t)(nev - 1) * (size_t)n;
  double *av = malloc(sizeof(double) * (size_t)n);
  lap1d_matvec_d(n, v, av, NULL);
  double res = 0.0;
  for (atpu_int i = 0; i < n; ++i) {
    double d = av[i] - evals[nev - 1] * v[i];
    res += d * d;
  }
  CHECK(sqrt(res) < 1e-7, "matvec_d residual");
  free(av);
  free(evecs);

  /* float nonsym entry + context plumbing (shifted operator) */
  struct shift_ctx sc = {1.5};
  float evr[8] = {0}, evi[8] = {0};
  nconv = 0;
  rc = atpu_eigs_matvec_s(n, lap1d_matvec_shift_s, &sc, nev, "LR", 1e-4,
                          20, 2000, evr, evi, NULL, NULL, &nconv);
  CHECK(rc == 0, "matvec_s rc");
  CHECK(nconv >= nev, "matvec_s nconv");
  CHECK(fabsf(evr[0] - (float)(top + 1.5)) < 1e-2f ||
            fabsf(evr[nconv - 1] - (float)(top + 1.5)) < 1e-2f,
        "matvec_s shifted top value");
  for (atpu_int i = 0; i < nconv && i < nev; ++i)
    CHECK(fabsf(evi[i]) < 1e-4f, "matvec_s real spectrum");
}

int main(void) {
  atpu_debug_c(6, 6, 0, 0, 0, 0, 0, 0, 0, 0);   /* exercise debug_c */
  test_mm_and_check();
  test_dense_d();
  test_dense_s();
  test_csr_d_and_stats();
  test_nonsym_d_schur();
  test_dense_z();
  test_shift_invert_and_checkpoint();
  test_select_mask();
  test_parallel_mesh();
  test_matvec_entries();
  if (failures) {
    fprintf(stderr, "C-ABI: %d failures\n", failures);
    return 1;
  }
  printf("C-ABI OK: all dtype/control/checkpoint tests passed\n");
  return 0;
}
