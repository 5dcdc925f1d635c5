"""PSELL panel-tiled irregular-SpMV format (ops/psell.py) — packing
invariants and the one-hot XLA matvec on the corpus classes that stress
it (FEM-class local irregularity, power-law hubs), vs scipy as oracle."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from arpack_ng_tpu.ops import psell as ps


def _rand_sparse(n, density, rng, pattern="uniform"):
    if pattern == "uniform":
        a = sp.random(n, n, density=density, random_state=rng,
                      format="csr", dtype=np.float64)
    elif pattern == "powerlaw":
        # hub columns: degree ~ 1/rank
        rows, cols, vals = [], [], []
        nnz = int(n * n * density)
        ranks = rng.zipf(1.8, size=nnz) % n
        rows = rng.integers(0, n, nnz)
        vals = rng.standard_normal(nnz)
        a = sp.csr_matrix((vals, (rows, ranks)), shape=(n, n))
        a.sum_duplicates()
    else:  # banded-ish FEM look-alike
        diags = [rng.standard_normal(n) for _ in range(7)]
        offs = [0, 1, -1, 40, -40, 41, -41]
        a = sp.diags(
            [d[: n - abs(o)] for d, o in zip(diags, offs)], offs,
            shape=(n, n)).tocsr()
    return a


def test_pack_uniform_counts():
    rng = np.random.default_rng(0)
    a = _rand_sparse(3000, 5e-3, rng)
    pk = ps.pack_psell_uniform(a)
    assert pk.nnz == a.nnz
    assert pk.vals.shape == pk.meta.shape
    nchunks = pk.n_pad // ps.CHUNK
    assert pk.vals.shape[0] == pk.p_idx.shape[0] == nchunks * pk.W
    # every nonzero is stored exactly once; padding slots are zero
    assert np.count_nonzero(pk.vals) == np.count_nonzero(a.data)
    np.testing.assert_allclose(np.sort(pk.vals[pk.vals != 0]),
                               np.sort(a.data[a.data != 0]))


def test_from_scipy_psell_operator():
    """format='psell' through the importer: operator matvec == scipy."""
    from arpack_ng_tpu.ops.sparse import from_scipy
    rng = np.random.default_rng(3)
    n = 2000
    a = _rand_sparse(n, 4e-3, rng)
    a = (a + a.T).tocsr()
    op = from_scipy(a, format="psell", hermitian=True)
    assert op.format == "psell"
    x = rng.standard_normal(n)
    y = op.matvec(x)
    np.testing.assert_allclose(y, a @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-12),
                                        ("float32", 2e-5)])
@pytest.mark.parametrize("pattern", ["uniform", "powerlaw", "fem"])
def test_uniform_matvec_matches_scipy(pattern, dtype, rtol):
    rng = np.random.default_rng(4)
    n = 2500
    a = _rand_sparse(n, 4e-3, rng, pattern).astype(dtype)
    pk = ps.pack_psell_uniform(a)
    C = pk.n_pad // ps.CHUNK
    assert pk.vals.shape[0] == C * pk.W
    x = rng.standard_normal(pk.n_pad).astype(dtype)
    x[n:] = 0.0
    mv = ps.make_psell_matvec_xla(C, pk.W, pk.n_pad, dtype)
    y = np.asarray(mv(jnp.asarray(pk.vals), jnp.asarray(pk.meta),
                      jnp.asarray(pk.p_idx), jnp.asarray(x)))
    ref = a.astype(np.float64) @ x[:n].astype(np.float64)
    scale = abs(a).astype(np.float64) @ np.abs(x[:n]).astype(np.float64)
    np.testing.assert_array_less(np.abs(y[:n] - ref), rtol * scale + 1e-300)
    np.testing.assert_allclose(y[n:], 0.0, atol=1e-300)


def test_psell_sharded_solve_cpu_mesh():
    """The uniform-W PSELL matvec is pure XLA: it must compile and solve
    under a row-sharded mesh (GSPMD inserts the gathers/collectives) —
    coverage for mesh users importing irregular matrices."""
    import jax
    from arpack_ng_tpu.ops.sparse import from_scipy
    from arpack_ng_tpu.parallel.sharding import make_mesh
    import arpack_ng_tpu as at
    if len(jax.devices()) < 4:
        pytest.skip("needs >=4 devices")
    rng = np.random.default_rng(5)
    n = 4096
    a = _rand_sparse(n, 3e-3, rng)
    a = (a + a.T).tocsr()
    a = a + sp.diags(np.full(n, 10.0))
    op = from_scipy(a, hermitian=True, format="psell")
    mesh = make_mesh(4)
    vals, vecs = at.eigsh(op, k=3, which="LA", ncv=14, tol=1e-8,
                          maxiter=2000, mesh=mesh)
    import scipy.sparse.linalg as sla
    ref = sla.eigsh(a, k=3, which="LA", tol=1e-10,
                    return_eigenvectors=False)
    np.testing.assert_allclose(np.sort(vals), np.sort(ref), rtol=1e-6)


def test_psell_nonsym_eigs():
    """PSELL is dtype/symmetry-agnostic: a non-symmetric irregular
    matrix solves through eigs with scipy parity."""
    import scipy.sparse.linalg as sla
    import arpack_ng_tpu as at
    from arpack_ng_tpu.ops.sparse import from_scipy
    rng = np.random.default_rng(9)
    n = 3000
    a = _rand_sparse(n, 3e-3, rng)
    a = (a + sp.diags(5.0 + rng.random(n))).tocsr()
    op = from_scipy(a, hermitian=False, format="psell")
    vals = at.eigs(op, k=3, which="LM", ncv=18, tol=1e-8, maxiter=2000,
                   return_eigenvectors=False)
    ref = sla.eigs(a, k=3, which="LM", tol=1e-10,
                   return_eigenvectors=False)
    np.testing.assert_allclose(np.sort_complex(vals),
                               np.sort_complex(ref), rtol=1e-6)
