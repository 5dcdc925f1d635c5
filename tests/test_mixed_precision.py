"""Mixed-precision basis storage (storage_dtype): narrow V reads + wide
accumulation — a capability with no reference equivalent
(reference is fixed-precision per s/d/c/z variant).  Accuracy floor is
~ ||A|| * eps(storage_dtype)."""
import jax.numpy as jnp
import numpy as np
import pytest

import arpack_ng_tpu as at


@pytest.fixture
def diag_problem():
    n = 400
    d = np.linspace(1.0, 100.0, n)
    return d, at.from_diagonal(d, n_pad=512)


def test_f32_storage_under_f64(diag_problem):
    d, op = diag_problem
    vals = at.eigsh(op, k=4, which="LA", tol=1e-5, maxiter=500,
                    storage_dtype=jnp.float32, return_eigenvectors=False)
    assert np.abs(np.sort(vals) - np.sort(d)[-4:]).max() < 1e-4


def test_bf16_storage(diag_problem):
    d, op = diag_problem
    vals = at.eigsh(op, k=4, which="LA", tol=5e-3, maxiter=500,
                    storage_dtype=jnp.bfloat16, return_eigenvectors=False)
    rel = np.abs(np.sort(vals) - np.sort(d)[-4:]).max() / d.max()
    assert rel < 3 * float(jnp.finfo(jnp.bfloat16).eps)


def test_hybrid_strategy_mixed(diag_problem):
    d, op = diag_problem
    vals = at.eigsh(op, k=3, which="LA", tol=1e-5, maxiter=500,
                    storage_dtype=jnp.float32, strategy="hybrid",
                    return_eigenvectors=False)
    assert np.abs(np.sort(vals) - np.sort(d)[-3:]).max() < 1e-4


def test_vectors_returned_wide(diag_problem):
    d, op = diag_problem
    vals, vecs = at.eigsh(op, k=2, which="LA", tol=1e-4, maxiter=500,
                          storage_dtype=jnp.float32)
    assert vecs.dtype == np.float64 or vecs.dtype == np.float32
    # residual at the mixed-precision floor (~ ||A|| * eps(f32) * growth)
    for i in range(2):
        r = np.abs(d * vecs[:, i] - vals[i] * vecs[:, i]).max()
        assert r < 5e-3


def test_complex_storage_rejected():
    from arpack_ng_tpu.config import IRAMConfig
    from arpack_ng_tpu.core.arnoldi import make_extend
    op = at.from_diagonal((np.arange(1.0, 101.0) + 0j).astype(complex))
    cfg = IRAMConfig(n=100, nev=2, ncv=8, which="LM", symmetric=False,
                     dtype=np.complex128, n_pad=op.n_pad,
                     storage_dtype=jnp.bfloat16)
    with pytest.raises(ValueError, match="real"):
        make_extend(op, cfg)
