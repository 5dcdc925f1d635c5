"""Restart rotation and narrow-storage contractions (core/arnoldi.py).

* ``rotate_basis_kev`` — the dsapps kev-row update (SRC/dsapps.f:445-481)
  as a bucketed ``dot + dynamic_update_slice``: the surviving rows must
  equal the full rotation ``Q^T V`` for every bucket the ``lax.switch``
  can pick.
* bf16 basis storage — the native bf16 x bf16 -> f32 contractions
  (``preferred_element_type``) against an f32 reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from arpack_ng_tpu import models
from arpack_ng_tpu.config import IRAMConfig
from arpack_ng_tpu.core import arnoldi


def _basis(ncv, npan, dtype, seed=0):
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((ncv, npan, 128)).astype(np.float32)
    Q, _ = np.linalg.qr(rng.standard_normal((ncv, ncv)))
    return jnp.asarray(V).astype(dtype), jnp.asarray(Q, jnp.float32)


@pytest.mark.parametrize("ncv,kev", [
    (32, 1), (32, 7), (32, 8), (32, 15), (32, 16), (32, 23), (32, 24),
    (32, 31), (20, 3), (20, 12), (20, 19), (8, 5),
])
def test_kev_rotation_matches_full_for_every_bucket(ncv, kev):
    V, Q = _basis(ncv, 4, jnp.float32, seed=kev)
    full = np.einsum("ij,ipl->jpl", np.asarray(Q), np.asarray(V))
    for need_next in (True, False):
        Vn, vnext, rows = arnoldi.rotate_basis_kev(
            Q, V, jnp.int32(kev), jnp.float32, need_next=need_next)
        rows = int(rows)
        want = kev + (1 if need_next else 0)
        # bucketed to a multiple of 8 (or ncv), never fewer than needed
        assert rows >= min(want, ncv)
        assert rows == ncv or rows % arnoldi._ROT_BUCKET == 0
        np.testing.assert_allclose(np.asarray(Vn)[:rows], full[:rows],
                                   rtol=1e-5, atol=1e-5)
        # rows past the bucket keep their stale values (never read)
        np.testing.assert_array_equal(np.asarray(Vn)[rows:],
                                      np.asarray(V)[rows:])
        np.testing.assert_allclose(np.asarray(vnext),
                                   full[min(kev, rows - 1)],
                                   rtol=1e-5, atol=1e-5)


def test_bf16_rotation_matches_f32_reference():
    V, Q = _basis(32, 4, jnp.bfloat16)
    out = arnoldi.rotate_basis(Q, V, jnp.float32)
    assert out.dtype == jnp.bfloat16
    ref = np.einsum("ij,ipl->jpl", np.asarray(Q.astype(jnp.bfloat16)
                                              .astype(jnp.float32)),
                    np.asarray(V.astype(jnp.float32)))
    # one bf16 rounding of the output (2^-8 relative)
    np.testing.assert_allclose(np.asarray(out.astype(jnp.float32)), ref,
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("reorth", ["dgks", "selective"])
def test_bf16_storage_extension_matches_f32(reorth):
    """One full Lanczos extension with a bf16 basis (native mixed dots)
    gives the f32 projected matrix to bf16 accuracy, and a basis that is
    orthonormal to bf16 accuracy."""
    import jax
    op, _ = models.laplacian_2d(16, dtype=np.float32)
    out = {}
    for sdt in (None, jnp.bfloat16):
        cfg = IRAMConfig(n=op.n, nev=4, ncv=16, which="LA", symmetric=True,
                         dtype=np.dtype(np.float32), n_pad=op.n_pad,
                         storage_dtype=sdt, reorth=reorth)
        init = arnoldi.make_init(op, cfg)
        ext = arnoldi.make_extend(op, cfg)
        st = jax.jit(lambda k: init(k, None))(jax.random.key(3))
        st = jax.jit(ext)(st, jnp.int32(cfg.ncv))
        out[sdt] = st
    H32 = np.asarray(out[None].H)
    H16 = np.asarray(out[jnp.bfloat16].H)
    np.testing.assert_allclose(np.diag(H16), np.diag(H32), atol=5e-2)
    np.testing.assert_allclose(np.diag(H16, -1), np.diag(H32, -1),
                               atol=5e-2)
    Vb = arnoldi.v_matrix(out[jnp.bfloat16].V.astype(jnp.float32))
    G = Vb @ Vb.T
    assert np.abs(G - np.eye(G.shape[0])).max() < 5e-2
