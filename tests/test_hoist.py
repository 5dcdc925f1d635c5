"""utils/hoist.hoisted_jit: closure-captured device arrays must become
jit arguments (kept out of the lowered module), with unchanged numerics
and working donation.  Motivation: captured operator data would
otherwise be embedded as literals in every lowered module."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from arpack_ng_tpu.utils.hoist import hoisted_jit


@pytest.fixture
def big():
    return jnp.asarray(
        np.random.default_rng(0).standard_normal(1 << 16).astype(np.float32))


def test_matches_plain_jit_and_hoists(big):
    def fn(x):
        return x * big + jnp.sum(x * big)

    x = jnp.ones(1 << 16, jnp.float32)
    ref = jax.jit(fn)(x)
    h = hoisted_jit(fn)
    got = h(x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-6)
    (jitted, consts), = h._cache.values()
    assert len(consts) == 1 and consts[0].nbytes == big.nbytes
    low = jitted.lower(x, *consts)
    # the 256 KB array must NOT be embedded in the module text
    assert len(low.as_text()) < 64 * 1024


def test_pytree_args_and_donation(big):
    def fn(state, n):
        V, r = state
        def body(i, c):
            V, r = c
            r = r * 0.5 + 1e-3 * big
            return V + r[None, :8], r
        return jax.lax.fori_loop(0, n, body, (V, r))

    V0 = jnp.zeros((4, 8), jnp.float32)
    r0 = jnp.ones(1 << 16, jnp.float32)
    h = hoisted_jit(fn, donate_argnums=(0,))
    V1, r1 = h((V0, r0), jnp.int32(3))
    ref = jax.jit(fn)((jnp.zeros((4, 8), jnp.float32),
                       jnp.ones(1 << 16, jnp.float32)), jnp.int32(3))
    np.testing.assert_allclose(np.asarray(V1), np.asarray(ref[0]),
                               rtol=1e-6)
    V2, r2 = h((V1, r1), jnp.int32(3))   # second call donates V1/r1
    assert np.all(np.isfinite(np.asarray(V2)))
    assert V1.is_deleted()               # donation actually happened


def test_retrace_on_new_shapes(big):
    def fn(x):
        return x + big[: x.shape[0]]

    h = hoisted_jit(fn)
    a = h(jnp.ones(16, jnp.float32))
    b = h(jnp.ones(32, jnp.float32))
    assert a.shape == (16,) and b.shape == (32,)
    assert len(h._cache) == 2


def test_small_consts_stay_embedded():
    tiny = jnp.arange(4, dtype=jnp.float32)

    def fn(x):
        return x + tiny

    h = hoisted_jit(fn)
    h(jnp.ones(4, jnp.float32))
    (_, consts), = h._cache.values()
    assert consts == []   # below min_bytes: left as a literal
