"""Test configuration.

Tests run on CPU with 8 virtual devices (the reference tests multi-node as
multi-process on one node under ``mpiexec -n 2``, CMakeLists.txt:75; the
analog here is a virtual host-platform device mesh).  float64 is enabled so
the reference's double-precision (d/z) paths can be tested bit-seriously.

``JAX_PLATFORMS`` defaults to ``cpu``.  Tests marked ``gpu`` take the
``gpu`` fixture, which skips unless the first JAX device is a GPU; run
them on a card with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``
(``python chip_smoke.py`` is the full on-card check).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest
import scipy.sparse as sp


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skips otherwise.  Decided
    here, at test time, never while a module is imported."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev


def residual(a_sp, vals, vecs, m_sp=None):
    """Independent-oracle residual ||A v - lambda (M) v|| / |lambda| — the
    reference's universal check (arpackSolver.hpp:297-323)."""
    res = []
    for i in range(len(vals)):
        v = vecs[:, i]
        av = a_sp @ v
        mv = (m_sp @ v) if m_sp is not None else v
        res.append(np.linalg.norm(av - vals[i] * mv)
                   / max(1.0, abs(vals[i])))
    return np.array(res)
