"""``chip_smoke.py``: its check functions, its phases at small sizes on the
CPU (the same code the card runs at full size), and its refusal to run
without a GPU."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def _dense_laplacian_eigs(nx):
    from arpack_ng_tpu import models
    _, a = models.laplacian_2d(nx, dtype=np.float64)
    return np.sort(np.linalg.eigvalsh(a.toarray()))[::-1]


@pytest.mark.parametrize("nx", [5, 8])
def test_closed_form_spectrum(nx):
    ev = _dense_laplacian_eigs(nx)
    np.testing.assert_allclose(cs.laplacian_2d_top(nx, 12), ev[:12],
                               atol=1e-12)
    assert abs(cs.laplacian_2d_max(nx) - ev[0]) < 1e-12
    # every eigenvalue is at distance ~0 from the closed-form set
    assert cs.laplacian_2d_distance(nx, ev).max() < 1e-12


def test_membership_and_ghost_checks():
    top = cs.laplacian_2d_top(32, 16)
    lmax = cs.laplacian_2d_max(32)
    # a doublet returned once still passes membership
    vals = np.array([top[0], top[1], top[5]])
    assert cs.membership_error(vals, top) < 1e-14
    assert cs.ghost_excess(vals, lmax) <= 0.0
    # a ghost Ritz value above the spectrum fails both
    ghost = np.append(vals, lmax * 1.01)
    assert cs.ghost_excess(ghost, lmax) > 1e-3
    assert cs.membership_error(ghost, top) > 1e-3


def test_residuals_oracle():
    from arpack_ng_tpu import models
    _, a = models.laplacian_2d(6, dtype=np.float64)
    w, v = np.linalg.eigh(a.toarray())
    r = cs.residuals(a, w[-3:], v[:, -3:])
    assert r.max() < 1e-12
    # a perturbed pair shows its residual
    r_bad = cs.residuals(a, w[-3:] * 1.01, v[:, -3:])
    assert r_bad.min() > 1e-3


def test_phase_flagship_small():
    assert cs.phase_flagship(nx=32)


def test_phase_bf16_small():
    assert cs.phase_bf16(nx=32)


def test_phase_nonsym_small():
    assert cs.phase_nonsym(nx=24)


def test_phase_four_small_virtual_mesh():
    # 4 of the 8 virtual CPU devices (tests/conftest.py)
    assert cs.phase_four(nx=64)


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    r = _run([str(ROOT / "chip_smoke.py")], ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""          # no result line
    assert "no GPU" in r.stderr


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


@pytest.mark.gpu
def test_smoke_phases_on_card(gpu):
    """The single-card phases at reduced size, in this process, on a GPU."""
    assert cs.phase_flagship(nx=256)
    assert cs.phase_bf16(nx=256)
    assert cs.phase_nonsym(nx=128)
