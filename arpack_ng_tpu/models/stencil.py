"""Stencil model operators (Laplacian / convection-diffusion families).

These reproduce the operator families of the reference example drivers:

* :func:`laplacian_2d` — the 2-D discrete Laplacian on the unit square with
  zero Dirichlet BCs, the ``dssimp`` model problem
  (EXAMPLES/SIMPLE/dssimp.f:47, operator ``av`` at dssimp.f:470-506).
* :func:`laplacian_1d` — the 1-D analog used by dsdrv2-class drivers.
* :func:`convection_diffusion_2d` — the non-symmetric 2-D
  convection-diffusion operator of ``dnsimp``/``dndrv`` drivers
  (EXAMPLES/SIMPLE/dnsimp.f; complex variant: EXAMPLES/COMPLEX/zndrv1.f).

Device implementation: shift-and-pad stencil application — pure
elementwise work at the HBM bandwidth roofline; no matrix is stored.  Each
builder also returns the equivalent ``scipy.sparse`` matrix for
independent-oracle verification.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..config import pad_dim
from ..ops.operator import Operator, from_matvec


def _wrap_padded(stencil_fn, n, n_pad, dtype):
    def matvec(x):
        y = stencil_fn(x[:n])
        if n_pad == n:
            return y
        return jnp.zeros((n_pad,), x.dtype).at[:n].set(y)

    return matvec


def laplacian_1d(n: int, dtype=np.float32, *, pad: bool = True,
                 scale: bool = False) -> Tuple[Operator, sp.spmatrix]:
    """1-D Dirichlet Laplacian: tridiag(-1, 2, -1) (optionally / h^2)."""
    h2inv = (n + 1.0) ** 2 if scale else 1.0
    n_pad = pad_dim(n) if pad else n

    def stencil(u):
        y = 2.0 * u
        y = y - jnp.pad(u[1:], (0, 1))
        y = y - jnp.pad(u[:-1], (1, 0))
        return (h2inv * y).astype(u.dtype)

    op = from_matvec(_wrap_padded(stencil, n, n_pad, dtype), n, dtype,
                     n_pad=n_pad, hermitian=True)
    a = h2inv * sp.diags([-np.ones(n - 1), 2 * np.ones(n),
                          -np.ones(n - 1)], [-1, 0, 1], format="csr")
    return op, a.astype(np.float64)


def laplacian_2d(nx: int, dtype=np.float32, *, pad: bool = True
                 ) -> Tuple[Operator, sp.spmatrix]:
    """2-D Dirichlet Laplacian, 5-point stencil diag 4 / neighbors -1 on an
    nx*nx grid — the dssimp model problem (its eigenvalues are
    4 - 2cos(i*pi*h) - 2cos(j*pi*h))."""
    n = nx * nx
    n_pad = pad_dim(n) if pad else n

    def stencil(x):
        u = x.reshape(nx, nx)
        y = 4.0 * u
        y = y - jnp.pad(u[1:, :], ((0, 1), (0, 0)))
        y = y - jnp.pad(u[:-1, :], ((1, 0), (0, 0)))
        y = y - jnp.pad(u[:, 1:], ((0, 0), (0, 1)))
        y = y - jnp.pad(u[:, :-1], ((0, 0), (1, 0)))
        return y.reshape(-1).astype(x.dtype)

    op = from_matvec(_wrap_padded(stencil, n, n_pad, dtype), n, dtype,
                     n_pad=n_pad, hermitian=True)
    t = sp.diags([-np.ones(nx - 1), 2 * np.ones(nx), -np.ones(nx - 1)],
                 [-1, 0, 1])
    eye = sp.identity(nx)
    a = (sp.kron(eye, t) + sp.kron(t, eye)).tocsr()
    return op, a.astype(np.float64)


def convection_diffusion_1d(n: int, rho: float = 10.0, dtype=np.float32, *,
                            pad: bool = True) -> Tuple[Operator, sp.spmatrix]:
    """1-D convection-diffusion: tridiag(-1-c, 2, -1+c), c = rho*h/2 —
    the dndrv1-class non-symmetric model (EXAMPLES/NONSYM/dndrv1.f)."""
    h = 1.0 / (n + 1)
    c = rho * h / 2.0
    dl, dd, du = -1.0 - c, 2.0, -1.0 + c
    n_pad = pad_dim(n) if pad else n
    cdtype = np.dtype(dtype)

    def stencil(u):
        y = dd * u
        y = y + du * jnp.pad(u[1:], (0, 1))
        y = y + dl * jnp.pad(u[:-1], (1, 0))
        return y.astype(u.dtype)

    op = from_matvec(_wrap_padded(stencil, n, n_pad, cdtype), n, cdtype,
                     n_pad=n_pad, hermitian=False)
    a = sp.diags([dl * np.ones(n - 1), dd * np.ones(n),
                  du * np.ones(n - 1)], [-1, 0, 1], format="csr")
    return op, a.astype(np.float64)


def convection_diffusion_2d(nx: int, rho: float = 100.0, dtype=np.float32, *,
                            pad: bool = True) -> Tuple[Operator, sp.spmatrix]:
    """2-D convection-diffusion (dnsimp model): block structure
    I (x) T + (T0 (x) I) with convection in the x-sweep.  Complex ``dtype``
    gives the zndrv1-class complex operator."""
    n = nx * nx
    h = 1.0 / (nx + 1)
    c = rho * h / 2.0
    dl, dd, du = -1.0 - c, 4.0, -1.0 + c
    n_pad = pad_dim(n) if pad else n
    cdtype = np.dtype(dtype)

    def stencil(x):
        u = x.reshape(nx, nx)
        y = dd * u
        y = y + du * jnp.pad(u[:, 1:], ((0, 0), (0, 1)))
        y = y + dl * jnp.pad(u[:, :-1], ((0, 0), (1, 0)))
        y = y - jnp.pad(u[1:, :], ((0, 1), (0, 0)))
        y = y - jnp.pad(u[:-1, :], ((1, 0), (0, 0)))
        return y.reshape(-1).astype(x.dtype)

    op = from_matvec(_wrap_padded(stencil, n, n_pad, cdtype), n, cdtype,
                     n_pad=n_pad, hermitian=False)
    t = sp.diags([dl * np.ones(nx - 1), dd * np.ones(nx),
                  du * np.ones(nx - 1)], [-1, 0, 1])
    t0 = sp.diags([-np.ones(nx - 1), np.zeros(nx), -np.ones(nx - 1)],
                  [-1, 0, 1])
    eye = sp.identity(nx)
    a = (sp.kron(eye, t) + sp.kron(t0, eye)).tocsr()
    return op, a.astype(np.float64)
