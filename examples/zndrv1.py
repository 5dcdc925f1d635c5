"""zndrv1 equivalent (EXAMPLES/COMPLEX/zndrv1.f): complex-arithmetic
standard eigenproblem.

Run:  python examples/zndrv1.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

import arpack_ng_tpu as at
from arpack_ng_tpu import models


def main(nx=16):
    import jax

    # The driver runs on CPU, exactly like the test suite does (its
    # complex128 reduced precision wants float64).
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    op, a_sp = models.convection_diffusion_2d(nx, rho=80.0,
                                              dtype=np.complex128)
    vals, vecs = at.eigs(op, k=4, which="LM", tol=1e-10)
    for i, lam in enumerate(vals):
        r = np.linalg.norm(a_sp @ vecs[:, i] - lam * vecs[:, i])
        print(f"  lambda[{i}] = {lam:.8f}   resid = {r:.3e}")


if __name__ == "__main__":
    main()
