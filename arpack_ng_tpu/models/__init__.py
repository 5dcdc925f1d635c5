"""Model problems: the reference's EXAMPLES driver matrices as device
operators (EXAMPLES/SIMPLE/dssimp.f, EXAMPLES/NONSYM/dndrv*.f,
EXAMPLES/COMPLEX/zndrv*.f families).

Each model provides both a device operator (stencil matvec — bandwidth-bound
elementwise code, no matrix storage) and the equivalent scipy.sparse matrix for
independent-oracle residual checks, following the reference test strategy of
verifying ``||A x - lambda x||`` with an independent matvec
(EXAMPLES/MATRIX_MARKET/arpackSolver.hpp:297-323).
"""
from .stencil import (
    laplacian_1d,
    laplacian_2d,
    convection_diffusion_1d,
    convection_diffusion_2d,
)

__all__ = [
    "laplacian_1d",
    "laplacian_2d",
    "convection_diffusion_1d",
    "convection_diffusion_2d",
]
