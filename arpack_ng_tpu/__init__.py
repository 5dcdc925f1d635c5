"""arpack_ng_tpu: a GPU-accelerated large-scale eigensolver framework with
the capabilities of arpack-ng (FabienPean/arpack-ng) — Implicitly Restarted
Arnoldi/Lanczos for symmetric, non-symmetric and complex standard and
generalized eigenproblems, shift-invert/buckling/Cayley spectral transforms,
and SVD — redesigned for JAX/XLA on an accelerator:

* operator callables instead of the Fortran reverse-communication interface,
* one dtype-parametric core instead of the s/d/c/z source quadruplication,
* explicit pytree solver state (checkpointable, reentrant) instead of
  Fortran ``save`` state,
* O(n) work jit-compiled on device; the NCV-sized reduced subproblem
  replicated on host exactly like PARPACK replicates ``workl``,
* distribution via jax.sharding meshes + XLA collectives instead of
  MPI/BLACS source duplication.
"""

from .api import (
    ArpackError,
    ArpackNoConvergence,
    F64Validation,
    PseudospectrumWarning,
    eigs,
    eigsh,
)
from .config import IRAMConfig, default_ncv, pad_dim
from .core.arnoldi import FactorizationState
from .core.extract import EigenResult, extract
from .core.iram import IRAMResult, IRAMSolver
from .core.svd import svds
from .ops.operator import Operator, from_dense, from_diagonal, from_matvec

__version__ = "0.5.0"


def enable_compile_cache() -> str:
    """Enable JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its
    cache there and no other path is set.  Otherwise the cache goes to
    ``.jax_cache`` at the root of this checkout (next to the package), a
    fixed path so that later runs find what earlier ones compiled.
    """
    import os

    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
    return path


__all__ = [
    "ArpackError",
    "ArpackNoConvergence",
    "EigenResult",
    "F64Validation",
    "PseudospectrumWarning",
    "FactorizationState",
    "IRAMConfig",
    "IRAMResult",
    "IRAMSolver",
    "Operator",
    "default_ncv",
    "eigs",
    "eigsh",
    "enable_compile_cache",
    "extract",
    "from_dense",
    "from_diagonal",
    "from_matvec",
    "pad_dim",
    "svds",
]
