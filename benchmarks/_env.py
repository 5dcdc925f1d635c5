"""Shared set-up for the benchmark scripts: choose the device and place
JAX's compile cache (``arpack_ng_tpu.enable_compile_cache``).

``setup(small)``: with ``small`` the run is a CPU sanity tier at reduced
sizes; otherwise a GPU is required and its absence ends the run (there
is no CPU fallback for a measurement).
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def setup(small: bool):
    import jax
    if small:
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        sys.exit(f"{os.path.basename(sys.argv[0])}: needs a GPU "
                 f"(found {jax.devices()[0].platform!r}); pass --small "
                 "for a CPU sanity run")
    import arpack_ng_tpu as at
    at.enable_compile_cache()
    return jax
