"""Constant-hoisting jit: keep closure-captured device arrays OUT of the
lowered module by passing them as arguments.

Why this exists: tracing a closure that captures a concrete device array
embeds the array as a dense literal in the lowered StableHLO — a single
captured 4 MB vector produces an 8.4 MB module text, and operator data
(DIA diagonals, dense matrices, banded cyclic-reduction factors, ILU
triangles; the stride-free BCR factors reach ~400 MB) inflates every
module that carries it.  ``jax.closure_convert`` does not hoist these in
this JAX version, so this module does it at the jaxpr level: trace once
with ``make_jaxpr``, split the jaxpr consts into big (hoisted to
arguments) and small (left to re-trace as literals), and jit an
``eval_jaxpr`` wrapper.  (Its compile-time effect on the GPU has not
been measured.)

The reference has no analog, but the role matches the reference's
insistence that the USER owns the matrix storage (RCI): solver
compilations stay matrix-free.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import jax
import numpy as np
from jax import core as jcore
from jax import tree_util as jtu


def _aval_key(leaves):
    out = []
    for x in leaves:
        dt = getattr(x, "dtype", None)
        out.append((np.shape(x), str(dt) if dt is not None
                    else str(type(x))))
    return tuple(out)


class hoisted_jit:
    """``jax.jit`` drop-in for fixed-signature solver entry points.

    On first call (per input pytree-structure/avals) the wrapped function
    is traced, array constants >= ``min_bytes`` become explicit jit
    arguments (their values are remembered and passed automatically on
    every call), and the result is jitted with the requested donation.
    Subsequent calls with matching avals reuse the compiled function.
    """

    def __init__(self, fn: Callable, donate_argnums: Tuple[int, ...] = (),
                 min_bytes: int = 4096):
        self._fn = fn
        self._donate = tuple(donate_argnums)
        self._min_bytes = int(min_bytes)
        self._cache: Dict[Any, Tuple[Callable, list]] = {}

    def _build(self, args):
        flat, in_tree = jtu.tree_flatten(args)
        out_tree_box = []

        def flat_fn(*leaves):
            a = jtu.tree_unflatten(in_tree, leaves)
            out = self._fn(*a)
            out_flat, out_tree = jtu.tree_flatten(out)
            out_tree_box.append(out_tree)
            return out_flat

        closed = jax.make_jaxpr(flat_fn)(*flat)
        out_tree = out_tree_box[0]
        consts = list(closed.consts)
        big_ix = [i for i, c in enumerate(consts)
                  if getattr(c, "nbytes", 0) >= self._min_bytes]
        big_vals = [consts[i] for i in big_ix]
        jaxpr = closed.jaxpr
        n_args = len(flat)

        # donation: map original positional donations to flat leaf indices
        donate_flat = []
        if self._donate:
            sizes = [len(jtu.tree_leaves(a)) for a in args]
            starts = np.concatenate([[0], np.cumsum(sizes)]).tolist()
            for d in self._donate:
                donate_flat.extend(range(starts[d], starts[d + 1]))

        def conv(*all_flat):
            leaves = all_flat[:n_args]
            big = all_flat[n_args:]
            cs = list(consts)
            for i, v in zip(big_ix, big):
                cs[i] = v
            outs = jcore.eval_jaxpr(jaxpr, cs, *leaves)
            return jtu.tree_unflatten(out_tree, outs)

        jitted = jax.jit(conv, donate_argnums=tuple(donate_flat))
        return jitted, big_vals

    def __call__(self, *args):
        flat = jtu.tree_leaves(args)
        key = (jtu.tree_structure(args), _aval_key(flat))
        ent = self._cache.get(key)
        if ent is None:
            ent = self._build(args)
            self._cache[key] = ent
        jitted, big_vals = ent
        return jitted(*flat, *big_vals)
