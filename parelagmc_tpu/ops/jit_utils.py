"""jit with closure constants hoisted to runtime arguments.

Our solver/sampler steps close over large static operator pytrees (ELL
tables, spectral factors, MG hierarchies). Plain jax.jit embeds captured
concrete arrays as *constants in the lowered module*, which bloats the
serialized program (hundreds of MB at SPE10 scale), slows compilation and
keeps a second copy of every table in the executable. `jit_hoisted` traces the
function once with make_jaxpr, extracts the captured constants, and returns
a wrapper that passes them to a jitted pure evaluator as ordinary device
arguments instead.

The wrapped function must be called with arguments structurally identical
to the example (same shapes/dtypes/pytree) - exactly the contract of the
managers' per-level steps.
"""

from __future__ import annotations

from typing import Callable

import jax
from jax import tree_util
from jax.core import eval_jaxpr


def jit_hoisted(fn: Callable, *example_args) -> Callable:
    """Return g(*args) == fn(*args), jitted, with closure constants passed
    as runtime arguments (not embedded in the compiled module)."""
    flat_ex, in_tree = tree_util.tree_flatten(example_args)
    store = {}

    def flat_fn(*flat_args):
        args = tree_util.tree_unflatten(in_tree, list(flat_args))
        out = fn(*args)
        flat_out, out_tree = tree_util.tree_flatten(out)
        store["out_tree"] = out_tree
        return flat_out

    closed = jax.make_jaxpr(flat_fn)(*flat_ex)
    out_tree = store["out_tree"]
    consts = closed.consts
    jaxpr = closed.jaxpr

    def pure(consts, flat_args):
        res = eval_jaxpr(jaxpr, consts, *flat_args)
        return tree_util.tree_unflatten(out_tree, list(res))

    jitted = jax.jit(pure)

    def wrapper(*args):
        flat_args, tree = tree_util.tree_flatten(args)
        if tree != in_tree:
            raise TypeError("jit_hoisted: argument structure changed")
        return jitted(consts, flat_args)

    wrapper._consts = consts  # noqa: SLF001 (introspection/testing)

    def aot_compile():
        jitted.lower(consts, flat_ex).compile()

    def memory_analysis():
        """Compile-only device-memory probe: returns the backend's
        CompiledMemoryStats without executing - evidence that a program
        fits the device before paying a real run."""
        return jitted.lower(consts, flat_ex).compile().memory_analysis()

    wrapper.aot_compile = aot_compile
    wrapper.memory_analysis = memory_analysis
    return wrapper
