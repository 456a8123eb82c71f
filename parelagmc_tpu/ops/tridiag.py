"""Batched tridiagonal line solves along the LAST axis, and the choice of
route for them.

Every exact line solve of the package goes through `solve_lines`: the
tensor-grid RT0 mass inverse M(w)^{-1} applied inside each Schur-CG
iteration (ops/mass_solve.py), the line smoother of the structured
per-sample Schur multigrid (ops/coef_multigrid_structured.py) and the
shard-local solves of the spatially sharded Darcy solver
(parallel/spatial_darcy.py). The systems are SPD and diagonally dominant
(RT0 mass lines, M-matrix smoother lines), so the Thomas recurrence needs
no pivoting:

    forward   c_i = du_i / (d_i - dl_i c_{i-1}),
              g_i = (b_i - dl_i g_{i-1}) / (d_i - dl_i c_{i-1});
    backward  x_i = g_i - c_i x_{i+1}.

Routes (`ROUTES`):

* "triton": the whole recurrence in one Pallas kernel compiled through
  Triton for the GPU (`thomas_triton`). Lines sit on the contiguous axis,
  so each row step is one coalesced load per operand across a block of
  lines; the carry stays in registers and c/g go to one extra output that
  the backward sweep reads back.
* "thomas": the same recurrence as a lax.scan over rows (`thomas_scan`);
  ~2n sequential loop steps, each a kernel over all lines.
* "gtsv": jax.lax.linalg.tridiagonal_solve (LAPACK gtsv on the CPU,
  cuSPARSE gtsv2 on the GPU).

`resolve_route` is the one decider: an active `route_override`, else
`choose_route` by backend, size and dtype. Pallas' interpreter runs the
Triton kernel on the CPU for the tests only (`interpret=True`); no route
falls back to it.

Reference context: the reference never needs this - hypre AMG smooths
unstructured velocity blocks (src/DarcySolver.cpp:562-649); the exact
line-solve path exists because tensor-product RT0 mass matrices decouple
into tridiagonal lines (ops/mass_solve.py docstring).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

ROUTES = ("triton", "thomas", "gtsv")

# Lines per Triton program: a power of two (Triton's block rule) small
# enough that an SPE10 level-0 apply launches thousands of programs
# (>= 132, one per SM, with room to hide memory latency).
_BLOCK_LINES = 128
# Rows of loads each Triton program keeps in flight ahead of the recurrence.
_DEPTH = 4

# CPU crossover between the LAPACK primitive and the scan (unknowns per
# call): small systems favour the primitive's per-line loop, large ones the
# scan that sweeps all lines per row.
_CPU_SCAN_MIN_SIZE = 32768
_GTSV_DTYPES = (jnp.dtype(jnp.float32), jnp.dtype(jnp.float64))


# route_override(route) makes every line solve TRACED inside it take
# `route` (a program compiled before keeps the route it was traced with).
# It exists for end-to-end A/B runs of the routes (chip_smoke.py
# --compare-routes and its tridiag phase) and for tests.
_ROUTE_OVERRIDE = contextvars.ContextVar("tridiag_route", default=None)


@contextlib.contextmanager
def route_override(route: str):
    if route not in ROUTES:
        raise ValueError(f"unknown line-solve route {route!r}; expected {ROUTES}")
    tok = _ROUTE_OVERRIDE.set(route)
    try:
        yield
    finally:
        _ROUTE_OVERRIDE.reset(tok)


def choose_route(size: int, dtype=jnp.float32, backend: str | None = None) -> str:
    """Line-solve route for `size` unknowns of `dtype` on `backend`
    (default: the platform of JAX's first device). On the GPU the Triton
    kernel beat cuSPARSE gtsv2 and the scan end to end (PERF.md, "Kernel
    decisions")."""
    backend = backend or jax.devices()[0].platform
    if backend == "gpu":
        return "triton"
    if size > _CPU_SCAN_MIN_SIZE or jnp.dtype(dtype) not in _GTSV_DTYPES:
        return "thomas"
    return "gtsv"


def resolve_route(size: int, dtype) -> str:
    """The route a solve takes: the active route_override, else
    choose_route(size, dtype)."""
    return _ROUTE_OVERRIDE.get() or choose_route(size, dtype)


def solve_lines(dl, d, du, b):
    """Solve tridiag(dl, d, du) x = b along the LAST axis, batched over all
    leading axes (dl/d/du broadcast against b), by the route resolve_route
    picks for b's size."""
    route = resolve_route(int(np.prod(b.shape)), b.dtype)
    return _ROUTE_SOLVE[route](dl, d, du, b)


def gtsv_solve(dl, d, du, b):
    """jax.lax.linalg.tridiagonal_solve with one right-hand side per line
    (it wants the solved axis at -2 and a num-rhs axis at -1)."""
    from jax.lax.linalg import tridiagonal_solve

    return tridiagonal_solve(
        jnp.broadcast_to(dl, b.shape),
        jnp.broadcast_to(d, b.shape),
        jnp.broadcast_to(du, b.shape),
        b[..., None],
    )[..., 0]


def thomas_scan(dl, d, du, b):
    """Batched Thomas algorithm as a lax.scan over the rows, with the solved
    axis moved first so every step sweeps all lines at once."""
    move = lambda x: jnp.moveaxis(jnp.broadcast_to(x, b.shape), -1, 0)
    dl_s, d_s, du_s, b_s = move(dl), move(d), move(du), move(b)

    def fwd(carry, row):
        c_prev, g_prev = carry
        dl_i, d_i, du_i, b_i = row
        denom = d_i - dl_i * c_prev
        c_i = du_i / denom
        g_i = (b_i - dl_i * g_prev) / denom
        return (c_i, g_i), (c_i, g_i)

    zero = jnp.zeros_like(b_s[0])
    (_, _), (c, g) = jax.lax.scan(fwd, (zero, zero), (dl_s, d_s, du_s, b_s))

    def bwd(x_next, row):
        c_i, g_i = row
        x_i = g_i - c_i * x_next
        return x_i, x_i

    _, xs = jax.lax.scan(bwd, zero, (c, g), reverse=True)
    return jnp.moveaxis(xs, 0, -1)


def _compute_dtype(dtype):
    """Arithmetic dtype inside the kernel: float32 for narrower floats (the
    bfloat16 preconditioner state), the input dtype otherwise."""
    return jnp.float64 if jnp.dtype(dtype) == jnp.float64 else jnp.float32


def _thomas_kernel(dl_ref, d_ref, du_ref, b_ref, x_ref, c_ref, *, depth):
    """One program: `block` lines (the minor axis of every ref), all n rows.
    g is written into x_ref on the way down and overwritten by x on the way
    up; each element is read back by the thread that wrote it.

    The recurrence is a chain of 2n dependent steps, so a program's time is
    that chain's latency. The loads of a row do not depend on the carry:
    each step issues the loads of the row `depth` steps ahead and computes
    with rows loaded earlier, keeping `depth` rows of loads in flight."""
    n = b_ref.shape[0]
    cdt = c_ref.dtype
    zero = jnp.zeros(b_ref.shape[1:], cdt)

    def row(i):
        i = jnp.minimum(i, n - 1)  # look-ahead past the end: unused
        return tuple(r[i, :].astype(cdt) for r in (dl_ref, d_ref, du_ref, b_ref))

    def fwd(i, carry):
        c_prev, g_prev, queue = carry
        ahead = row(i + depth)
        dl_i, d_i, du_i, b_i = queue[0] if depth else ahead
        inv = 1.0 / (d_i - dl_i * c_prev)
        c_i = du_i * inv
        g_i = (b_i - dl_i * g_prev) * inv
        c_ref[i, :] = c_i
        x_ref[i, :] = g_i.astype(x_ref.dtype)
        return c_i, g_i, queue[1:] + (ahead,) if depth else ()

    queue = tuple(row(j) for j in range(depth))
    _, g_last, _ = jax.lax.fori_loop(0, n, fwd, (zero, zero, queue))

    def back_row(i):
        i = jnp.maximum(i, 0)  # look-ahead past the start: unused
        return x_ref[i, :].astype(cdt), c_ref[i, :]

    def bwd(j, carry):
        x_next, queue = carry
        i = n - 2 - j
        ahead = back_row(i - depth)
        g_i, c_i = queue[0] if depth else ahead
        x_i = g_i - c_i * x_next
        x_ref[i, :] = x_i.astype(x_ref.dtype)
        return x_i, queue[1:] + (ahead,) if depth else ()

    # x_{n-1} = g_{n-1} is already in place. Rows below i still hold g
    # while the backward sweep looks ahead at them.
    queue = tuple(back_row(n - 2 - j) for j in range(depth))
    jax.lax.fori_loop(0, n - 1, bwd, (g_last, queue))


def _to_rows(x, shape, lp: int, pad_value):
    """(lines..., n) broadcast to `shape` -> (n, lp): the solved axis leads
    and lines are the contiguous axis, padded to lp lines that solve
    pad_value * x = 0."""
    n = shape[-1]
    nlines = int(np.prod(shape[:-1]))
    x = jnp.broadcast_to(x, shape).reshape(nlines, n).T
    if lp != nlines:
        x = jnp.pad(x, ((0, 0), (0, lp - nlines)), constant_values=pad_value)
    return x


def _padded_lines(shape, block_lines: int) -> int:
    if block_lines <= 0 or block_lines & (block_lines - 1):
        raise ValueError(
            f"block_lines must be a power of two, got {block_lines}"
        )
    nlines = int(np.prod(shape[:-1]))
    return -(-nlines // block_lines) * block_lines


class PreparedLines(NamedTuple):
    """Tables of one batch of lines in the layout `route` reads (from
    prepare_lines). For "triton" dl/d/du are (n, lines) and `shape` is the
    right-hand side's shape; other routes keep the tables as given."""

    route: str
    dl: jnp.ndarray
    d: jnp.ndarray
    du: jnp.ndarray
    shape: Optional[Tuple[int, ...]] = None


def prepare_lines(dl, d, du, route: str,
                  block_lines: int = _BLOCK_LINES) -> PreparedLines:
    """Tables for `solve_prepared` along `route` (from resolve_route). The
    Triton kernel wants (n, lines); preparing once per Krylov solve keeps
    the three table transposes out of the loop body (XLA does not hoist
    them)."""
    if route not in ROUTES:
        raise ValueError(f"unknown line-solve route {route!r}; expected {ROUTES}")
    if route != "triton":
        return PreparedLines(route, dl, d, du)
    shape = tuple(jnp.broadcast_shapes(dl.shape, d.shape, du.shape))
    lp = _padded_lines(shape, block_lines)
    return PreparedLines(route, _to_rows(dl, shape, lp, 0.0),
                         _to_rows(d, shape, lp, 1.0),
                         _to_rows(du, shape, lp, 0.0), shape)


def solve_prepared(prep: PreparedLines, b, **kernel_opts):
    """solve_lines for tables from prepare_lines, along their route.
    `kernel_opts` (block_lines, depth, interpret) go to the Triton kernel."""
    if prep.route != "triton":
        return _ROUTE_SOLVE[prep.route](prep.dl, prep.d, prep.du, b)
    if prep.shape != tuple(b.shape):
        raise ValueError(
            f"prepared tables {prep.shape} do not match b {tuple(b.shape)}"
        )
    return _thomas_rows(prep.dl, prep.d, prep.du, b, **kernel_opts)


def thomas_triton(dl, d, du, b, *, block_lines: int = _BLOCK_LINES,
                  depth: int = _DEPTH, interpret: bool = False):
    """The Thomas recurrence as one Pallas kernel compiled through Triton.
    `interpret=True` runs it in Pallas' interpreter (tests on the CPU)."""
    lp = _padded_lines(b.shape, block_lines)
    rows = (_to_rows(dl, b.shape, lp, 0.0), _to_rows(d, b.shape, lp, 1.0),
            _to_rows(du, b.shape, lp, 0.0))
    return _thomas_rows(*rows, b, block_lines=block_lines, depth=depth,
                        interpret=interpret)


@functools.partial(jax.jit,
                   static_argnames=("block_lines", "depth", "interpret"))
def _thomas_rows(dl_r, d_r, du_r, b, *, block_lines: int = _BLOCK_LINES,
                 depth: int = _DEPTH, interpret: bool = False):
    """The kernel on tables already in (n, lines) layout; b stays
    (lines..., n)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    n = b.shape[-1]
    lp = dl_r.shape[1]
    if lp % block_lines:
        raise ValueError(f"tables padded to {lp} lines, not a multiple of "
                         f"block_lines={block_lines}")
    nlines = int(np.prod(b.shape[:-1]))
    spec = pl.BlockSpec((n, block_lines), lambda j: (0, j))
    x, _ = pl.pallas_call(
        functools.partial(_thomas_kernel, depth=depth),
        out_shape=(jax.ShapeDtypeStruct((n, lp), b.dtype),
                   jax.ShapeDtypeStruct((n, lp), _compute_dtype(b.dtype))),
        grid=(lp // block_lines,),
        in_specs=[spec] * 4,
        out_specs=(spec, spec),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="thomas_lines",
    )(dl_r, d_r, du_r, _to_rows(b, b.shape, lp, 0.0))
    return x[:, :nlines].T.reshape(b.shape)


_ROUTE_SOLVE = {"triton": thomas_triton, "thomas": thomas_scan,
                "gtsv": gtsv_solve}
