"""Line-solve routes (ops/tridiag.py): the Pallas Triton kernel in Pallas'
interpreter against the scan oracle, the wrapper's padding, broadcasting
and prepared-table layout, and the route choice per backend and size."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from parelagmc_tpu.ops import tridiag


def _lines(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    dl = -rng.uniform(0.0, 1.0, shape)
    du = -rng.uniform(0.0, 1.0, shape)
    d = 2.5 + rng.uniform(0.0, 1.0, shape)
    b = rng.normal(size=shape)
    return [jnp.asarray(x, dtype) for x in (dl, d, du, b)]


def _dense_solve(dl, d, du, b):
    """float64 dense oracle, one line at a time."""
    dl, d, du, b = (np.asarray(x, np.float64) for x in (dl, d, du, b))
    n = b.shape[-1]
    out = np.empty_like(b)
    for idx in np.ndindex(b.shape[:-1]):
        A = np.diag(d[idx]) + np.diag(dl[idx][1:], -1) + np.diag(du[idx][:-1], 1)
        out[idx] = np.linalg.solve(A, b[idx]) if n else b[idx]
    return out


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 2e-6), (jnp.float64, 1e-13)])
@pytest.mark.parametrize("depth", [0, 1, 4])
@pytest.mark.parametrize("shape", [(37, 9), (3, 5, 2), (20, 1)])
def test_triton_kernel_matches_dense(dtype, tol, depth, shape):
    """Line counts that are not a multiple of the block (padding lines),
    look-ahead deeper than the line, float32 and float64."""
    dl, d, du, b = _lines(shape, dtype)
    x = tridiag.thomas_triton(dl, d, du, b, block_lines=16, depth=depth,
                              interpret=True)
    assert x.shape == b.shape and x.dtype == b.dtype
    np.testing.assert_allclose(np.asarray(x), _dense_solve(dl, d, du, b),
                               rtol=tol, atol=tol)


def test_triton_kernel_broadcasts_tables():
    """dl/d/du broadcast against a batched b, as in the coefMG smoother."""
    dl, d, du, _ = _lines((6, 11), jnp.float64)
    b = jnp.asarray(np.random.default_rng(1).normal(size=(4, 6, 11)))
    x = tridiag.thomas_triton(dl, d, du, b, block_lines=8, interpret=True)
    ref = tridiag.thomas_scan(dl, d, du, b)
    np.testing.assert_allclose(np.asarray(x), np.asarray(ref), atol=1e-13)


def test_triton_kernel_bfloat16_computes_in_float32():
    dl, d, du, b = _lines((10, 7), jnp.float32)
    bf = [x.astype(jnp.bfloat16) for x in (dl, d, du, b)]
    x = tridiag.thomas_triton(*bf, block_lines=8, interpret=True)
    assert x.dtype == jnp.bfloat16
    ref = _dense_solve(*bf)
    np.testing.assert_allclose(np.asarray(x, np.float64), ref, rtol=2e-2,
                               atol=2e-2)


def test_prepared_tables_match_solve_lines():
    dl, d, du, b = _lines((2, 13, 6), jnp.float64)
    opts = dict(block_lines=16, interpret=True)
    prep = tridiag.prepare_lines(dl, d, du, "triton", block_lines=16)
    assert prep.route == "triton" and prep.d.shape == (6, 32)
    assert prep.shape == (2, 13, 6)
    x = tridiag.solve_prepared(prep, b, **opts)
    np.testing.assert_allclose(np.asarray(x), _dense_solve(dl, d, du, b),
                               atol=1e-13)
    # Other routes keep the tables as they are.
    plain = tridiag.prepare_lines(dl, d, du, "thomas")
    assert plain.route == "thomas" and plain.dl is dl and plain.shape is None
    np.testing.assert_allclose(np.asarray(tridiag.solve_prepared(plain, b)),
                               np.asarray(x), atol=1e-13)
    with pytest.raises(ValueError, match="do not match"):
        tridiag.solve_prepared(prep, b[:1], **opts)
    with pytest.raises(ValueError, match="unknown line-solve route"):
        tridiag.prepare_lines(dl, d, du, "lapack")


def test_block_lines_must_be_power_of_two():
    dl, d, du, b = _lines((4, 5), jnp.float32)
    with pytest.raises(ValueError, match="power of two"):
        tridiag.thomas_triton(dl, d, du, b, block_lines=24, interpret=True)


@pytest.mark.parametrize("route", ["thomas", "gtsv"])
def test_plain_routes_match_dense(route):
    dl, d, du, b = _lines((3, 4, 9), jnp.float64)
    with tridiag.route_override(route):
        x = tridiag.solve_lines(dl, d, du, b)
    np.testing.assert_allclose(np.asarray(x), _dense_solve(dl, d, du, b),
                               atol=1e-12)


@pytest.mark.parametrize(
    "size,dtype,backend,route",
    [
        (10**7, jnp.float32, "gpu", "triton"),
        (100, jnp.float64, "gpu", "triton"),
        (10**6, jnp.float32, "cpu", "thomas"),
        (1000, jnp.float32, "cpu", "gtsv"),
        (1000, jnp.float64, "cpu", "gtsv"),
        (1000, jnp.bfloat16, "cpu", "thomas"),
    ],
)
def test_route_choice_per_backend_and_size(size, dtype, backend, route):
    assert tridiag.choose_route(size, dtype, backend) == route


def test_route_override_wins_and_resets():
    assert tridiag.resolve_route(10, jnp.float32) == "gtsv"
    with tridiag.route_override("thomas"):
        assert tridiag.resolve_route(10, jnp.float32) == "thomas"
        with tridiag.route_override("gtsv"):
            assert tridiag.resolve_route(10**7, jnp.float32) == "gtsv"
        assert tridiag.resolve_route(10**7, jnp.float32) == "thomas"
    assert tridiag.resolve_route(10**7, jnp.float32) == "thomas"
    assert tridiag.resolve_route(10, jnp.float32) == "gtsv"
    with pytest.raises(ValueError, match="unknown line-solve route"):
        with tridiag.route_override("lapack"):
            pass


def test_mass_solver_route_follows_cell_count():
    """The mass solver resolves its route from the per-sample cell count:
    any batch of one level takes the route its cell count picks."""
    from parelagmc_tpu.fem import build_mixed_level
    from parelagmc_tpu.mesh import make_box_mesh
    from parelagmc_tpu.ops.mass_solve import build_mass_tridiag_solver

    lvl = build_mixed_level(make_box_mesh((4, 3, 2), lengths=(1.0, 1.0, 1.0)))
    ess = lvl.ess_faces(np.ones(6, dtype=int))
    small = build_mass_tridiag_solver(lvl, ess, dtype=jnp.float64)
    assert tridiag.choose_route(24, jnp.float64) == "gtsv"
    w = jnp.ones((4096, lvl.n_s), jnp.float64)  # 98,304 unknowns per call
    assert {f.route for f in small.factor(w)} == {"gtsv"}


def test_mass_solver_triton_route_in_interpreter(monkeypatch):
    """The solver's factor/apply path with the kernel: tables prepared once,
    each apply transposes only the right-hand side."""
    from parelagmc_tpu.fem import build_mixed_level
    from parelagmc_tpu.mesh import make_box_mesh
    from parelagmc_tpu.ops.mass_solve import build_mass_tridiag_solver

    monkeypatch.setattr(
        tridiag, "_thomas_rows",
        functools.partial(tridiag._thomas_rows, interpret=True, block_lines=8),
    )
    lvl = build_mixed_level(make_box_mesh((3, 4, 2), lengths=(1.0, 2.0, 1.0)))
    ess = lvl.ess_faces(np.array([0, 1, 1, 1, 1, 0]))
    solver = build_mass_tridiag_solver(lvl, ess, dtype=jnp.float64)
    rng = np.random.default_rng(3)
    w = jnp.asarray(np.exp(rng.normal(size=(2, lvl.n_s))))
    rhs = jnp.asarray(rng.normal(size=(2, lvl.n_u)))
    with tridiag.route_override("triton"):
        fac = solver.factor(w)
    assert all(f.route == "triton" and f.shape is not None for f in fac)
    np.testing.assert_allclose(
        np.asarray(solver.apply_factored(fac, rhs)), np.asarray(solver(w, rhs)),
        atol=1e-12,
    )


def test_prepared_block_must_divide_padding():
    dl, d, du, b = _lines((20, 5), jnp.float64)
    prep = tridiag.prepare_lines(dl, d, du, "triton", block_lines=8)
    with pytest.raises(ValueError, match="not a multiple"):
        tridiag.solve_prepared(prep, b, block_lines=16, interpret=True)
