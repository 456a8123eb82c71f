import numpy as np
import pytest

import jax
import jax.numpy as jnp

from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.fem import build_geometric_hierarchy, build_mixed_level
from parelagmc_tpu.mesh import make_box_mesh
from parelagmc_tpu.ops.prng import sample_normals, sample_uniforms
from parelagmc_tpu.samplers import SPDESampler
from parelagmc_tpu.utils.io_vtk import cell_to_vertex_average, save_vtk_vertex_field

DT = jnp.float64


def test_sample_normals_moments():
    x = np.asarray(sample_normals(jax.random.PRNGKey(0), (1000, 50), DT))
    assert abs(x.mean()) < 0.05 and abs(x.std() - 1.0) < 0.05


def test_sample_uniforms_moments():
    x = np.asarray(sample_uniforms(jax.random.PRNGKey(1), (2000,), DT))
    assert 0.0 <= x.min() and x.max() < 1.0
    assert abs(x.mean() - 0.5) < 0.05


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_noise_is_jax_random_bit_for_bit(dtype):
    key = jax.random.PRNGKey(5)
    np.testing.assert_array_equal(
        np.asarray(sample_normals(key, (7, 33), dtype)),
        np.asarray(jax.random.normal(key, (7, 33), dtype=dtype)),
    )
    np.testing.assert_array_equal(
        np.asarray(sample_uniforms(key, (40,), dtype)),
        np.asarray(jax.random.uniform(key, (40,), dtype=dtype)),
    )


def test_eval_with_flux_satisfies_first_block_row():
    # u = -M^{-1} B^T s  =>  M u + B^T s = 0 on non-essential dofs.
    base = make_box_mesh((4, 4), lengths=(1.0, 1.0))
    hier = build_geometric_hierarchy(base, 1)
    cfg = ProblemConfig(refinements=0, lognormal=False, correlation_length=0.3)
    sampler = SPDESampler(hier, cfg, DT)
    xi = sampler.sample(0, jax.random.PRNGKey(2), 2)
    s, u = sampler.eval_with_flux(0, xi)
    lvl = hier.levels[0]
    ess = lvl.ess_faces(np.ones(4, dtype=int))
    M = lvl.mass_csr().toarray()
    B = lvl.b_csr().toarray()
    for b in range(2):
        resid = M @ np.asarray(u[b]) + B.T @ np.asarray(s[b])
        np.testing.assert_allclose(resid[~ess], 0.0, atol=1e-10)
        np.testing.assert_allclose(np.asarray(u[b])[ess], 0.0, atol=1e-12)


def test_cell_to_vertex_average_constant():
    mesh = make_box_mesh((3, 4, 2), lengths=(1.0, 2.0, 1.0))
    v = cell_to_vertex_average(mesh, np.full(mesh.num_cells, 3.5))
    np.testing.assert_allclose(v, 3.5)
    assert v.size == 4 * 5 * 3


def test_save_vtk_vertex_field(tmp_path):
    mesh = make_box_mesh((2, 2), lengths=(1.0, 1.0))
    v = cell_to_vertex_average(mesh, np.arange(4.0))
    path = str(tmp_path / "v.vtk")
    save_vtk_vertex_field(mesh, v, path)
    txt = open(path).read()
    assert "POINT_DATA 9" in txt


def test_reporting_helpers():
    from parelagmc_tpu.utils.reporting import (
        chi_center_of_mass,
        dofs_info_table,
        find_closest_cell,
        random_field_errors_table,
    )
    mesh = make_box_mesh((4, 4), lengths=(2.0, 2.0))
    e = find_closest_cell(mesh, (1.0, 1.0))
    c = mesh.cell_centers()[e]
    assert np.abs(c - 1.0).max() <= 0.25
    chi = chi_center_of_mass(mesh)
    assert chi.sum() == 1.0
    t = dofs_info_table([100, 25], nnz=[500, 120], iters=[3.5, 2.0])
    assert "level" in t and "500" in t
    t2 = random_field_errors_table([0.1, 0.2], [0.3, 0.4])
    assert "E[s]" in t2


def test_glvis_plot_no_server():
    from parelagmc_tpu.utils.reporting import glvis_plot

    mesh = make_box_mesh((2, 2), lengths=(1.0, 1.0))
    # No GLVis server in this environment: must return False, not raise.
    assert glvis_plot(mesh, np.zeros(4), port=59999) is False


def test_exp_weighted_regression_reference_pairwise():
    # Exact-rate data: y = 7 * x^(-1.5) -> the pairwise-ratio fit recovers
    # a = 1.5 in the positive-rate convention regardless of weights.
    from parelagmc_tpu.utils.regression import exp_weighted_regression

    x = np.array([4096.0, 512.0, 64.0, 8.0])
    y = 7.0 * x ** (-1.5)
    np.testing.assert_allclose(exp_weighted_regression(y, x, 0), 1.5, rtol=1e-12)
    np.testing.assert_allclose(exp_weighted_regression(y, x, 1), 1.5, rtol=1e-12)
    # Mixed-rate data: hand-evaluate the reference's weighted no-intercept fit
    # (Utilities.cpp:257-283: slope = sum(w_i ldy_i ldx_i)/sum(w_i ldx_i^2),
    # w_i = 0.5^i over pairs (i, i+1), first n = len-1-skip pairs), negated.
    y2 = np.array([0.01, 0.09, 0.4, 1.4])
    n = 3
    ldy = np.log(np.abs(y2[:n] / y2[1 : n + 1]))
    ldx = np.log(x[:n] / x[1 : n + 1])
    w = 0.5 ** np.arange(n)
    hand = -(w * ldy * ldx).sum() / (w * ldx * ldx).sum()
    np.testing.assert_allclose(exp_weighted_regression(y2, x, 0), hand, rtol=1e-12)


def test_bias_extrapolation_hand_value():
    # Pin the rate-extrapolated squared bias against a hand-computed value
    # (positive-rate convention; ADVICE.md round 1 found the old exponents
    # inflated the bias by m^(2 alpha)). For L=3 with perfectly geometric
    # E[|Y_l|] = c * M_l^a: bias2 = eABSY[0]^2 / (m^a - 1)^2, the tail sum
    # (|Y_{-1}| + |Y_{-2}| + ...)^2 of the extrapolated finer-level errors.
    from parelagmc_tpu.uq.managers import MLMCManager, NVAR

    class _FakeSolver:
        def num_dofs(self, l):
            return [4096.0, 512.0, 64.0][l]

        def nnz(self, l):
            return 0

    from parelagmc_tpu.config import ProblemConfig

    cfg = ProblemConfig(refinements=2, mse=1.0, output_filename="")
    mgr = MLMCManager(_FakeSolver(), sampler=None, config=cfg, nlevels=3)
    alpha = 2.0 / 3.0  # |Y| ~ M^(-2/3): factor 4 per level at m = 8
    n = 100
    absY = np.array([0.05, 0.05 * 8.0 ** alpha, 0.05 * 64.0 ** alpha])
    mgr.sums[:] = 0.0
    mgr.level_nsamples[:] = n
    mgr.sums[:, 0] = absY * n  # Y
    mgr.sums[:, 4] = absY * n  # ABSY
    mgr.sums[:, 1] = (absY ** 2) * n * 1.01  # Y2 (tiny variance)
    mgr.sums[:, 5] = 2.5 * n  # Q
    mgr.sums[:, 6] = 2.5 ** 2 * n * 1.01  # Q2
    mgr.sums[:, 8] = 100.0 * n  # C
    mgr.compute_nsamples_mse()
    m = 4096.0 / 512.0
    np.testing.assert_allclose(mgr.alphaABS, alpha, rtol=1e-10)
    hand = absY[0] ** 2 / (m ** alpha - 1.0) ** 2
    np.testing.assert_allclose(
        mgr.expected_discretization_error2, hand, rtol=1e-10
    )
    # Sanity: the extrapolated bias must be (much) smaller than the coarsest
    # increment for a convergent hierarchy - the round-1 bug made it larger.
    assert mgr.expected_discretization_error2 < absY[0] ** 2
