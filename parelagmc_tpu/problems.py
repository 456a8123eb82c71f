"""Problem assembly: config -> (hierarchy, sampler, solver, ...).

The analog of the reference's example-driver setup blocks
(examples/MLMC.cpp:85-268): select mesh, build the multilevel hierarchy,
wire sampler + forward solver (+ Bayesian problem). Used by the bundled
example drivers, the benchmark and the graft entry points.

Mesh notes:
* "box": cfg.ncells is the *coarsest* mesh; cfg.refinements uniform
  refinements define the finer levels (matching the reference's
  serial+parallel refinement semantics with geometric coarsening).
* "spe10": the fine mesh is the full 60x220x85-cell SPE10 grid; the odd
  z-count coarsens non-dyadically (trailing layer merges into the last
  coarse cell) - the structured stand-in for the reference's METIS
  agglomeration (src/Utilities.cpp:125-155).
* "egg": the Egg-model grid (60x60x7); the embedded variants add buffer
  layers via cfg.embedding.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from parelagmc_tpu.config import ProblemConfig
from parelagmc_tpu.fem import GeometricHierarchy
from parelagmc_tpu.mesh.factories import (
    EGG_NCELLS,
    EGG_SPACING,
    SPE10_NCELLS,
    SPE10_SPACING,
    make_box_mesh,
    make_embedded_box_mesh,
)
from parelagmc_tpu.physics.darcy import DarcySolver
from parelagmc_tpu.samplers.covariance import (
    AnalyticExponentialCovariance,
    MaternCovariance,
)
from parelagmc_tpu.samplers.kl import KLSampler
from parelagmc_tpu.samplers.pde import (
    EmbeddedSPDESampler,
    L2ProjectionSPDESampler,
    SPDESampler,
)


class Problem(NamedTuple):
    config: ProblemConfig
    hierarchy: GeometricHierarchy
    embed_hierarchy: Optional[GeometricHierarchy]
    sampler: object
    solver: DarcySolver
    dtype: object


def _dtype_of(cfg: ProblemConfig):
    return {"float32": jnp.float32, "float64": jnp.float64, "bfloat16": jnp.bfloat16}[
        cfg.dtype
    ]


def fine_mesh_spec(cfg: ProblemConfig):
    """(fine_ncells, fine_spacings) for the configured mesh."""
    if cfg.mesh == "box":
        f = 2 ** cfg.refinements
        return (
            tuple(n * f for n in cfg.ncells),
            [L / (n * f) for L, n in zip(cfg.lengths, cfg.ncells)],
        )
    if cfg.mesh == "spe10":
        return tuple(SPE10_NCELLS), list(SPE10_SPACING)
    if cfg.mesh == "egg":
        return tuple(EGG_NCELLS), list(EGG_SPACING)
    raise ValueError(f"unknown mesh '{cfg.mesh}'")


def resolve_axis_order(axis_order, fine_ncells) -> tuple:
    """Normalize cfg.axis_order to an explicit permutation tuple.

    "auto" moves the largest cell count to the x (minor/fastest) axis and
    keeps the remaining axes in their original relative order. The rule
    was tuned for an accelerator whose minor axis pads to 128 lanes; on
    the GPU it is kept until re-measured (ROADMAP queue 1 item 8)."""
    d = len(fine_ncells)
    if axis_order is None or axis_order == "none":
        return tuple(range(d))
    if axis_order == "auto":
        i = int(np.argmax(fine_ncells))
        return (i,) + tuple(a for a in range(d) if a != i)
    order = tuple(int(a) for a in axis_order)
    if sorted(order) != list(range(d)):
        raise ValueError(f"axis_order {order} is not a permutation of 0..{d - 1}")
    return order


def permute_cell_field(field, ncells, order):
    """Re-flatten an x-fastest cell field (n,) or per-axis (n, d) given on
    the ORIGINAL `ncells` grid to the permuted grid's x-fastest layout."""
    if field is None:
        return None
    field = np.asarray(field)
    d = len(ncells)
    order = tuple(order)
    if order == tuple(range(d)):
        return field
    grid_shape = tuple(int(n) for n in ncells[::-1])  # (z, y, x)
    # Output array position j holds new mesh axis d-1-j = orig mesh axis
    # order[d-1-j], which lives at input array position d-1-order[d-1-j].
    perm = tuple(d - 1 - order[d - 1 - j] for j in range(d))
    if field.ndim == 2:  # per-axis columns (n, d)
        g = field.reshape(grid_shape + (d,)).transpose(perm + (d,))
        return np.ascontiguousarray(g[..., list(order)]).reshape(-1, d)
    g = field.reshape(grid_shape).transpose(perm)
    return np.ascontiguousarray(g).reshape(-1)


def _permute_side_attrs(attrs, order):
    """Remap an MFEM-convention per-side attribute tuple: the data on the
    physical side (orig axis order[i], side s) is addressed, after the
    relabel, by attribute index attr(new axis i, side s)."""
    from parelagmc_tpu.mesh.structured import _mfem_bdr_attr

    d = len(order)
    if len(attrs) != 2 * d:
        return attrs  # non-box attribute list: caller keeps responsibility
    new = list(attrs)
    for i in range(d):
        for s in (0, 1):
            new[_mfem_bdr_attr(d, i, s) - 1] = attrs[
                _mfem_bdr_attr(d, order[i], s) - 1
            ]
    return tuple(new)


def _permute_config_axes(cfg: ProblemConfig, order) -> ProblemConfig:
    """Config with every axis-coupled field relabeled by `order` (and
    axis_order cleared so the permutation is applied exactly once)."""
    import dataclasses

    d = len(order)
    pick = lambda t: tuple(t[a] for a in order) if len(t) == d else tuple(t)
    # bayes_obs_coords is m points x d coords flattened; permute the coord
    # columns of every point (new axis i holds the original axis order[i]).
    obs = tuple(cfg.bayes_obs_coords)
    if obs and len(obs) % d == 0:
        pts = [obs[i : i + d] for i in range(0, len(obs), d)]
        obs = tuple(p[a] for p in pts for a in order)
    # coefmg_line_axes letters name PHYSICAL axes; relabel them to the
    # permuted mesh frame (physical axis p lives at new index
    # order.index(p)). "auto"/"" pass through.
    solver = cfg.darcy_solver
    la = (getattr(solver, "coefmg_line_axes", "") or "").strip().lower()
    if la and la != "auto":
        letters = "xyz"[:d]
        bad = sorted(set(c for c in la if c not in letters))
        if bad:
            raise ValueError(
                f"coefmg_line_axes={la!r}: unknown axis letter(s) {bad}; "
                f"expected a subset of {letters!r} or 'auto'"
            )
        solver = dataclasses.replace(
            solver,
            coefmg_line_axes="".join(
                letters[order.index(letters.index(c))] for c in la
            ),
        )
    return dataclasses.replace(
        cfg,
        axis_order=None,
        darcy_solver=solver,
        ncells=pick(cfg.ncells),
        lengths=pick(cfg.lengths),
        n_buffer=pick(cfg.n_buffer),
        qoi_point=pick(cfg.qoi_point),
        bayes_obs_coords=obs,
        ess_attr=_permute_side_attrs(cfg.ess_attr, order),
        obs_attr=_permute_side_attrs(cfg.obs_attr, order),
        inflow_attr=_permute_side_attrs(cfg.inflow_attr, order),
    )


def build_problem(cfg: ProblemConfig, kinv_ref: Optional[np.ndarray] = None) -> Problem:
    from parelagmc_tpu.fem.hierarchy import build_geometric_hierarchy_from_fine

    dtype = _dtype_of(cfg)
    if cfg.mesh.endswith(".mesh"):
        if cfg.axis_order is not None:
            import warnings

            warnings.warn(
                "axis_order applies only to the tensor-grid factories "
                "(box/spe10/egg); it is ignored for mesh files",
                stacklevel=2,
            )
        return _build_from_mesh_file(cfg, dtype)
    fine_ncells, fine_spacings = fine_mesh_spec(cfg)
    order = resolve_axis_order(cfg.axis_order, fine_ncells)
    if order != tuple(range(len(fine_ncells))):
        kinv_ref = permute_cell_field(kinv_ref, fine_ncells, order)
        cfg = _permute_config_axes(cfg, order)
        fine_ncells = tuple(fine_ncells[a] for a in order)
        fine_spacings = [fine_spacings[a] for a in order]
    if cfg.embedding == "matching" and any(
        n % 2 ** cfg.refinements for n in fine_ncells
    ):
        # Matching embedding needs the 0/1 cell selection to hold on EVERY
        # level: with a non-dyadic axis both hierarchies merge their
        # trailing layer, but the original mesh merges at its own end while
        # the embedded mesh merges inside the buffer - the interiors stop
        # aligning. Projection embedding has no such constraint: the mortar
        # coupling G is the exact cell-overlap operator recomputed on each
        # level pair (mortar_coupling below), so non-dyadic grids like the
        # Egg model's z=7 are fine (round-5; reference egg factories
        # src/MeshUtilities.cpp:157+).
        raise ValueError(
            "matching embedding requires per-axis cell counts divisible by "
            f"2^{cfg.refinements} so the embedded hierarchies stay aligned "
            "(use embedding='projection' for non-dyadic grids)"
        )
    fine = make_box_mesh(fine_ncells, spacings=fine_spacings)
    hier = build_geometric_hierarchy_from_fine(fine, cfg.nlevels)

    embed_hier = None
    if cfg.embedding != "none":
        nb = list(cfg.n_buffer)
        if len(nb) == 1:
            nb = nb * len(fine_ncells)
        f = 2 ** cfg.refinements
        # Buffer given in coarsest-level cells (reference convention: the
        # enlarged base mesh adds whole coarse layers).
        embed_fine = make_embedded_box_mesh(
            fine_ncells,
            spacings=fine_spacings,
            n_buffer=[b * f for b in nb],
        )
        embed_hier = build_geometric_hierarchy_from_fine(embed_fine, cfg.nlevels)

    fine_mesh = hier.levels[0].mesh
    if cfg.sampler_name == "pde":
        if cfg.embedding == "matching":
            sampler = EmbeddedSPDESampler(hier, embed_hier, cfg, dtype)
        elif cfg.embedding == "projection":
            sampler = L2ProjectionSPDESampler(hier, embed_hier, cfg, dtype)
        else:
            sampler = SPDESampler(hier, cfg, dtype)
    elif cfg.sampler_name == "analytic":
        d = fine_mesh.dim
        nmodes = max(2, round(cfg.number_of_modes ** (1.0 / d)))
        cov = AnalyticExponentialCovariance(
            fine_mesh, cfg.correlation_length, [nmodes] * d
        )
        sampler = KLSampler(hier, cov, cfg, dtype)
    elif cfg.sampler_name == "matern":
        cov = MaternCovariance(fine_mesh, cfg.correlation_length, cfg.number_of_modes)
        sampler = KLSampler(hier, cov, cfg, dtype)
    else:
        raise ValueError(f"unknown sampler '{cfg.sampler_name}'")

    _check_marginal_norm_support(cfg, sampler)
    solver = DarcySolver(hier, cfg, dtype, kinv_ref=kinv_ref)
    return Problem(cfg, hier, embed_hier, sampler, solver, dtype)


def _check_marginal_norm_support(cfg: ProblemConfig, sampler) -> None:
    """normalize_marginals is implemented by the tensor SPDE samplers
    (samplers/pde.py: closed spectral form of the covariance diagonal);
    every other sampler ignores it. Warn instead of silently dropping the
    flag - its whole point is fixing the per-level marginal mismatch that
    destroys MLMC variance decay (review r3)."""
    from parelagmc_tpu.samplers.pde import _TensorSPDEBase

    if cfg.normalize_marginals and not isinstance(sampler, _TensorSPDEBase):
        import warnings

        warnings.warn(
            "normalize_marginals=True has no effect on "
            f"{type(sampler).__name__} (only the tensor-grid SPDE "
            "samplers implement exact marginal normalization); the field "
            "keeps its raw per-level marginal variances"
        )


def _build_from_mesh_file(cfg: ProblemConfig, dtype) -> Problem:
    """Build from an MFEM mesh file (cfg.mesh = path): the file provides the
    COARSEST mesh, refined cfg.refinements times (the reference's driver
    semantics, examples/MLMC.cpp:162-198). Structured-detectable meshes use
    the tensor fast paths; simplicial meshes use the unstructured stack
    (SPDE sampler only; embedding is a tensor-grid feature for now)."""
    from parelagmc_tpu.mesh.mfem_io import read_mfem_mesh
    from parelagmc_tpu.mesh.structured import StructuredMesh

    mesh = read_mfem_mesh(cfg.mesh)
    if isinstance(mesh, StructuredMesh):
        from parelagmc_tpu.fem import build_geometric_hierarchy

        hier = build_geometric_hierarchy(mesh, cfg.nlevels)
        if cfg.sampler_name != "pde" or cfg.embedding != "none":
            raise ValueError(
                "mesh-file configs currently support the plain SPDE sampler"
            )
        sampler = SPDESampler(hier, cfg, dtype)
        solver = DarcySolver(hier, cfg, dtype)
        return Problem(cfg, hier, None, sampler, solver, dtype)

    from parelagmc_tpu.fem.simplicial_hierarchy import build_simplicial_hierarchy
    from parelagmc_tpu.unstructured import (
        UnstructuredDarcySolver,
        UnstructuredEmbeddedSPDESampler,
        UnstructuredProjectionSPDESampler,
        UnstructuredSPDESampler,
        build_embedded_simplicial_hierarchies,
        label_box_boundaries_gm,
    )

    if np.unique(mesh.boundary_attributes).size <= 1:
        # Single-attribute meshes (cube_tet.mesh): relabel box sides so the
        # MFEM attribute convention applies to BCs/QoIs.
        label_box_boundaries_gm(mesh)
    embed_hier = None
    selection = None
    if cfg.embedding != "none" and cfg.sampler_name != "pde":
        raise ValueError("embedding requires the SPDE sampler")
    if cfg.embedding != "none":
        import os

        embed_path = cfg.embed_mesh
        if not embed_path:
            stem = cfg.mesh[: -len(".mesh")]
            suffix = "_embed.mesh" if cfg.embedding == "matching" else "_enlarge.mesh"
            embed_path = stem + suffix
        if not os.path.exists(embed_path):
            raise ValueError(
                f"embedding='{cfg.embedding}' needs an enlarged mesh at "
                f"'{embed_path}' (or set embed_mesh)"
            )
        embed_gm = read_mfem_mesh(embed_path)
        if cfg.embedding == "matching":
            hier, embed_hier, selection = build_embedded_simplicial_hierarchies(
                mesh,
                embed_gm,
                cfg.nlevels,
                unstructured_coarsening=cfg.unstructured_coarsening,
                coarsening_factor=cfg.coarsening_factor,
            )
        else:
            if cfg.unstructured_coarsening:
                raise ValueError(
                    "projection embedding with agglomeration is not wired yet; "
                    "use matching embedding or refinement hierarchies"
                )
            hier = build_simplicial_hierarchy(mesh, cfg.nlevels)
            embed_hier = build_simplicial_hierarchy(embed_gm, cfg.nlevels)
    elif cfg.unstructured_coarsening:
        # Reference semantics ("Unstructured coarsening" = METIS,
        # examples/MLMC.cpp:96-97): the file is the FINEST mesh and coarse
        # levels come from algebraic agglomeration.
        from parelagmc_tpu.fem.agglomeration import build_agglomerated_hierarchy

        hier = build_agglomerated_hierarchy(
            mesh, cfg.nlevels, coarsening_factor=cfg.coarsening_factor
        )
    else:
        hier = build_simplicial_hierarchy(mesh, cfg.nlevels)
    if cfg.sampler_name == "pde":
        if cfg.embedding == "matching":
            sampler = UnstructuredEmbeddedSPDESampler(
                hier, embed_hier, selection, cfg, dtype
            )
        elif cfg.embedding == "projection":
            sampler = UnstructuredProjectionSPDESampler(hier, embed_hier, cfg, dtype)
        else:
            sampler = UnstructuredSPDESampler(hier, cfg, dtype)
    elif cfg.sampler_name == "matern":
        # Matern KLE is mesh-agnostic (dense kernel at cell centers).
        cov = MaternCovariance(
            hier.levels[0].mesh, cfg.correlation_length, cfg.number_of_modes
        )
        sampler = KLSampler(hier, cov, cfg, dtype)
    elif cfg.sampler_name == "analytic":
        d = mesh.dim
        nmodes = max(2, round(cfg.number_of_modes ** (1.0 / d)))
        cov = AnalyticExponentialCovariance(
            hier.levels[0].mesh, cfg.correlation_length, [nmodes] * d
        )
        sampler = KLSampler(hier, cov, cfg, dtype)
    else:
        raise ValueError(f"unknown sampler '{cfg.sampler_name}'")
    _check_marginal_norm_support(cfg, sampler)
    solver = UnstructuredDarcySolver(hier, cfg, dtype)
    return Problem(cfg, hier, embed_hier, sampler, solver, dtype)
