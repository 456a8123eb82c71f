"""Typed configuration tree.

The reference's single config mechanism is parelag::ParameterList parsed
from XML (reference: examples/MLMC.cpp:61-81, master list
examples/example_parameterlists/example_parameters.xml). We provide:

* `ProblemConfig` - a typed dataclass mirroring the "Problem parameters"
  sublist plus solver selections, with the same defaults as the reference's
  in-code test parameters (examples/example_helpers/CreateMLMCParameterList.hpp).
* `ParameterList` - a light hierarchical dict with `sublist`/`get` semantics.
* `read_xml_parameterlist` - reads the reference's SimpleXML format so
  existing XML files keep working.
* `ProblemConfig.from_parameterlist` - maps the reference key names onto the
  typed config.

Solver configs replace the reference's runtime "Preconditioner Library"
(example_parameters.xml:168-913) with a small catalog of jitted batched
solvers selected by name: "cg-mg" (PCG + geometric multigrid V-cycle),
"cg-jacobi", and "minres-bj" (block-diagonal preconditioned MINRES for the
Darcy saddle system).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple


class ParameterList(dict):
    """Hierarchical key-value list with reference-compatible accessors."""

    def sublist(self, name: str, create: bool = True) -> "ParameterList":
        if name not in self:
            if not create:
                raise KeyError(name)
            self[name] = ParameterList()
        return self[name]

    def get(self, name: str, default: Any = None) -> Any:  # type: ignore[override]
        return dict.get(self, name, default)


def _parse_value(type_str: str, value: str) -> Any:
    t = type_str.strip().lower()
    v = value.strip()
    if t in ("int", "integer"):
        return int(v)
    if t in ("double", "float"):
        return float(v)
    if t in ("bool", "boolean"):
        return v.lower() in ("true", "1", "yes")
    if t.startswith("vector"):
        inner = t.split("(")[-1].rstrip(")")
        parts = v.split()
        if "int" in inner:
            return [int(p) for p in parts]
        if "double" in inner or "float" in inner:
            return [float(p) for p in parts]
        return parts
    return v


def read_xml_parameterlist(path_or_str: str) -> ParameterList:
    """Read the reference's SimpleXML ParameterList format:
    <ParameterList name="..."> <Parameter name=".." type=".." value=".."/> ...
    """
    try:
        tree = ET.parse(path_or_str)
        root = tree.getroot()
    except (OSError, ET.ParseError):
        root = ET.fromstring(path_or_str)

    def walk(node: ET.Element) -> ParameterList:
        out = ParameterList()
        for child in node:
            tag = child.tag.lower()
            if tag == "parameterlist":
                out[child.attrib.get("name", "")] = walk(child)
            elif tag == "parameter":
                out[child.attrib["name"]] = _parse_value(
                    child.attrib.get("type", "string"), child.attrib.get("value", "")
                )
        return out

    if root.tag.lower() == "parameterlist":
        return walk(root)
    # Wrapper element containing a single ParameterList.
    for child in root:
        if child.tag.lower() == "parameterlist":
            return walk(child)
    return walk(root)


@dataclass
class SolverConfig:
    """Batched iterative solver selection (replaces the reference's
    Preconditioner Library entries, see module docstring)."""

    name: str = "cg-mg"  # "cg-mg" | "cg-jacobi" | "minres-bj" | "cg-schur"
    max_iterations: int = 300
    relative_tolerance: float = 1e-6
    absolute_tolerance: float = 1e-12
    restart_every: int = 50  # true-residual CG restart cadence (f32 rescue)
    # cg-schur: scale the exact S(1)^{-1} locally by sqrt(w) per cell
    # instead of the global geometric mean (stronger on rough fields).
    local_schur_scaling: bool = False
    mg_coarse_sweeps: int = 8  # 0: dense coarsest inverse; >0: Jacobi sweeps
    # (Jacobi sweeps match the dense quality within a few iterations)
    # Tridiagonal line relaxation along every strongly-coupled axis in the
    # structured Schur MG (auto-detected per level: axes with >= 3x the
    # weakest axis's mean coupling; alternating-direction when several
    # engage). Decisive when ONE axis dominates (oracle: 45 -> 7 CG
    # iterations on 10x z-refined grids). Measured on SPE10 itself the
    # y/z couplings are BALANCED (the anisotropic kz cancels the 2 ft
    # z-spacing), and the two-direction sweep converges 1.6x faster per
    # iteration but costs 1.8x more (sequential Thomas-scan latency) - a
    # net loss there, so it stays opt-in.
    mg_line_smoother: bool = False
    # Multigrid options.
    smoother_iterations: int = 2
    chebyshev_order: int = 3
    coarse_dense_cutoff: int = 5000  # dense-factorize coarsest <= this size
    # Per-sample coefficient MG (cg-schur-coefmg) smoother: 0 keeps the
    # damped-Jacobi V(2,2) cycle; k > 0 switches to order-k Chebyshev
    # accelerated Jacobi sweeps (same operator applications per sweep,
    # stronger upper-spectrum damping - see ops/coef_multigrid.py).
    coefmg_cheby_order: int = 0
    coefmg_cheby_lo: float = 0.25
    # Jacobi pre/post sweeps per V-cycle level when coefmg_cheby_order == 0
    # (ignored by the Chebyshev smoother, which derives its sweep count
    # from the order). V(2,2) is the measured SPE10 sweet spot.
    coefmg_sweeps: int = 2
    # Jacobi damping for the coefMG smoother and coarsest sweeps.
    coefmg_omega: float = 0.8
    # Per-sample LINE relaxation for the structured coefMG: batched Thomas
    # solves along these mesh axes replace the point smoother ("z", "zy",
    # ...; letters name the PHYSICAL axes of the original, unpermuted
    # problem - build_problem relabels them together with axis_order).
    # "auto" picks every axis whose kinv_ref-weighted mean face
    # conductance is >= 3x the weakest axis's (the static MG's
    # mg_line_smoother detection rule). Exists for thin high-contrast
    # barriers that P0 coarse grids cannot represent and point smoothers
    # cannot relax (see ops/coef_multigrid_structured.StructCoefMG).
    coefmg_line_axes: str = ""
    # Damping for the line sweeps (T_a has the full diagonal, so 1.0 is
    # S-convergent; the knob exists for tuning studies).
    coefmg_line_omega: float = 1.0
    # Coarse-face construction for the structured coefMG: "galerkin" (P0
    # RAP face-sum - exact but short-circuits thin barriers that land on
    # dropped planes) or "harmonic" (series-composed faces - every level
    # sees every barrier; pair with coefmg_line_axes).
    coefmg_coarsen: str = "galerkin"
    # "auto": tensor-product meshes use the slicing-only structured MG
    # (ops/coef_multigrid_structured.py); "gather": force the generic
    # gather-table implementation (oracle / unstructured semantics).
    coefmg_impl: str = "auto"
    # Number of V-cycles composed per preconditioner application
    # (z = 2Vr - VSVr for 2): each CG iteration costs one EXACT Schur
    # apply (batched tridiagonal M(w)^{-1}, the expensive part at SPE10
    # scale) regardless, so spending more cheap gather-stencil MG work per
    # iteration to cut the iteration count is a net win at scale.
    coefmg_cycles: int = 1
    # Goal-oriented (adjoint-corrected) QoI for the cg-schur family: also
    # solve the adjoint Schur system S(w) lam = q_s (q_s = c_p - B M(w)^{-1}
    # c_u, the QoI functional reduced to pressure space) and report
    # Q + lam^T r with r the primal solve's true residual. The remaining
    # QoI error is the PRODUCT of the primal and adjoint energy errors -
    # but that bound only bites when the preconditioner's energy error
    # tracks the residual. Measured on the (30,110,42) half-scale
    # synthetic SPE10 (f64, rtol 1e-4): with the barrier-aware coefMG
    # (coefmg_cheby_order=3 + coefmg_line_axes + coefmg_coarsen=harmonic)
    # the QoI error drops 2.5e-1 -> 7.0e-6 for ~2.4x the iterations;
    # WITHOUT it the barrier modes keep both energy errors O(1) until the
    # very end and the correction buys only ~1.4x. On the mild golden
    # config the correction at the bench's fixed 50-iteration budget cut
    # rmse 0.065 -> 0.028 at 2.1x cost (a wash - bench keeps it off).
    # Costs one extra Schur CG solve of the same system (same
    # preconditioner state, shared setup).
    adjoint_qoi: bool = False
    # Solve the primal and adjoint Schur systems as ONE stacked batched
    # PCG (rhs axis -2, vmapped operator/preconditioner closures) instead
    # of two sequential solves. The per-sample preconditioner state
    # (tridiagonal mass factors, coefMG dinv/idiag hierarchies) is then
    # streamed from device memory once per iteration for BOTH systems - on the
    # bandwidth-bound SPE10-scale levels the second right-hand side rides
    # nearly free, and the loop runs max(it_p, it_a) trips instead of
    # it_p + it_a. Off by default pending the at-scale fusion canaries
    # (CLAUDE.md: never trust a new fused composition at scale without a
    # converged_fraction / known-E[Q] check). Ignored unless adjoint_qoi;
    # batched cg-schur family only (spatially sharded solves keep the
    # sequential adjoint inside their shard_map).
    adjoint_stacked: bool = False
    # Warm-start every COLD solve (solve_fwd with no iterate, i.e. the
    # solo coarsest-level samples that dominate total MLMC walltime at the
    # optimal N_l allocation, and the coarse member of each pair) from the
    # mean-field solution: ONE reference solve per level with w == 1 (the
    # lognormal multiplier's geometric mean under normalized marginals),
    # cached at first use and broadcast as the initial PCG iterate. With
    # adjoint_qoi the mean-field adjoint warm-starts lam the same way.
    # Unbiased: x0 is a deterministic constant, the solve still runs to
    # the same per-row true-residual criterion. Measured (CPU f64,
    # (16,56,24) synthetic SPE10, cheb3 MG, rtol 1e-6): level-1 cold 38 ->
    # 24 iterations, level-2 17 -> 13. Batched cg-schur family only.
    meanfield_x0: bool = False
    # Preconditioner-state dtype for cg-schur-coefmg: "" keeps the solve
    # dtype; "bfloat16" casts the per-sample V-cycle tables AND its
    # residual math to bf16 (CG itself stays in the solve dtype). The
    # V-cycle is bound by memory bandwidth, so halving its bytes buys
    # throughput at the cost of a slightly weaker preconditioner -
    # measure iterations before adopting (a preconditioner only needs
    # ~1e-2 relative quality; bf16's 8 exponent bits cover any
    # permeability contrast).
    coefmg_prec_dtype: str = ""
    # Spatial domain decomposition of the FINEST level's Darcy solve
    # (parallel/spatial_darcy.py): > 1 shards each realization's solve
    # state into spatial_shards y-slabs over the device mesh (the
    # reference's MPI/ParMesh axis, src/DarcySolver.cpp:651-675), cutting
    # the per-device memory footprint ~1/shards. spatial_sample_shards
    # additionally shards the sample batch over a leading 'dp' mesh axis
    # (device mesh (dp, sp), spatial_shards * spatial_sample_shards
    # devices). Requires a cg-schur-family solver and essential BCs on
    # both y boundaries; coarser levels stay replicated and batched.
    spatial_shards: int = 0
    spatial_sample_shards: int = 1


@dataclass
class ProblemConfig:
    """Top-level problem configuration.

    Defaults reproduce the reference's built-in test parameters
    (examples/example_helpers/CreateMLMCParameterList.hpp:29-53): the 4x4x4
    hex cube of side 2 refined twice (3 levels), SPDE sampler, correlation
    length 0.1, log-normal, effective-permeability QoI.
    """

    # Mesh / hierarchy.
    mesh: str = "box"  # "box" | "spe10" | "egg" or a path to an MFEM mesh
    ncells: Tuple[int, ...] = (4, 4, 4)
    lengths: Tuple[float, ...] = (2.0, 2.0, 2.0)
    refinements: int = 2  # levels = refinements + 1 (geometric coarsening)
    nlevels: Optional[int] = None
    # Algebraic (METIS-analog) agglomeration of a *given* fine mesh into
    # coarse MLMC levels (reference: "Unstructured coarsening" +
    # "Coarsening factor", examples/MLMC.cpp:96-97, Utilities.cpp:125-155).
    # With unstructured_coarsening, a mesh-file config treats the file as the
    # FINEST mesh and agglomerates it nlevels-1 times.
    unstructured_coarsening: bool = False
    coarsening_factor: int = 8
    # Device grid-axis layout (tensor meshes only). "auto" relabels the
    # mesh axes so the LARGEST cell count is x (the fastest/minor array
    # dim). The rule was tuned for an accelerator that pads the minor axis
    # to 128 lanes (SPE10's x = 60); whether it pays on the GPU is still
    # to be measured (ROADMAP queue 1 item 8). A tuple gives the explicit
    # permutation (new axis i = original axis order[i]). The relabeling is
    # applied at build time to every axis-coupled input (ncells, lengths,
    # spacings, kinv_ref, boundary-side attributes, qoi_point, n_buffer) -
    # the PHYSICAL problem is identical, only the memory layout changes
    # (PRNG cell assignment permutes with the grid, so individual sample
    # realizations differ; the law does not). None = keep the given order.
    axis_order: object = None  # None | "auto" | Tuple[int, ...]

    # Coarse-level Darcy coefficient operators: "galerkin" (coarse velocity
    # mass = exact RAP of the fine kinv_ref-weighted mass through the RT
    # embedding, the tensor analog of the reference's AMGe element-matrix
    # coarsening, src/DarcySolver.cpp:161-169) or "rediscretize" (coarse
    # kinv_ref by volume-weighted arithmetic averaging, the round-1/2
    # behavior). Identical when kinv_ref is absent (the RT embedding is
    # exact, so unit-coefficient RAP == rediscretization).
    coarse_operators: str = "galerkin"
    # Scale the SPDE sampler's Gaussian field per cell to EXACT marginal
    # std sigma using the closed spectral form of the discrete covariance
    # diagonal (ops/tensorsolve.tensor_marginal_std). Removes the boundary
    # variance inflation (which the reference only mitigates by mesh
    # embedding) and the per-level marginal mismatch that kills MLMC
    # variance decay on under-resolving levels (SPE10). Off by default for
    # statistical parity with the reference's plain sampler.
    normalize_marginals: bool = False

    # Uncertainty model.
    sampler_name: str = "pde"  # "pde" | "analytic" | "matern"
    correlation_length: float = 0.1
    variance: float = 1.0
    lognormal: bool = True
    number_of_modes: int = 10  # KLE truncation

    # Embedding.
    embedding: str = "none"  # "none" | "matching" | "projection"
    # Order of the mortar projection master space for embedding="projection":
    # 0 = piecewise-constant L2 projection (reference parity, default);
    # 1 = project through the original mesh's P1 vertex space with the
    # exact mixed P1-P0 mortar coupling (the reference's higher-order
    # L2MortarIntegrator surface, MortarIntegrator.hpp:19-75) and take
    # exact cell averages - a smoother transfer of the same field.
    projection_order: int = 0
    n_buffer: Tuple[int, ...] = (1,)
    # Mesh-file configs: path of the enlarged mesh. Defaults to the
    # reference's naming next to cfg.mesh: <stem>_embed.mesh (matching,
    # materialId selection) / <stem>_enlarge.mesh (projection, mortar).
    embed_mesh: str = ""

    # Boundary conditions / QoI (MFEM attribute convention).
    qoi: str = "eff_perm"  # "eff_perm" | "p_int" | "local_avg_p"
    ess_attr: Tuple[int, ...] = (0, 1, 1, 1, 1, 0)
    obs_attr: Tuple[int, ...] = (1, 0, 0, 0, 0, 0)
    inflow_attr: Tuple[int, ...] = (0, 0, 0, 0, 0, 1)
    qoi_point: Tuple[float, ...] = (0.5, 0.5, 0.5)
    qoi_eps: float = 0.1

    # MC manager.
    mse: float = 1.0e-3
    mse_splitting_ratio: float = 0.5
    initial_samples: int = 10
    initial_samples_per_level: Optional[List[int]] = None
    output_filename: str = "MLMC.dat"
    cost_model: str = "walltime"  # "walltime" | "dofs"

    # Bayesian inverse problem (reference: "Bayesian inverse problem
    # parameters" sublist, src/BayesianInverseProblem.cpp:31-36).
    bayes_noise: float = 0.1
    bayes_num_obs: int = 0  # 0 => observable is int_D p
    bayes_obs_coords: Tuple[float, ...] = (0.5, 0.5, 0.5)
    bayes_eps: float = 0.1
    bayes_generate_ref_data: bool = True
    bayes_ref_data_file: str = "reference_observational_data.dat"

    # Batching / devices.
    batch_size: int = 32
    # Optional per-level batch sizes (finest first; overrides batch_size in
    # the managers). At SPE10 scale the finest level is bound by device
    # memory while coarse levels want large batches to fill the device.
    batch_size_per_level: Optional[List[int]] = None
    # Manager-level sample parallelism: shard every estimator batch over
    # this many devices on a 1D 'dp' jax.sharding.Mesh (parallel.SampleMesh;
    # the reference's per-rank sample loop becomes data parallelism,
    # SURVEY.md 2.3). 0 = off, -1 = all visible devices. Mutually exclusive
    # with darcy_solver.spatial_shards (that path builds its own composed
    # (dp, sp) mesh via spatial_sample_shards).
    sample_shards: int = 0
    dtype: str = "float32"  # device dtype; host verification can use float64
    # Run each MLMC pair step as TWO device programs (coarse solve, then
    # warm-started fine solve) instead of one composed program, so each
    # device execution stays bounded at SPE10 scale (~4.5M dofs) and a
    # host-side convergence check sits between them. Whether the GPU needs
    # this is ROADMAP design item 2. Statistically identical to the
    # composed step (same RNG stream, same warm start).
    split_pair_programs: bool = False
    # With split_pair_programs: continue an unconverged fine solve for up
    # to this many bounded executions (darcy_solver.max_iterations each),
    # chaining the pressure iterate through warm restarts.
    solve_segments: int = 1
    seed: int = 0

    # Solvers.
    sampler_solver: SolverConfig = field(default_factory=SolverConfig)
    darcy_solver: SolverConfig = field(
        default_factory=lambda: SolverConfig(name="cg-schur", max_iterations=500)
    )

    verbose: bool = False

    def __post_init__(self) -> None:
        if self.nlevels is None:
            self.nlevels = self.refinements + 1

    @property
    def dim(self) -> int:
        return len(self.ncells)

    @classmethod
    def from_parameterlist(cls, plist: ParameterList) -> "ProblemConfig":
        """Map the reference's XML key names onto the typed config."""
        prob = plist.sublist("Problem parameters", create=True)
        cfg = cls()
        kw: Dict[str, Any] = {}
        if "Correlation length" in prob:
            kw["correlation_length"] = prob["Correlation length"]
        if "Variance" in prob:
            kw["variance"] = prob["Variance"]
        if "Lognormal" in prob:
            kw["lognormal"] = prob["Lognormal"]
        if "Sampler name" in prob:
            kw["sampler_name"] = prob["Sampler name"]
        if "Number of modes" in prob:
            kw["number_of_modes"] = prob["Number of modes"]
        if "Parallel refinement levels" in prob or "Serial refinement levels" in prob:
            kw["refinements"] = int(prob.get("Parallel refinement levels", 0)) + int(
                prob.get("Serial refinement levels", 0)
            )
            kw["nlevels"] = None
        if "Unstructured coarsening" in prob:
            kw["unstructured_coarsening"] = prob["Unstructured coarsening"]
        if "Coarsening factor" in prob:
            kw["coarsening_factor"] = prob["Coarsening factor"]
        if "Mean square error" in prob:
            kw["mse"] = prob["Mean square error"]
        if "MSE splitting ratio" in prob:
            kw["mse_splitting_ratio"] = prob["MSE splitting ratio"]
        if "Number of samples" in prob:
            kw["initial_samples"] = prob["Number of samples"]
        if "Output filename for MC managers" in prob:
            kw["output_filename"] = prob["Output filename for MC managers"]
        if "Quantity of interest" in prob:
            kw["qoi"] = prob["Quantity of interest"]
        if "Essential attributes" in prob:
            kw["ess_attr"] = tuple(prob["Essential attributes"])
        if "Observational attributes" in prob:
            kw["obs_attr"] = tuple(prob["Observational attributes"])
        if "Inflow attributes" in prob:
            kw["inflow_attr"] = tuple(prob["Inflow attributes"])
        if "Local average pressure QoI spatial point" in prob:
            kw["qoi_point"] = tuple(prob["Local average pressure QoI spatial point"])
        if "Epsilon for local average pressure QoI" in prob:
            kw["qoi_eps"] = prob["Epsilon for local average pressure QoI"]
        if "Verbosity" in prob:
            kw["verbose"] = prob["Verbosity"]
        bayes = plist.get("Bayesian inverse problem parameters")
        if bayes:
            if "Noise" in bayes:
                kw["bayes_noise"] = bayes["Noise"]
            if "Number of observational data points" in bayes:
                kw["bayes_num_obs"] = bayes["Number of observational data points"]
            if "Epsilon for local average pressure" in bayes:
                kw["bayes_eps"] = bayes["Epsilon for local average pressure"]
            if "Observational data coordinates" in bayes:
                kw["bayes_obs_coords"] = tuple(bayes["Observational data coordinates"])
            if "Generate reference observational data" in bayes:
                kw["bayes_generate_ref_data"] = bayes[
                    "Generate reference observational data"
                ]
            if "Reference observational data filename" in bayes:
                kw["bayes_ref_data_file"] = bayes[
                    "Reference observational data filename"
                ]
        return replace(cfg, **kw)
