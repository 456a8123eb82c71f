"""Shared example-driver plumbing: CLI args -> ProblemConfig.

Mirrors the reference drivers' single `--xml-file` option
(examples/MLMC.cpp:54-57) plus native overrides for every common knob.
With no arguments, drivers run the built-in golden test parameters
(CreateMLMCTestParameters analog). Parsing also turns on the persistent
compilation cache (utils/compile_cache.py).
"""

from __future__ import annotations

import argparse
import dataclasses

from parelagmc_tpu.config import ProblemConfig, read_xml_parameterlist
from parelagmc_tpu.utils.compile_cache import enable_compile_cache


def _attr_vec(s):
    return tuple(int(x) for x in s.split(",")) if s else None


def _axis_order(s):
    if s is None or s in ("auto", "none"):
        return s
    return tuple(int(x) for x in s.split(","))


def parse_config(argv=None, **defaults) -> ProblemConfig:
    enable_compile_cache()
    p = argparse.ArgumentParser()
    p.add_argument("-f", "--xml-file", default=None,
                   help="reference-format XML ParameterList")
    p.add_argument("--mesh", default=None,
                   help="box | spe10 | egg | path/to/file.mesh")
    p.add_argument("--sampler", default=None, choices=["pde", "analytic", "matern"])
    p.add_argument("--embedding", default=None,
                   choices=["none", "matching", "projection"])
    p.add_argument("--projection-order", type=int, default=None,
                   choices=[0, 1],
                   help="mortar master-space order for --embedding "
                        "projection: 0 = P0 L2 projection (default), 1 = "
                        "through the P1 vertex space (higher-order "
                        "L2MortarIntegrator analog)")
    p.add_argument("--refinements", type=int, default=None)
    p.add_argument("--agglomerate", action="store_true",
                   help="treat the mesh file as the FINEST mesh and build "
                        "coarse levels by algebraic agglomeration "
                        "(reference: 'Unstructured coarsening')")
    p.add_argument("--coarsening-factor", type=int, default=None)
    p.add_argument("--corlen", type=float, default=None)
    p.add_argument("--variance", type=float, default=None)
    p.add_argument("--mse", type=float, default=None)
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--qoi", default=None,
                   choices=["eff_perm", "p_int", "local_avg_p"])
    p.add_argument("--ess-attr", default=None,
                   help="comma-separated 0/1 per boundary attribute "
                        "(reference 'Essential attributes')")
    p.add_argument("--obs-attr", default=None)
    p.add_argument("--inflow-attr", default=None)
    p.add_argument("--dtype", default=None,
                   choices=["float32", "float64", "bfloat16"])
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--no-lognormal", action="store_true")
    p.add_argument("--normalize-marginals", dest="normalize_marginals",
                   action="store_true", default=None,
                   help="exact per-cell marginal-variance normalization of "
                        "the SPDE sampler field (config.normalize_marginals)")
    p.add_argument("--raw-marginals", dest="normalize_marginals",
                   action="store_false",
                   help="disable marginal normalization (reference parity)")
    p.add_argument("--axis-order", default=None,
                   help="device grid-axis layout for tensor meshes: "
                        "'auto' (largest cell count becomes the minor "
                        "array axis), "
                        "'none', or an explicit permutation like '1,0,2' "
                        "(config.axis_order)")
    p.add_argument("--coarse-ops", default=None,
                   choices=["galerkin", "rediscretize"],
                   help="coarse Darcy coefficient operators "
                        "(config.coarse_operators)")
    p.add_argument("--sample-shards", type=int, default=None,
                   help="shard every estimator batch over this many "
                        "devices on a 1D 'dp' sample mesh (-1 = all "
                        "visible devices; config.sample_shards). The "
                        "multi-chip data-parallel axis - mutually "
                        "exclusive with --spatial-shards")
    p.add_argument("--spatial-shards", type=int, default=None,
                   help="shard each finest-level Darcy solve into this "
                        "many y-slabs over the device mesh (spatial "
                        "domain decomposition, the reference's MPI/"
                        "ParMesh axis; config.darcy_solver.spatial_shards)")
    p.add_argument("--spatial-sample-shards", type=int, default=None,
                   help="with --spatial-shards: additionally shard the "
                        "sample batch over a leading 'dp' mesh axis "
                        "(shards * sample_shards devices total)")
    p.add_argument("--solver-opt", action="append", default=None,
                   metavar="KEY=VALUE",
                   help="set any DarcySolverConfig field by name, e.g. "
                        "--solver-opt coefmg_cheby_order=3 --solver-opt "
                        "coefmg_cheby_lo=0.10 --solver-opt "
                        "coefmg_prec_dtype=bfloat16 (values are coerced "
                        "to the dataclass field's type; the analog of the "
                        "reference's preconditioner ParameterList blocks, "
                        "src/Utilities.cpp)")
    p.add_argument("--output", default=None,
                   help="per-sample .dat log filename for the MC managers "
                        "(config.output_filename; reference 'Output "
                        "filename for MC managers')")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)

    if args.xml_file:
        cfg = ProblemConfig.from_parameterlist(read_xml_parameterlist(args.xml_file))
    else:
        cfg = ProblemConfig()
    if defaults:
        cfg = dataclasses.replace(cfg, **defaults)

    override = {
        "mesh": args.mesh,
        "sampler_name": args.sampler,
        "embedding": args.embedding,
        "refinements": args.refinements,
        "correlation_length": args.corlen,
        "variance": args.variance,
        "mse": args.mse,
        "initial_samples": args.samples,
        "batch_size": args.batch,
        "qoi": args.qoi,
        "dtype": args.dtype,
        "seed": args.seed,
        "coarsening_factor": args.coarsening_factor,
        "ess_attr": _attr_vec(args.ess_attr),
        "obs_attr": _attr_vec(args.obs_attr),
        "inflow_attr": _attr_vec(args.inflow_attr),
        "normalize_marginals": args.normalize_marginals,
        "coarse_operators": args.coarse_ops,
        "projection_order": args.projection_order,
        "axis_order": _axis_order(args.axis_order),
        "sample_shards": args.sample_shards,
        "output_filename": args.output,
    }
    override = {k: v for k, v in override.items() if v is not None}
    if args.refinements is not None:
        override["nlevels"] = None
    if args.agglomerate:
        override["unstructured_coarsening"] = True
    if args.no_lognormal:
        override["lognormal"] = False
    if args.verbose:
        override["verbose"] = True
    cfg = dataclasses.replace(cfg, **override)
    if args.spatial_shards is not None:
        cfg.darcy_solver.spatial_shards = args.spatial_shards
    if args.spatial_sample_shards is not None:
        cfg.darcy_solver.spatial_sample_shards = args.spatial_sample_shards
    for kv in args.solver_opt or ():
        apply_solver_opt(cfg.darcy_solver, kv)
    return cfg


def apply_solver_opt(scfg, kv: str) -> None:
    """Apply one --solver-opt KEY=VALUE to a DarcySolverConfig, coercing
    VALUE to the field's current type. The single implementation for every
    harness (review r3: three hand-rolled copies had diverged on bool
    parsing)."""
    key, sep, val = kv.partition("=")
    if not sep or not hasattr(scfg, key):
        raise SystemExit(
            f"--solver-opt {kv!r}: unknown DarcySolverConfig field "
            f"{key!r} (see parelagmc_tpu/config.py)"
        )
    cur = getattr(scfg, key)
    coerce = type(cur) if cur is not None else str
    if coerce is bool:
        setattr(scfg, key, val.lower() in ("1", "true", "yes", "on"))
    else:
        setattr(scfg, key, coerce(val))
