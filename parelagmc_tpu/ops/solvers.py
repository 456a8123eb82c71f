"""Batched iterative Krylov solvers with convergence masking.

These replace the reference's runtime SolverLibrary (hypre MINRES/CG with
AMG-type preconditioners, selected by name from the XML Preconditioner
Library - reference: src/PDESampler.cpp:286-317, src/DarcySolver.cpp:562-649).
On an accelerator the economics are different: one Krylov iteration applied to a
*batch* of right-hand sides costs barely more than to one, so we run all
samples of a batch through the same fixed-shape iteration and mask
converged columns instead of stopping them individually (SURVEY.md 7.3
hard-part #1).

Conventions:
* Vectors have shape (..., n): arbitrary leading batch dims, dof axis last.
* `apply` and `prec` are closures over the (static) operators, mapping
  (..., n) -> (..., n).
* Convergence: ||r||_2 <= max(rtol * ||b||_2, atol), per batch element.
* The loop is a lax.while_loop bounded by max_iters; it exits early when
  every batch element has converged (fixed shapes, dynamic trip count -
  XLA-friendly).

Both methods return (x, info) where info holds iterations taken and final
relative residuals for observability (reference prints per-solve residual
norms when verbose, src/DarcySolver.cpp:603-648).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


class SolveInfo(NamedTuple):
    iterations: jnp.ndarray  # scalar int32: iterations executed
    residual: jnp.ndarray  # (...,) final |r| / |b|
    converged: jnp.ndarray  # (...,) bool


def _vdot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(a * b, axis=-1)


def pcg(
    apply_A: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    prec: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
    x0: Optional[jnp.ndarray] = None,
    max_iters: int = 300,
    rtol: float = 1e-6,
    atol: float = 1e-12,
    restart_every: int = 0,
    want_r_true: bool = False,
):
    """Preconditioned conjugate gradients for SPD systems, batched.

    `restart_every > 0` recomputes the true residual r = b - A x and resets
    the search direction every that many iterations - essential in float32,
    where the residual recurrence drifts and plain CG stagnates around
    1e-3..1e-5 relative residual (measured on the Darcy Schur systems).

    `want_r_true=True` returns (x, info, r_true) with r_true = b - A x the
    final TRUE residual vector, computed unconditionally (the adjoint QoI
    correction consumes it, so the exit-verification below shares that one
    operator application instead of paying its own; review r3).
    """
    if prec is None:
        prec = lambda r: r
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - apply_A(x) if x0 is not None else b
    z = prec(r)
    p = z
    rz = _vdot(r, z)
    b_norm = jnp.sqrt(_vdot(b, b))
    thresh = jnp.maximum(rtol * b_norm, atol)
    rn = jnp.sqrt(_vdot(r, r))

    def cond(state):
        it, x, r, p, rz, rn = state
        return (it < max_iters) & jnp.any(rn > thresh)

    def body(state):
        it, x, r, p, rz, rn = state
        active = rn > thresh
        Ap = apply_A(p)
        pAp = _vdot(p, Ap)
        alpha = jnp.where(pAp > 0, rz / jnp.where(pAp == 0, 1.0, pAp), 0.0)
        alpha = jnp.where(active, alpha, 0.0)[..., None]
        x = x + alpha * p
        r = r - alpha * Ap
        if restart_every > 0:
            # lax.cond, not jnp.where: the true-residual recompute must only
            # execute on restart iterations (an extra apply_A every iteration
            # would double the loop cost).
            do_restart = (it + 1) % restart_every == 0
            r = jax.lax.cond(do_restart, lambda: b - apply_A(x), lambda: r)
        z = prec(r)
        rz_new = _vdot(r, z)
        beta = jnp.where(rz > 0, rz_new / jnp.where(rz == 0, 1.0, rz), 0.0)
        if restart_every > 0:
            beta = jnp.where(do_restart, 0.0, beta)  # steepest-descent reset
        p = z + jnp.where(active, beta, 0.0)[..., None] * p
        rn = jnp.sqrt(_vdot(r, r))
        return it + 1, x, r, p, rz_new, rn

    it0 = jnp.zeros((), dtype=jnp.int32)
    it, x, r, p, rz, rn = jax.lax.while_loop(cond, body, (it0, x, r, p, rz, rn))
    # Verify claimed convergence against the TRUE residual. The loop's rn
    # is the CG recurrence residual between restarts, and in float32 the
    # recurrence drifts BELOW the true residual - measured at SPE10 scale
    # (batch 8, cg-schur-coefmg + order-3 Chebyshev smoothing): the
    # recurrence claimed rtol 1e-5 at iteration 36 while the true residual
    # was orders looser, leaving the flux QoI 5x wrong (Q=21.8 vs 116.6;
    # same failure shape as the rtol root-cause note in CLAUDE.md). One
    # extra apply_A, and only on EARLY exit: fixed-budget runs (bench.py's
    # 50-iteration golden solves) exit by max_iters and skip it, so the
    # throughput headline is untouched. Honest converged flags make the
    # segmented production paths (solve_fwd_x0 continuations keyed on
    # info.converged) self-correcting against this whole drift class.
    def _true_rn(args):
        x, rn = args
        r_t = b - apply_A(x)
        return jnp.sqrt(_vdot(r_t, r_t))

    # Trigger on CLAIMED convergence (recurrence rn at/below thresh), not on
    # `it < max_iters`: a sample whose drifted recurrence crosses thresh
    # during the max_iters-th iteration exits with it == max_iters and would
    # otherwise return an unverified converged=True (review r3).
    claimed = rn <= thresh
    r_true = None
    if want_r_true:
        r_true = b - apply_A(x)
        rn = jnp.sqrt(_vdot(r_true, r_true))
        verified = True
    else:
        verified = jnp.any(claimed)
        rn = jax.lax.cond(verified, _true_rn, lambda args: args[1], (x, rn))
    rel = rn / jnp.where(b_norm == 0, 1.0, b_norm)
    # The true residual at the exit iteration generically sits a small
    # factor above the recurrence that triggered the exit (measured 2x at
    # rtol 1e-10 on the f64 unstructured saddle solves); the failure class
    # this verification exists for is ORDERS of magnitude. 4x slack keeps
    # the flag honest for the latter without flagging the former. Slack only
    # for rows that claimed: an unconverged row must not ride along.
    conv = rn <= thresh * jnp.where(verified & claimed, 4.0, 1.0)
    info = SolveInfo(it, rel, conv)
    if want_r_true:
        return x, info, r_true
    return x, info


def minres(
    apply_A: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    prec: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
    x0: Optional[jnp.ndarray] = None,
    max_iters: int = 500,
    rtol: float = 1e-6,
    atol: float = 1e-12,
    cycles: int = 3,
    cycle_tighten: float = 0.25,
):
    """Preconditioned MINRES (Paige-Saunders) for symmetric indefinite
    systems with an SPD preconditioner, batched, with true-residual-driven
    restart cycles.

    Used for the Darcy saddle-point system [[M(k), B^T], [B, 0]] with a
    block-diagonal SPD preconditioner (the reference's MINRES-BJ-GS
    configuration: examples/example_helpers/CreateMLMCParameterList.hpp).

    Why cycles: phibar - the Paige-Saunders residual estimate that drives
    the inner exit - is the residual norm in the PRECONDITIONER norm
    (beta1 = sqrt(r . prec(r))), while the convergence contract is the
    2-norm ||b - A x|| <= rtol ||b||. With the coefMG/diagonal Darcy
    preconditioners the two norms differ by a problem-dependent constant -
    measured 2.7-7.6x on the agglomerated cube_tet saddle systems in
    FLOAT64, i.e. a systematic norm mismatch, not rounding drift - so a
    single sweep exits with the true residual a fixed factor above target
    at every rtol (round-5 root cause; the old 4x-slack honest flag
    correctly reported those rows unconverged). Each restart cycle
    recomputes the true residual, stops rows that genuinely meet the
    2-norm target, and re-enters the Lanczos sweep from the current
    iterate with the inner target tightened by `cycle_tighten` for the
    rest - so the solver self-corrects the norm gap at the cost of one
    operator application per cycle, and `info.converged` is honest by
    construction. Rows exit strictly on the 2-norm criterion; the 4x
    slack remains only for budget-exhausted rows that claimed inner
    convergence on the final cycle.
    """
    if prec is None:
        prec = lambda r: r
    x = jnp.zeros_like(b) if x0 is None else x0
    b_norm = jnp.sqrt(_vdot(b, b))
    thresh = jnp.maximum(rtol * b_norm, atol)

    eps = jnp.asarray(1e-30, dtype=b.dtype)

    def safe_div(a, d):
        return a / jnp.where(jnp.abs(d) < eps, eps, d)

    big = jnp.asarray(float("inf"), dtype=b.dtype)

    def lanczos_sweep(x, r1, it0, thresh_row):
        """One Paige-Saunders sweep from iterate x with residual r1 = b-Ax;
        per-row inner exit when phibar (the preconditioner-norm estimate)
        falls under thresh_row (+inf rows are frozen). The global iteration
        counter continues across sweeps and shares max_iters."""
        y = prec(r1)
        beta1 = jnp.sqrt(jnp.maximum(_vdot(r1, y), 0.0))
        state = dict(
            it=it0,
            x=x,
            r1=r1,  # v_{k-1} * beta_{k-1} (unpreconditioned)
            r2=r1,  # v_k * beta_k
            y=y,
            beta=beta1,
            beta_prev=jnp.ones_like(beta1),  # placeholder; unused on step 1
            dbar=jnp.zeros_like(beta1),
            epsln=jnp.zeros_like(beta1),
            cs=-jnp.ones_like(beta1),
            sn=jnp.zeros_like(beta1),
            w=jnp.zeros_like(b),
            w2=jnp.zeros_like(b),
            phibar=beta1,
            # Per-sweep "no previous Lanczos vector yet" flag: the old
            # implementation used it > 0, which breaks for restarted
            # sweeps whose it0 carries over from earlier cycles.
            first=jnp.ones((), dtype=jnp.bool_),
        )

        def body(s):
            active = s["phibar"] > thresh_row
            v = s["y"] * safe_div(jnp.ones_like(s["beta"]), s["beta"])[..., None]
            yv = apply_A(v)
            shift = safe_div(s["beta"], s["beta_prev"])
            yv = jnp.where(~s["first"], yv - shift[..., None] * s["r1"], yv)
            alfa = _vdot(v, yv)
            yv = yv - safe_div(alfa, s["beta"])[..., None] * s["r2"]
            r1_new = s["r2"]
            r2_new = yv
            y_new = prec(yv)
            beta_new = jnp.sqrt(jnp.maximum(_vdot(yv, y_new), 0.0))

            # Apply previous rotation.
            oldeps = s["epsln"]
            delta = s["cs"] * s["dbar"] + s["sn"] * alfa
            gbar = s["sn"] * s["dbar"] - s["cs"] * alfa
            epsln_new = s["sn"] * beta_new
            dbar_new = -s["cs"] * beta_new

            # New rotation.
            gamma = jnp.sqrt(gbar * gbar + beta_new * beta_new)
            gamma = jnp.maximum(gamma, eps)
            cs_new = gbar / gamma
            sn_new = beta_new / gamma
            phi = cs_new * s["phibar"]
            phibar_new = sn_new * s["phibar"]

            denom = safe_div(jnp.ones_like(gamma), gamma)
            w1 = s["w2"]
            w2 = s["w"]
            w_new = (v - oldeps[..., None] * w1 - delta[..., None] * w2) * denom[
                ..., None
            ]
            x_new = s["x"] + phi[..., None] * w_new

            # Gate updates for converged batch elements.
            g = active[..., None]
            ga = active
            return dict(
                it=s["it"] + 1,
                x=jnp.where(g, x_new, s["x"]),
                r1=jnp.where(g, r1_new, s["r1"]),
                r2=jnp.where(g, r2_new, s["r2"]),
                y=jnp.where(g, y_new, s["y"]),
                beta=jnp.where(ga, beta_new, s["beta"]),
                beta_prev=jnp.where(ga, s["beta"], s["beta_prev"]),
                dbar=jnp.where(ga, dbar_new, s["dbar"]),
                epsln=jnp.where(ga, epsln_new, s["epsln"]),
                cs=jnp.where(ga, cs_new, s["cs"]),
                sn=jnp.where(ga, sn_new, s["sn"]),
                w=jnp.where(g, w_new, s["w"]),
                w2=jnp.where(g, w2, s["w2"]),
                phibar=jnp.where(ga, phibar_new, s["phibar"]),
                first=jnp.zeros((), dtype=jnp.bool_),
            )

        def cond(s):
            return (s["it"] < max_iters) & jnp.any(s["phibar"] > thresh_row)

        s = jax.lax.while_loop(cond, body, state)
        return s["x"], s["it"], s["phibar"] <= thresh_row

    def run_cycle(carry):
        x, it, thresh_i, all_done, claimed = carry
        r_t = b - apply_A(x)
        rn = jnp.sqrt(_vdot(r_t, r_t))
        done = rn <= thresh  # strict 2-norm verification per row
        x, it, sweep_claim = lanczos_sweep(
            x, r_t, it, jnp.where(done, big, thresh_i)
        )
        claimed = claimed | done | sweep_claim
        # Rows that failed verification re-enter with a tighter inner
        # target next cycle (the measured norm gap is a bounded factor).
        thresh_i = jnp.where(done, thresh_i, thresh_i * cycle_tighten)
        return x, it, thresh_i, jnp.all(done), claimed

    carry = (
        x,
        jnp.zeros((), dtype=jnp.int32),
        thresh,
        jnp.zeros((), dtype=jnp.bool_),
        jnp.zeros(thresh.shape, dtype=jnp.bool_),
    )
    for _ in range(max(1, cycles)):
        carry = jax.lax.cond(
            carry[3] | (carry[1] >= max_iters), lambda c: c, run_cycle, carry
        )
    x, it, _, _, claimed = carry
    # Final true-residual report: rows that converged during the last sweep
    # have not been 2-norm-verified yet; one unconditional apply_A keeps
    # info honest for them too.
    r_t = b - apply_A(x)
    rn = jnp.sqrt(_vdot(r_t, r_t))
    rel = rn / jnp.where(b_norm == 0, 1.0, b_norm)
    # Strict 2-norm convergence; the 4x slack (same class as pcg above)
    # applies only to rows whose inner estimate claimed convergence but ran
    # out of cycles/budget before the strict criterion was met.
    conv = rn <= thresh * jnp.where(claimed, 4.0, 1.0)
    return x, SolveInfo(it, rel, conv)


def chebyshev(
    apply_A: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    lam_max: jnp.ndarray,
    lam_min_frac: float = 1.0 / 30.0,
    order: int = 5,
    x0: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Fixed-order Chebyshev iteration approximating A^{-1} b on the
    spectral interval [lam_min_frac*lam_max, lam_max].

    `lam_max` is batched (per-sample upper bounds, e.g. infinity-norm row
    sums of a per-sample operator). Being a fixed polynomial in A, this is a
    *linear* operator in b - safe as a MINRES/CG preconditioner.
    """
    lmax = lam_max
    lmin = lam_min_frac * lam_max
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - apply_A(x) if x0 is not None else b
    # Standard Chebyshev recurrence (Saad, Iterative Methods, alg. 12.1).
    alpha = jnp.where(theta == 0, 0.0, 1.0 / jnp.where(theta == 0, 1.0, theta))
    d = alpha[..., None] * r
    sigma = theta / jnp.where(delta == 0, 1.0, delta)
    rho = 1.0 / sigma
    for _ in range(order):
        x = x + d
        r = r - apply_A(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho)[..., None] * d + (
            2.0 * rho_new / jnp.where(delta == 0, 1.0, delta)
        )[..., None] * r
        rho = rho_new
    return x
