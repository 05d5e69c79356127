"""Symbolic (Michaelis-Menten) c-peptide production model.

The PySR-discovered equation productionized by the reference
(``c-peptide/03-symreg.jl:36-40``):

    production(ΔG, k) = 1.78·ΔG / (ΔG + k)   for ΔG ≥ 0, else 0

with the β→k dose-response map ``k = 167·β³ + 21.8`` (:55) and the
per-individual scalar-k fits of scripts 03 (Ohashi, all 117 subjects) and
04 (Fujita external validation): box-bounded L-BFGS on the Gaussian σ-NLL,
initial ``(k, σ) = (40, 1)``, bounds [0, 1000] on both (:99-107).

Batched: the reference's serial per-individual loop is one ``vmap``; the
whole population fits in a single compiled program.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from conditional_ude_tpu.fit.losses import sse_sigma
from conditional_ude_tpu.models.cpeptide import Cohort, CPeptideModel
from conditional_ude_tpu.ops.lbfgs import lbfgs_minimize


def symbolic_production(dg: jax.Array, k: jax.Array) -> jax.Array:
    """1.78·ΔG/(ΔG + k) gated to ΔG ≥ 0 (``03-symreg.jl:37``).

    Implemented as relu(ΔG) so the ungated branch cannot emit NaN/Inf
    gradients near ΔG = -k.
    """
    dgp = jax.nn.relu(dg)
    return 1.78 * dgp / (dgp + k)


def discovered_production(dg: jax.Array, beta_exp: jax.Array) -> jax.Array:
    """The rational equation THIS repo's GP search discovers on its own
    exported production surface (``experiments/exp_symreg_search.py``;
    committed 3-seed merged front ``results/symbolic_regression_result.csv``,
    c=14 row):

        production(ΔG, b) = 0.1817·ΔG / (b²·(ΔG + 5.507) + 2.99)  for ΔG ≥ 0

    with ``b = e^β`` (the NN-input scale, like :func:`beta_to_k`).  Held
    out: 0.00049 MSE vs 0.00535 for the reference's published c=16
    equation on the same 20% holdout (11×), and every one of the three
    independent search seeds re-finds the inv family and individually
    beats the reference equation
    (``results/exp_symreg_metrics.json["seeds"]``) — the same
    Michaelis-Menten family (saturating in ΔG, β-gated), but with a
    b²-gated denominator acting on BOTH Vmax and the half-saturation
    point, which fits this repo's learned surface better than the
    reference's β³-only denominator.  The *productionized* model below
    stays the reference's equation for parity with scripts 03/04/06a.
    """
    dgp = jax.nn.relu(dg)
    b2 = beta_exp * beta_exp
    return 0.1817 * dgp / (b2 * (dgp + 5.507) + 2.99)


def beta_to_k(beta_exp: jax.Array) -> jax.Array:
    """Dose-response map from the cUDE conditional parameter to the symbolic
    Michaelis constant: k = 167·b³ + 21.8 (``03-symreg.jl:55``).

    ``beta_exp`` is on the NN-input scale e^β — the reference applies the
    map to the ``Beta`` column of ``data/ohashi_production.csv``, which its
    script 02 exports already exponentiated (``conditional_production``
    feeds the NN ``exp.(p.conditional)``, ``src/c-peptide-models.jl:86-94``).
    Pass ``exp(β)`` when starting from a raw fitted β."""
    return 167.0 * beta_exp**3 + 21.8


def symbolic_model() -> CPeptideModel:
    """A :class:`CPeptideModel` whose production head is the symbolic
    equation; ``params["k"]`` is the per-individual Michaelis constant."""
    return CPeptideModel(
        kind="analytic",
        analytic_fn=lambda dg, params: symbolic_production(dg, params["k"]),
    )


def discovered_model() -> CPeptideModel:
    """A :class:`CPeptideModel` whose production head is the IN-REPO
    discovered rational equation (:func:`discovered_production`);
    ``params["b"]`` is the per-individual gate on the e^β scale."""
    return CPeptideModel(
        kind="analytic",
        analytic_fn=lambda dg, params: discovered_production(
            dg, params["b"]),
    )


def _fit_scalar_sigma(model, param_key, cohort, initial, lower, upper,
                      lbfgs_iters, solver, solver_max_steps,
                      dispatch_chunk):
    """Shared per-individual (scalar, σ) fitter behind :func:`fit_k_sigma`
    and :func:`fit_b_sigma`: box-bounded L-BFGS on the Gaussian σ-NLL,
    vmapped over the cohort, run as ``dispatch_chunk``-iteration dispatches
    (the curvature history threads through the chunks, so chunking never
    changes the result; the chunk bounds each dispatch's runtime, as
    ``SuppressionFitConfig.dispatch_chunk`` does).

    The cohort rides through the jit boundary as traced operands (a
    closure-captured cohort is baked into the HLO as constants, so the
    Ohashi and Fujita fits — and every replication seed — would each
    repay the full compile instead of sharing it; same invariant as
    ``fit_betas_sigma``).
    """
    lower = jnp.asarray(lower, jnp.float32)
    upper = jnp.asarray(upper, jnp.float32)

    @partial(jax.jit, static_argnums=(2,))
    def run_chunk(x0s, cohort_, iters, state):
        def fit_one(x0, ind, data, st):
            def loss(x):
                return sse_sigma(model, {param_key: x[0]}, x[1], ind,
                                 cohort_.timepoints, data, solver=solver,
                                 max_steps=solver_max_steps)

            res = lbfgs_minimize(loss, x0, lower=lower, upper=upper,
                                 max_iters=iters, init_state=st)
            return res.x, res.fval, res.state

        return jax.vmap(fit_one)(x0s, cohort_.individuals,
                                 cohort_.cpeptide, state)

    xs = jnp.broadcast_to(jnp.asarray(initial, jnp.float32), (cohort.n, 2))
    fvals, st = None, None
    done = 0
    while done < lbfgs_iters:
        step = min(dispatch_chunk, lbfgs_iters - done)
        xs, fvals, st = run_chunk(xs, cohort, step, st)
        jax.block_until_ready(fvals)
        done += step
    return xs[:, 0], xs[:, 1], fvals


def fit_b_sigma(
    cohort: Cohort,
    lbfgs_iters: int = 1000,
    initial_b: float = 0.7,
    initial_sigma: float = 1.0,
    b_bounds: tuple[float, float] = (1e-3, 50.0),
    sigma_bounds: tuple[float, float] = (1e-6, 1e3),
    solver: str = "rk4",
    solver_max_steps: int = 256,
    dispatch_chunk: int = 250,
):
    """Per-individual (b, σ) fit of the DISCOVERED rational model.

    The in-repo analog of the reference's per-individual k fits
    (``c-peptide/03-symreg.jl:95-107``) for the equation this repo's own
    symbolic search surfaces: the complete NN → symbolic-regression →
    mechanistic-refit loop with no inherited equation.  Unlike
    :func:`fit_k_sigma` (which keeps the reference's same-box-for-both
    quirk for parity), b and σ get their own bounds.

    Returns ``(bs[N], sigmas[N], objectives[N])``.
    """
    return _fit_scalar_sigma(
        discovered_model(), "b", cohort, [initial_b, initial_sigma],
        [b_bounds[0], sigma_bounds[0]], [b_bounds[1], sigma_bounds[1]],
        lbfgs_iters, solver, solver_max_steps, dispatch_chunk)


def fit_k_sigma(
    cohort: Cohort,
    lbfgs_iters: int = 1000,
    initial_k: float = 40.0,
    initial_sigma: float = 1.0,
    bounds: tuple[float, float] = (0.0, 1000.0),
    solver: str = "rk4",
    solver_max_steps: int = 256,
    dispatch_chunk: int = 250,
):
    """Per-individual (k, σ) fit of the symbolic model over a whole cohort.

    Equivalent of the serial loop at ``c-peptide/03-symreg.jl:95-107``
    (reused for Fujita in ``04-symreg-external.jl:48-56``); the reference's
    bounds apply to BOTH components of the (k, σ) vector — a quirk kept
    for parity.

    Returns ``(ks[N], sigmas[N], objectives[N])``.
    """
    lb, ub = bounds
    return _fit_scalar_sigma(
        symbolic_model(), "k", cohort, [initial_k, initial_sigma],
        [lb, lb], [ub, ub],
        lbfgs_iters, solver, solver_max_steps, dispatch_chunk)


