"""C-peptide kinetics + production models over stacked cohort arrays.

Reference capability: ``src/c-peptide-models.jl`` — van Cauter 2-compartment
kinetics with four production heads (analytic / UDE / conditional UDE /
conditional+covariate UDE).  The reference builds one ``ODEProblem`` object
per individual; here a cohort is a pytree of stacked fixed-shape arrays and
every per-individual quantity is a ``vmap`` axis, so the whole population
integrates as one compiled program.

ODE (reference ``src/c-peptide-models.jl:7-14``):
    du1 = -(k0 + k2)·u1 + k1·u2 + k0·c0 + production(ΔG(t), …)
    du2 = -k1·u2 + k2·u1
with ΔG(t) = glucose(t) − glucose(t0) via linear interpolation of the
measured glucose curve, u0 = [c0, (k2/k1)·c0] (steady state), and van Cauter
kinetic constants from age and T2DM status (:30-42).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from conditional_ude_tpu.nn import MLP
from conditional_ude_tpu.ops.interp import LinearInterp
from conditional_ude_tpu.ops.tsit5 import solve_tsit5, SolveResult
from conditional_ude_tpu.ops.rk4 import solve_rk4

LN2 = float(np.log(2.0))


def van_cauter_parameters(age: jax.Array, t2dm: jax.Array):
    """Kinetic constants k0, k1, k2 from age and T2DM status.

    Van Cauter et al. 1992 standard parameters; reference
    ``src/c-peptide-models.jl:30-42``: short half-life 4.52 (T2DM) / 4.95 min,
    fraction 0.78 / 0.76, long half-life 0.14·age + 29.2 min.
    """
    t2dm = jnp.asarray(t2dm, bool)
    short_hl = jnp.where(t2dm, 4.52, 4.95)
    fraction = jnp.where(t2dm, 0.78, 0.76)
    long_hl = 0.14 * age + 29.2

    k1 = fraction * (LN2 / long_hl) + (1.0 - fraction) * (LN2 / short_hl)
    k0 = (LN2 / short_hl) * (LN2 / long_hl) / k1
    k2 = (LN2 / short_hl) + (LN2 / long_hl) - k0 - k1
    return k0, k1, k2


class Individual(NamedTuple):
    """Per-individual model data (a pytree; stack for a cohort)."""

    glucose_t: jax.Array   # [K] glucose measurement times
    glucose: jax.Array     # [K] glucose values (mmol/L)
    k0: jax.Array
    k1: jax.Array
    k2: jax.Array
    c0: jax.Array          # basal c-peptide
    u0: jax.Array          # [2] steady-state initial condition
    age: jax.Array


class Cohort(NamedTuple):
    """Stacked individuals plus observations (a pytree)."""

    individuals: Individual     # fields have leading N
    cpeptide: jax.Array         # [N, T] observations (nmol/L)
    timepoints: jax.Array       # [T] observation times

    @property
    def n(self) -> int:
        return self.cpeptide.shape[0]

    def individual(self, i) -> Individual:
        return jax.tree.map(lambda a: a[i], self.individuals)


def build_individual(glucose, glucose_t, age, c0, t2dm) -> Individual:
    k0, k1, k2 = van_cauter_parameters(jnp.asarray(age, jnp.float32), t2dm)
    c0 = jnp.asarray(c0, jnp.float32)
    u0 = jnp.stack([c0, (k2 / k1) * c0])
    return Individual(
        glucose_t=jnp.asarray(glucose_t, jnp.float32),
        glucose=jnp.asarray(glucose, jnp.float32),
        k0=k0, k1=k1, k2=k2, c0=c0, u0=u0,
        age=jnp.asarray(age, jnp.float32),
    )


def build_cohort(glucose, timepoints, cpeptide, ages, t2dm) -> Cohort:
    """Stack raw arrays into a cohort pytree.

    ``glucose[N, T]``, ``cpeptide[N, T]`` share ``timepoints[T]`` (the
    reference interpolates glucose over the same OGTT grid it observes
    c-peptide on); ``c0`` is the first c-peptide sample
    (``src/c-peptide-models.jl:174``).
    """
    glucose = jnp.asarray(glucose, jnp.float32)
    cpeptide = jnp.asarray(cpeptide, jnp.float32)
    timepoints = jnp.asarray(timepoints, jnp.float32)
    ages = jnp.asarray(ages, jnp.float32)
    t2dm = jnp.asarray(t2dm, bool)
    inds = jax.vmap(
        lambda g, a, c, d: build_individual(g, timepoints, a, c, d)
    )(glucose, ages, cpeptide[:, 0], t2dm)
    return Cohort(individuals=inds, cpeptide=cpeptide, timepoints=timepoints)


def cohort_dynamic(cohort: Cohort) -> Cohort:
    """Strip the static time grids so the DATA leaves can cross a ``jit``
    boundary as traced operands.

    Closure-capturing a cohort embeds its arrays as HLO constants, which
    makes the compiled program — and its persistent-compile-cache key —
    depend on the data bytes: every new cohort of the same shape then
    repays the full compile.  The time grids are measurement-design
    constants (identical across cohorts of one protocol), so they stay
    closure-side; re-attach with
    :func:`cohort_with_times` inside the traced function.
    """
    return cohort._replace(
        timepoints=None,
        individuals=cohort.individuals._replace(glucose_t=None))


def cohort_times(cohort: Cohort) -> tuple:
    """Concrete ``(timepoints, glucose_t)`` for :func:`cohort_with_times`."""
    return (np.asarray(cohort.timepoints),
            np.asarray(cohort.individuals.glucose_t))


def cohort_with_times(dyn: Cohort, times: tuple) -> Cohort:
    """Re-attach concrete time grids to a :func:`cohort_dynamic` pytree."""
    tp, gt = times
    return dyn._replace(
        timepoints=tp,
        individuals=dyn.individuals._replace(glucose_t=gt))


# -- production heads ---------------------------------------------------------

ProductionFn = Callable[[jax.Array, Any, Individual], jax.Array]
"""(t, params, individual) → scalar plasma production."""


def _delta_g(t, ind: Individual) -> jax.Array:
    """ΔG(t) = glucose(t) − glucose(0.0).

    The baseline is the interpolant at absolute time 0, NOT the first knot —
    the reference's production heads default ``t0 = 0.0``
    (``src/c-peptide-models.jl:69-75``), which differs for cohorts whose
    sampling starts before 0 (Fujita starts at −10 min).
    """
    g = LinearInterp(ind.glucose_t, ind.glucose)
    return g(t) - g(jnp.zeros_like(t))


def analytic_production(fn: Callable[[jax.Array, Any], jax.Array]) -> ProductionFn:
    """Analytic production p(ΔG, θ) (reference :68-75)."""

    def prod(t, params, ind):
        return fn(_delta_g(t, ind), params)

    return prod


def ude_production(net: MLP) -> ProductionFn:
    """Non-conditional UDE: NN(ΔG) − NN(0), baseline-subtracted (:77-84)."""

    def prod(t, params, ind):
        dg = _delta_g(t, ind)
        nn = params["neural"]
        x1 = jnp.atleast_1d(dg)
        x0 = jnp.zeros_like(x1)
        return net.scalar(nn, x1) - net.scalar(nn, x0)

    return prod


def conditional_production(net: MLP) -> ProductionFn:
    """Conditional UDE: NN([ΔG; exp(β)]) − NN([0; exp(β)]) (:86-94)."""

    def prod(t, params, ind):
        dg = _delta_g(t, ind)
        beta = jnp.exp(jnp.atleast_1d(params["conditional"]))
        x1 = jnp.concatenate([jnp.atleast_1d(dg), beta])
        x0 = jnp.concatenate([jnp.zeros(1, dg.dtype), beta])
        nn = params["neural"]
        return net.scalar(nn, x1) - net.scalar(nn, x0)

    return prod


def conditional_covariate_production(net: MLP) -> ProductionFn:
    """Conditional UDE with the age covariate as an extra NN input (:96-104)."""

    def prod(t, params, ind):
        dg = _delta_g(t, ind)
        beta = jnp.exp(jnp.atleast_1d(params["conditional"]))
        age = jnp.atleast_1d(ind.age)
        x1 = jnp.concatenate([jnp.atleast_1d(dg), beta, age])
        x0 = jnp.concatenate([jnp.zeros(1, dg.dtype), beta, age])
        nn = params["neural"]
        return net.scalar(nn, x1) - net.scalar(nn, x0)

    return prod


# -- the combined model --------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CPeptideModel:
    """Kinetics + a production head; shared across a cohort.

    ``kind`` selects the head: "analytic", "ude", "conditional",
    "conditional_covariate".  The covariate variant is a first-class kind
    here (the reference reuses the conditional type for it,
    ``src/c-peptide-models.jl:219`` — a quirk we deliberately drop).
    """

    kind: str
    net: MLP | None = None
    analytic_fn: Callable[[jax.Array, Any], jax.Array] | None = None

    def __post_init__(self):
        kinds = ("analytic", "ude", "conditional", "conditional_covariate")
        if self.kind not in kinds:
            raise ValueError(f"kind must be one of {kinds}")
        if self.kind == "analytic" and self.analytic_fn is None:
            raise ValueError("analytic kind requires analytic_fn")
        if self.kind != "analytic" and self.net is None:
            raise ValueError(f"{self.kind} kind requires net")

    @property
    def production(self) -> ProductionFn:
        if self.kind == "analytic":
            return analytic_production(self.analytic_fn)
        if self.kind == "ude":
            return ude_production(self.net)
        if self.kind == "conditional":
            return conditional_production(self.net)
        return conditional_covariate_production(self.net)

    def rhs(self, t, y, args):
        """Combined RHS (reference ``combine`` at :108-114)."""
        params, ind = args
        prod = self.production(t, params, ind)
        du1 = (-(ind.k0 + ind.k2) * y[0] + ind.k1 * y[1]
               + ind.k0 * ind.c0 + prod)
        du2 = -ind.k1 * y[1] + ind.k2 * y[0]
        return jnp.stack([du1, du2])


def production_orientation(
    model: CPeptideModel,
    nn_params: jax.Array,
    beta_range: tuple[float, float] = (-2.5, 0.5),
    dg_range: tuple[float, float] = (0.5, 10.0),
    age: jax.Array | float = 50.0,
    steps: int = 13,
) -> jax.Array:
    """Canonical ±1 gauge of a trained conditional axis.

    β enters the model only through ``NN([ΔG, e^β, …])``
    (``conditional_production``, reference ``src/c-peptide-models.jl:86-94``),
    so joint training converges to an ARBITRARY monotone orientation of β:
    across seeds, every β-vs-covariate correlation flips sign together while
    its magnitude is stable.  No exact in-model flip exists — β enters
    through e^β, so no weight transformation realizes β → −β with identical
    outputs — hence the framework canonicalizes the REPORTED gauge instead:

      * **+1** when the production surface is decreasing in β over the
        physiological (β, ΔG) box — the orientation of the reference's
        published fitted model — and
      * **−1** when the trained gauge is mirrored.

    Downstream β analyses (correlations with clamp indices, across-seed
    aggregation) use ``orientation * β``; :func:`~…fit.train.train_conditional`
    emits this per restart as ``TrainResult.orientations``.

    ``age`` feeds the covariate input of ``conditional_covariate`` models
    (use the cohort's mean age); ignored otherwise.
    """
    bs = jnp.linspace(beta_range[0], beta_range[1], steps)
    dgs = jnp.linspace(dg_range[0], dg_range[1], 8)
    age = jnp.asarray(age, jnp.float32)

    def prod(dg, b):
        eb = jnp.exp(b)[None]
        parts = [jnp.atleast_1d(dg), eb]
        if model.kind == "conditional_covariate":
            parts.append(age[None])
        x1 = jnp.concatenate(parts)
        x0 = jnp.concatenate([jnp.zeros(1, dg.dtype)] + parts[1:])
        return model.net.scalar(nn_params, x1) - model.net.scalar(
            nn_params, x0)

    surf = jax.vmap(lambda b: jax.vmap(lambda g: prod(g, b))(dgs))(bs)
    slope = jnp.mean(surf[1:] - surf[:-1])
    return jnp.where(slope <= 0, 1.0, -1.0).astype(jnp.float32)


def simulate(
    model: CPeptideModel,
    params: Any,
    ind: Individual,
    saveat: jax.Array,
    solver: str = "tsit5",
    rtol: float = 1e-3,
    atol: float = 1e-6,
    max_steps: int = 256,
    substeps: int = 16,
    mode: str = "scan",
    remat: bool = False,
) -> SolveResult:
    """Solve one individual's c-peptide trajectory at ``saveat`` times.

    Equivalent of ``solve(model.problem, p=θ, saveat=timepoints)`` at the
    reference's default tolerances (``src/parameter-estimation.jl:59``).
    Batch with ``jax.vmap`` over params and/or individuals.  ``mode="while"``
    enables batch-level early exit for gradient-free paths.
    """
    saveat = jnp.asarray(saveat, ind.u0.dtype)
    if solver == "tsit5":
        return solve_tsit5(model.rhs, ind.u0, ind.glucose_t[0], saveat[-1],
                           (params, ind), saveat, max_steps=max_steps,
                           rtol=rtol, atol=atol, mode=mode, remat=remat)
    if solver == "rk4":
        return solve_rk4(model.rhs, ind.u0, (params, ind), saveat,
                         t0=ind.glucose_t[0], substeps=substeps, remat=remat)
    raise ValueError(f"unknown solver {solver!r}")


def simulate_cohort(
    model: CPeptideModel,
    nn_params: jax.Array,
    betas: jax.Array,
    cohort: Cohort,
    saveat: jax.Array | None = None,
    **solver_kwargs,
) -> SolveResult:
    """Batched cohort simulation: shared NN, per-individual β ([N] or [N, c])."""
    saveat = cohort.timepoints if saveat is None else saveat

    def one(beta, ind):
        params = {"neural": nn_params, "conditional": beta}
        return simulate(model, params, ind, saveat, **solver_kwargs)

    return jax.vmap(one)(betas, cohort.individuals)
