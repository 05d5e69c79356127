"""Likelihood profiles, confidence intervals, identifiability classification.

Reference parity (``src/likelihood-profiles.jl``):
  * ``likelihood_profile``        — scan β over ``range(lb, ub, steps)`` and
                                    evaluate NLL = loss/(2σ²) at each (:4-17),
  * ``find_confidence_intervals`` — threshold crossing with the Cantelli-95
                                    (Δ=7.16), Cantelli-90 (Δ=5.24) or
                                    Raue-95 (Δ=χ²₁(0.95)=3.841) offsets,
                                    ±inf when the interval hits the scan edge
                                    (:34-59),
  * identifiability census       — identifiable / practically unidentifiable /
                                    unidentifiable by whether the threshold is
                                    crossed on both / one / no side
                                    (``c-peptide/02-conditional.jl:379-399``).

Batched: the reference's serial 10,000-point scan per individual becomes
ONE vmapped evaluation over the [individuals × grid] plane — a single compiled
program per cohort.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from conditional_ude_tpu.fit.losses import sse
from conditional_ude_tpu.models.cpeptide import Cohort, CPeptideModel

# threshold offsets above the profile minimum (reference :40-47)
THRESHOLDS = {
    "cantelli95": 7.16,
    "cantelli90": 5.24,
    "raue95": 3.8414588206941205,   # chi2(1).quantile(0.95)
}


class Profile(NamedTuple):
    grid: jax.Array     # [S] scanned parameter values
    values: jax.Array   # [..., S] NLL at each grid point
    minimum: jax.Array  # [...] min over the grid


def likelihood_profile(
    loss_fn: Callable[[jax.Array], jax.Array],
    lower: float,
    upper: float,
    steps: int = 10_000,
    sigma: jax.Array | float = 1.0,
) -> Profile:
    """Profile a scalar parameter of ``loss_fn`` over a uniform grid.

    Generic variant (reference :19-32): NLL(β) = loss(β) / (2σ²).
    """
    grid = jnp.linspace(lower, upper, steps)
    vals = jax.vmap(loss_fn)(grid) / (2.0 * jnp.asarray(sigma) ** 2)
    return Profile(grid=grid, values=vals, minimum=jnp.min(vals))


def cohort_beta_profiles(
    model: CPeptideModel,
    nn_params: jax.Array,
    cohort: Cohort,
    sigmas: jax.Array | float = 1.0,
    lower: float = -4.0,
    upper: float = 1.0,
    steps: int = 10_000,
    chunk: int = 500,
    center: jax.Array | None = None,
    **solver_kwargs,
) -> Profile:
    """β-profiles for every individual at once (reference :4-17 looped).

    Returns ``values[N, S]``; the scan is chunked over the grid axis to bound
    memory (N × S trajectories).

    ``center`` — optional per-individual offsets ``[N]``: subject *i* is
    profiled at ``center[i] + grid``, i.e. the grid becomes a shared Δβ axis.
    This is the reference's identifiability census, which scans every subject
    over its own β̂ᵢ ± 10 window (``c-peptide/02-conditional.jl:374-378``).
    """
    grid = jnp.linspace(lower, upper, steps)
    sig = jnp.broadcast_to(jnp.asarray(sigmas, jnp.float32), (cohort.n,))
    ctr = (jnp.zeros((cohort.n,), jnp.float32) if center is None
           else jnp.asarray(center, jnp.float32))

    # nn_params and the cohort arrays are jit OPERANDS (not closure
    # captures): a captured array is baked into the HLO as a constant, so
    # every new fit/cohort of the same shape would repay the compile
    # instead of hitting the in-process and persistent caches
    def at_beta(beta, nn_p, c, ind, data, s):
        kw = dict(solver="rk4", substeps=8)   # throughput default
        kw.update(solver_kwargs)
        err = sse(model, {"neural": nn_p, "conditional": beta + c},
                  ind, cohort.timepoints, data, **kw)
        return err / (2.0 * s**2)

    profile_chunk = jax.jit(jax.vmap(            # over individuals
        jax.vmap(at_beta,
                 in_axes=(0, None, None, None, None, None)),     # over grid
        in_axes=(None, None, 0, 0, 0, 0)))

    parts = []
    for i in range(0, steps, chunk):
        parts.append(profile_chunk(grid[i:i + chunk], nn_params, ctr,
                                   cohort.individuals,
                                   cohort.cpeptide, sig))
    values = jnp.concatenate(parts, axis=1)      # [N, S]
    return Profile(grid=grid, values=values, minimum=jnp.min(values, axis=1))


class ConfidenceInterval(NamedTuple):
    lower: np.ndarray   # ±inf when the threshold is not crossed on that side
    upper: np.ndarray


def find_confidence_intervals(
    profile: Profile,
    method: str = "cantelli95",
) -> ConfidenceInterval:
    """Threshold-crossing CI extraction (reference :34-59).

    Works on a single profile (``values[S]``) or a batch (``values[N, S]``);
    a bound is ±inf when the profile never rises above minimum+Δ on that side
    of the minimizer (interval hits the scan edge).
    """
    if method not in THRESHOLDS:
        raise ValueError(f"method must be one of {sorted(THRESHOLDS)}")
    delta = THRESHOLDS[method]

    values = np.asarray(profile.values)
    grid = np.asarray(profile.grid)
    squeeze = values.ndim == 1
    if squeeze:
        values = values[None]

    n = values.shape[0]
    lo = np.full(n, -np.inf)
    hi = np.full(n, np.inf)
    for i in range(n):
        v = values[i]
        finite = np.isfinite(v)
        if not finite.any():
            continue
        vmin = np.min(v[finite])
        imin = int(np.argmin(np.where(finite, v, np.inf)))
        thresh = vmin + delta
        above = v > thresh
        left = np.flatnonzero(above[:imin])
        if left.size:
            lo[i] = grid[left[-1]]
        right = np.flatnonzero(above[imin + 1:])
        if right.size:
            hi[i] = grid[imin + 1 + right[0]]
    if squeeze:
        return ConfidenceInterval(lower=lo[0], upper=hi[0])
    return ConfidenceInterval(lower=lo, upper=hi)


def classify_identifiability(ci: ConfidenceInterval) -> np.ndarray:
    """Census per individual (``c-peptide/02-conditional.jl:379-399``):
    "identifiable" (both bounds finite), "practically unidentifiable" (one
    side open), "unidentifiable" (both open)."""
    lo = np.atleast_1d(np.asarray(ci.lower))
    hi = np.atleast_1d(np.asarray(ci.upper))
    out = np.where(
        np.isfinite(lo) & np.isfinite(hi), "identifiable",
        np.where(np.isfinite(lo) | np.isfinite(hi),
                 "practically unidentifiable", "unidentifiable"))
    return out
