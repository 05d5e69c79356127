"""Device-mesh sharding for the framework's parallel axes.

The reference's only parallelism is serial loops / ``Distributed.pmap`` over
local CPU workers (SURVEY.md §2.13).  Here the scaling axes — multi-start
*restarts* and population *individuals* — are leading array dimensions, and
this module lays them out over a ``jax.sharding.Mesh`` so that the vmapped
losses partition across devices with XLA inserting the (tiny) collectives:
per-lane ODE solves are fully independent, so the only communication is
the final ``mean``/``argsort`` reductions.

Usage pattern (idiomatic pjit, no manual collectives):
  * build a mesh with :func:`make_mesh` — 1D ``("restarts",)`` for
    multi-start stages, 2D ``("restarts", "individuals")`` for joint
    screening over both axes;
  * place batched inputs with :func:`shard_leading` /
    :func:`shard_cohort`;
  * call the ordinary jitted batched function — XLA propagates the input
    shardings through ``vmap`` and partitions the program.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    axis_names: Sequence[str] = ("restarts",),
    shape: Sequence[int] | None = None,
    devices: Sequence[jax.Device] | None = None,
) -> Mesh:
    """Build a mesh over ``devices`` (default: all available).

    With ``shape=None`` the first axis takes all devices and the remaining
    axes get size 1 — the safe default for the restart-dominant workloads
    here (restarts ≫ individuals-per-chip gains for tiny ODEs).
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, tuple(axis_names))


def pad_to_multiple(x: jax.Array, multiple: int, axis: int = 0,
                    fill=None) -> jax.Array:
    """Pad ``axis`` up to a multiple so it divides evenly across shards.

    Padded lanes replicate the last real entry by default (``fill=None``),
    keeping them numerically benign (they converge like real lanes and are
    sliced off by the caller).
    """
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x
    pad = target - n
    if fill is None:
        import jax.numpy as jnp
        last = jax.lax.slice_in_dim(x, n - 1, n, axis=axis)
        reps = [1] * x.ndim
        reps[axis] = pad
        return jnp.concatenate([x, jnp.tile(last, reps)], axis=axis)
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    import jax.numpy as jnp
    return jnp.pad(x, widths, constant_values=fill)


def shard_leading(tree: Any, mesh: Mesh, axis_name: str = "restarts") -> Any:
    """Place every leaf with its leading dim sharded over ``axis_name``.

    Leading dims must divide the mesh axis size (use :func:`pad_to_multiple`
    first). Scalar / 0-d leaves are replicated.
    """

    def put(x):
        x = jax.numpy.asarray(x)
        if x.ndim == 0:
            spec = P()
        else:
            spec = P(axis_name, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(put, tree)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Replicate every leaf across the whole mesh."""
    return jax.tree.map(
        lambda x: jax.device_put(jax.numpy.asarray(x),
                                 NamedSharding(mesh, P())), tree)


def shard_cohort(cohort: Any, mesh: Mesh,
                 axis_name: str = "individuals") -> Any:
    """Shard a :class:`~conditional_ude_tpu.models.cpeptide.Cohort` over the
    individuals axis: per-individual leaves split, shared leaves replicate.

    The cohort's ``timepoints`` (shape [T], shared) replicates; everything
    under ``individuals`` plus ``cpeptide`` ([N, …]) shards on N.
    """
    from conditional_ude_tpu.models.cpeptide import Cohort

    inds = shard_leading(cohort.individuals, mesh, axis_name)
    cpep = shard_leading(cohort.cpeptide, mesh, axis_name)
    tp = jax.device_put(cohort.timepoints, NamedSharding(mesh, P()))
    return Cohort(individuals=inds, cpeptide=cpep, timepoints=tp)


def pad_cohort(cohort: Any, multiple: int) -> Any:
    """Pad a cohort's individuals axis up to a multiple (replicating the
    last subject) so it divides evenly across a mesh axis; callers slice
    the padded results back to the true ``n``."""
    from conditional_ude_tpu.models.cpeptide import Cohort

    if cohort.n % multiple == 0:
        return cohort
    inds = jax.tree.map(lambda a: pad_to_multiple(a, multiple),
                        cohort.individuals)
    cpep = pad_to_multiple(cohort.cpeptide, multiple)
    return Cohort(individuals=inds, cpeptide=cpep,
                  timepoints=cohort.timepoints)


def sharded_fit_betas(model, nn_params, cohort, mesh: Mesh,
                      axis_name: str = "individuals", sigma: bool = False,
                      **kwargs):
    """Per-individual (β[, σ]) re-estimation sharded over the population
    axis: the cohort splits over ``axis_name`` and the ordinary vmapped
    bounded-L-BFGS program partitions with zero cross-chip communication
    (each subject's fit is independent — the reference's serial loop at
    ``src/parameter-estimation.jl:272-307``).

    ``sigma=True`` routes to :func:`~…fit.train.fit_betas_sigma`.
    """
    from conditional_ude_tpu.fit.train import fit_betas, fit_betas_sigma

    n = cohort.n
    size = mesh.shape[axis_name]
    cohort_s = shard_cohort(pad_cohort(cohort, size), mesh, axis_name)
    fn = fit_betas_sigma if sigma else fit_betas
    out = fn(model, nn_params, cohort_s, **kwargs)
    return tuple(x[:n] for x in out)


def sharded_beta_profiles(model, nn_params, cohort, mesh: Mesh,
                          axis_name: str = "individuals",
                          sigmas=1.0, center=None,
                          lower: float = -4.0, upper: float = 1.0,
                          steps: int = 10_000, chunk: int = 500,
                          **solver_kwargs):
    """Cohort likelihood-profile scans sharded over the individuals axis
    (``src/likelihood-profiles.jl`` looped per subject in the reference);
    each device scans its population shard over the full β grid.  The
    cohort pads to a multiple of the axis and the padded rows are sliced
    off the result."""
    import jax.numpy as jnp

    from conditional_ude_tpu.analysis.profiles import (
        Profile,
        cohort_beta_profiles,
    )

    n = cohort.n
    size = mesh.shape[axis_name]
    cohort_p = pad_cohort(cohort, size)
    sig = jnp.broadcast_to(jnp.asarray(sigmas, jnp.float32), (n,))
    ctr = (jnp.zeros((n,), jnp.float32) if center is None
           else jnp.asarray(center, jnp.float32))
    prof = cohort_beta_profiles(
        model, nn_params, shard_cohort(cohort_p, mesh, axis_name),
        sigmas=shard_leading(pad_to_multiple(sig, size), mesh, axis_name),
        center=shard_leading(pad_to_multiple(ctr, size), mesh, axis_name),
        lower=lower, upper=upper, steps=steps, chunk=chunk, **solver_kwargs)
    return Profile(grid=prof.grid, values=prof.values[:n],
                   minimum=prof.minimum[:n])
