"""conditional_ude_tpu — a JAX framework for conditional Universal
Differential Equations (cUDE) on population time-series data.

A from-scratch JAX/XLA re-design of the capabilities of
Computational-Biology-TUe/conditional-ude (pure-Julia SciML research code):
mechanistic ODEs whose unknown terms are neural networks that receive learnable
per-individual "conditional" parameters, trained jointly over a population and
re-estimated per individual at test time.

Design principles (batched, not a port):
  * every per-individual / per-restart loop in the reference becomes a ``vmap``
    axis over stacked fixed-shape arrays,
  * the adaptive Tsit5 integrator runs as a bounded ``lax.scan`` with
    per-trajectory done/failure masks so whole cohorts integrate in one
    compiled program,
  * multi-start screening, L-BFGS restarts, likelihood-profile scans and SAEM
    chains are batched and shard over a ``jax.sharding.Mesh`` rather
    than serial loops / Distributed.pmap.
"""

__version__ = "0.1.0"

from conditional_ude_tpu import nn, ops, models, fit, analysis, data, parallel, utils

__all__ = [
    "nn",
    "ops",
    "models",
    "fit",
    "analysis",
    "data",
    "parallel",
    "utils",
]
