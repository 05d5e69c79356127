"""Device-mesh parallelism: sharding the restart × individual axes."""

from conditional_ude_tpu.parallel.mesh import (
    make_mesh,
    pad_cohort,
    pad_to_multiple,
    replicate,
    shard_cohort,
    shard_leading,
    sharded_beta_profiles,
    sharded_fit_betas,
)

__all__ = [
    "make_mesh",
    "pad_cohort",
    "pad_to_multiple",
    "replicate",
    "shard_cohort",
    "shard_leading",
    "sharded_beta_profiles",
    "sharded_fit_betas",
]
