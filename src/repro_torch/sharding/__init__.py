"""Sharding: the reference's partition rules as DTensor placements
(``rules``), the mesh step's collectives (``comm``) and the activation
mesh (``ctx``)."""
from repro_torch.sharding.rules import (ShardingConfig, batch_spec,
                                        cache_spec, dp_axes, local_slices,
                                        param_spec, param_specs, placements,
                                        pool_spec)

__all__ = ["ShardingConfig", "batch_spec", "cache_spec", "dp_axes",
           "local_slices", "param_spec", "param_specs", "placements",
           "pool_spec"]
