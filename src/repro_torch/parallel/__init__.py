"""Sharding rules and the collectives of the multi-device path (port of
``repro.parallel``)."""

from repro_torch.parallel.sharding import (ShardingRules, default_rules,
                                           param_specs, shard, spec_for)

__all__ = ["ShardingRules", "default_rules", "param_specs", "shard",
           "spec_for"]
