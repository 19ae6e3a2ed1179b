"""parallel -- mesh/sharding rules and the int8 gradient round trip (the
pipeline option and the compressed ring wait for the multi-GPU port)."""

from .sharding import (RULE_VARIANTS, ShardingRules, annotate, axis_rules,
                       current_rules, logical_spec, make_rules)

__all__ = ["ShardingRules", "axis_rules", "annotate", "logical_spec",
           "current_rules", "RULE_VARIANTS", "make_rules"]
