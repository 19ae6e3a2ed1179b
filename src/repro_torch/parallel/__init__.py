"""parallel -- mesh/sharding rules, the int8 gradient round trip, error
feedback, the int8 ring all-reduce and the GPipe pipeline over 'pod'."""

from .sharding import (RULE_VARIANTS, ShardingRules, annotate, axis_rules,
                       current_rules, logical_spec, make_rules)

__all__ = ["ShardingRules", "axis_rules", "annotate", "logical_spec",
           "current_rules", "RULE_VARIANTS", "make_rules"]
