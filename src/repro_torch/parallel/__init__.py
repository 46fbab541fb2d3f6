from .sharding import DEFAULT_RULES, ShardingRules, logical_spec

__all__ = ["ShardingRules", "DEFAULT_RULES", "logical_spec"]
