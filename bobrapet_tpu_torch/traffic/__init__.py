"""Traffic shaping for the serving plane: weighted-fair tenant admission
(fairness.py)."""

from .fairness import WeightedFairQueue, parse_tenant_weights

__all__ = ["WeightedFairQueue", "parse_tenant_weights"]
