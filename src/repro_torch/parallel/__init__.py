"""Multi-device code on ``torch.distributed`` (counterpart of
``repro.parallel``): logical-axis sharding rules on ``DeviceMesh`` /
``DTensor`` and the all-to-all MoE dispatch across ranks."""

from repro_torch.parallel.sharding import (
    axis_rules,
    constrain,
    current_mesh,
    logical_to_spec,
    param_shardings,
    DEFAULT_RULES,
)

__all__ = [
    "axis_rules", "constrain", "current_mesh", "logical_to_spec",
    "param_shardings", "DEFAULT_RULES",
]
