"""Logical-axis sharding rules and the port's multi-rank serving mesh
(``repro.sharding``)."""

from repro_torch.sharding.axes import (  # noqa: F401
    AxisRules,
    BASELINE_RULES,
    DP_RULES,
    FSDP_RULES,
    RULE_SETS,
    SP_RULES,
    axis_sizes,
    local_slice,
    resolve_spec,
    summarize_dropped,
    tree_shardings,
)
