"""Logical-axis sharding rules with the divisibility fallback
(``repro.sharding.axes``).

Every parameter and cache leaf is annotated with *logical* axis names
("embed", "heads", "mlp", ...). A rule set maps logical names to mesh
axes; ``resolve_spec`` turns annotations into a spec for concrete dims,
*dropping* any mapping whose mesh-axis product does not divide the dim
(the dim is then replicated), and the drops are reported
(``summarize_dropped``) so that GQA KV replication and other fallbacks are
visible.

A spec is a plain tuple with one entry per leading dim: ``None``
(replicated), a mesh-axis name, or a tuple of names (the dim split over
their product, the first axis major); trailing ``None`` entries are
trimmed, as the reference trims its ``PartitionSpec``. A mesh is anything
that names its axes and their sizes: a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names``,
``shape``), a ``{name: size}`` mapping, or an object with the reference's
``axis_names`` and ``devices.shape``.

The reference's ``logical_constraint`` (a ``with_sharding_constraint``
under GSPMD) has no counterpart here: the port runs one program per rank
(SPMD by hand), each rank already holds its local shard of every tensor,
and the collectives are explicit in the model code
(``sharding.plan.ShardPlan``). ``local_slice`` cuts a full tensor to one
rank's shard of a spec.

Rule sets:
  BASELINE_RULES - data parallelism over (pod, data), tensor parallelism
    over "model" (heads / mlp / vocab), experts over "data", parameters
    otherwise replicated.
  FSDP_RULES - parameters additionally sharded over the data axis (experts
    over data and pod), activations and decode KV sequence-sharded over
    "model".
  SP_RULES - weights replicated, activations sequence-sharded over
    "model" (vocab still over "model", experts over "data").
  DP_RULES - the batch over every mesh axis, everything else replicated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Any, Dict, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import torch

LogicalAxes = Tuple[Optional[str], ...]
SpecEntry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[SpecEntry, ...]


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Ordered mapping logical axis -> tuple of mesh axes."""

    name: str
    rules: Tuple[Tuple[str, Tuple[str, ...]], ...]

    def lookup(self, logical: str) -> Tuple[str, ...]:
        for key, mesh_axes in self.rules:
            if key == logical:
                return mesh_axes
        return ()


BASELINE_RULES = AxisRules(
    name="baseline_dp_tp",
    rules=(
        ("batch", ("pod", "data")),
        ("seq", ()),
        ("embed", ()),
        ("heads", ("model",)),
        ("kv_heads", ("model",)),
        ("head_dim", ()),
        ("mlp", ("model",)),
        ("vocab", ("model",)),
        ("expert", ("data",)),
        ("expert_mlp", ("model",)),
        ("exp_cap", ("data",)),  # capacity-parallel fallback for small E
        ("kv_seq", ()),
        ("conv", ()),
        ("state", ()),
    ),
)

FSDP_RULES = AxisRules(
    name="fsdp_tp_sp",
    rules=(
        ("batch", ("pod", "data")),
        ("seq", ()),
        ("act_seq", ("model",)),  # sequence parallelism for activations
        ("embed", ()),
        ("heads", ("model",)),
        ("kv_heads", ("model",)),
        ("head_dim", ()),
        ("mlp", ("model",)),
        ("vocab", ("model",)),
        ("expert", ("data", "pod")),
        ("expert_mlp", ("model",)),
        ("exp_cap", ("data",)),  # capacity-parallel fallback for small E
        ("kv_seq", ("model",)),  # decode KV sequence-sharded over model
        ("conv", ()),
        ("state", ()),
    ),
)

SP_RULES = AxisRules(
    name="sp_only",
    rules=(
        ("batch", ("pod", "data")),
        ("seq", ()),
        ("act_seq", ("model",)),
        ("embed", ()),
        ("heads", ()),
        ("kv_heads", ()),
        ("head_dim", ()),
        ("mlp", ()),
        ("vocab", ("model",)),
        ("expert", ("data",)),
        ("expert_mlp", ()),
        ("exp_cap", ()),
        ("kv_seq", ("model",)),
        ("conv", ()),
        ("state", ()),
    ),
)

DP_RULES = AxisRules(
    name="dp_pure",
    rules=(
        ("batch", ("pod", "data", "model")),
        ("seq", ()),
        ("embed", ()),
        ("heads", ()),
        ("kv_heads", ()),
        ("head_dim", ()),
        ("mlp", ()),
        ("vocab", ()),
        ("expert", ()),
        ("expert_mlp", ()),
        ("exp_cap", ()),
        ("kv_seq", ()),
        ("conv", ()),
        ("state", ()),
    ),
)

RULE_SETS: Dict[str, AxisRules] = {
    r.name: r for r in (BASELINE_RULES, FSDP_RULES, SP_RULES, DP_RULES)
}


def axis_sizes(mesh: Any) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh, a mapping, or an object with
    ``axis_names`` and ``devices.shape``."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return dict(zip(mesh.axis_names, (int(s) for s in mesh.devices.shape)))


def resolve_spec(logical_axes: LogicalAxes, dims: Sequence[int], mesh: Any,
                 rules: AxisRules,
                 dropped: Optional[List[Tuple[str, int]]] = None) -> Spec:
    """Resolve logical annotations to a spec for concrete ``dims``.

    A mapping is applied only if (a) every mesh axis exists in the mesh,
    (b) their product divides the dim, and (c) no mesh axis is already
    used by an earlier dim. Otherwise the dim is replicated and the drop
    recorded in ``dropped``."""
    if len(logical_axes) != len(dims):
        raise ValueError(
            f"logical axes {logical_axes} rank != shape {tuple(dims)}")
    sizes = axis_sizes(mesh)
    used: set = set()
    entries: List[Optional[Tuple[str, ...]]] = []
    for logical, dim in zip(logical_axes, dims):
        if logical is None:
            entries.append(None)
            continue
        mesh_axes = [a for a in rules.lookup(logical) if a in sizes]
        mesh_axes = [a for a in mesh_axes if a not in used]
        # largest subset of the mapping that divides the dim (greedy in
        # rule order; non-dividing axes are skipped, not fatal)
        chosen: List[str] = []
        prod = 1
        for a in mesh_axes:
            if dim % (prod * sizes[a]) == 0:
                chosen.append(a)
                prod *= sizes[a]
        if chosen:
            used.update(chosen)
            entries.append(tuple(chosen))
        else:
            if rules.lookup(logical) and dropped is not None:
                dropped.append((logical, dim))
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(e if e is None else (e[0] if len(e) == 1 else e)
                 for e in entries)


def summarize_dropped(dropped: Sequence[Tuple[str, int]], mesh: Any,
                      rules: AxisRules) -> List[str]:
    """Dedupe and render the ``dropped`` list that resolve_spec appends to
    as fallback lines, e.g.
    ``kv_heads=2 not divisible by mesh axes ('model',)=4 -> replicated``."""
    sizes = axis_sizes(mesh)
    lines: List[str] = []
    for logical, dim in dict.fromkeys(dropped):  # dedupe, keep order
        axes = tuple(a for a in rules.lookup(logical) if a in sizes)
        prod = math.prod(sizes[a] for a in axes) if axes else 1
        lines.append(
            f"{logical}={dim} not divisible by mesh axes {axes}={prod}"
            " -> replicated")
    return lines


def _is_logical(x: Any) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_shardings(tree_logical: Any, tree_shapes: Any, mesh: Any,
                   rules: AxisRules,
                   dropped: Optional[List[Tuple[str, int]]] = None) -> Any:
    """A nested dict of logical-axes tuples and a matching one of shapes
    -> the nested dict of specs."""
    if _is_logical(tree_logical):
        return resolve_spec(tree_logical, tuple(tree_shapes), mesh, rules,
                            dropped)
    return {k: tree_shardings(v, tree_shapes[k], mesh, rules, dropped)
            for k, v in tree_logical.items()}


def spec_axes(entry: SpecEntry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape: Sequence[int], spec: Spec,
                sizes: Mapping[str, int]) -> Tuple[int, ...]:
    """The shape of one rank's shard of a tensor of ``shape`` under
    ``spec``."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        for a in spec_axes(entry):
            out[dim] //= sizes[a]
    return tuple(out)


def local_slice(x: torch.Tensor, spec: Spec, sizes: Mapping[str, int],
                coords: Mapping[str, int]) -> torch.Tensor:
    """The shard of the full tensor ``x`` that the rank at mesh
    coordinates ``coords`` holds under ``spec`` (a contiguous copy when
    any dim is cut; ``x`` itself otherwise)."""
    out = x
    local = local_shape(x.shape, spec, sizes)
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if not axes:
            continue
        idx = 0
        for a in axes:  # the first axis major
            idx = idx * sizes[a] + coords[a]
        out = out.narrow(dim, idx * local[dim], local[dim])
    return out.contiguous() if out is not x else out
