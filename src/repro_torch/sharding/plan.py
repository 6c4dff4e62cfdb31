"""One rank's share of a model on a (data, model) serving mesh, and the
collectives the model code makes explicit (the reference gets them from
GSPMD).

``ShardPlan.build`` resolves every parameter leaf with the rules
(``resolve_spec``), keeping the dropped rules for the engine's report,
then fixes the attention split with the paged partition
(``kernels.ops.paged_partition``):

  * query heads (wq, bq, wo) over "model" when the rules and the
    partition both split them; the o-projection is then row-parallel and
    its partial sums are added over "model";
  * KV heads: sharded with the query heads when they divide the axis
    ("split"); otherwise, with split query heads, K/V are projected with
    the replicated weights and each rank keeps its group-aligned block
    (``local_kv_block``; "slice"), the block its page pool holds; with
    unsplit heads every rank holds all of them ("full");
  * the dense FFN's "mlp" over "model" per the rules: gate/up
    column-parallel, down row-parallel, then a sum over "model";
  * "vocab" over "model" per the rules: a masked local embedding lookup
    summed over "model", and the lm head's local logits gathered over
    "model" before the pick, so every rank picks the same token;
  * experts over "data" per the rules (E divisible): tokens replicated,
    tile ids remapped to the local block, the down rows summed over
    "data" before the combine (models/moe.py through
    ``kernels.ops.grouped_matmul``). Experts stay whole over "model", as
    the reference's expert-parallel ``shard_map`` keeps them.

Every decode slot runs on every "data" rank: "data" carries the experts
only (see serve/engine.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.kernels.ops import local_kv_block, paged_partition
from repro_torch.models.params import ParamSpec, init_params
from repro_torch.sharding.axes import (AxisRules, Spec, axis_sizes,
                                       local_shape, local_slice, resolve_spec,
                                       spec_axes)
from repro_torch.sharding.comm import all_gather_cat, all_reduce_sum

Tensor = torch.Tensor


def _walk(tree: Any, fn, path: str = "") -> Any:
    """``fn(path, leaf)`` over a ParamSpec tree in sorted key order (the
    reference's pytree order, so dropped rules are recorded in its
    order)."""
    if isinstance(tree, ParamSpec):
        return fn(path, tree)
    return {k: _walk(tree[k], fn, f"{path}/{k}" if path else k)
            for k in sorted(tree)}


@dataclasses.dataclass
class ShardPlan:
    sizes: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Any]
    specs: Any  # nested dict of the leaves' local-slice specs
    shapes: Any  # nested dict of the leaves' full shapes
    dropped: List[Tuple[str, int]]  # rules the parameters dropped
    heads: bool = False
    h_local: int = 0
    kv_mode: str = "full"  # "split" | "slice" | "full"
    kv_start: int = 0
    kv_local: int = 0
    mlp: bool = False
    vocab: bool = False
    vocab_start: int = 0
    vocab_local: int = 0
    ep: int = 1
    expert_local: int = 0

    @classmethod
    def build(cls, cfg, spec_tree: Any, mesh: Any,
              rules: AxisRules) -> "ShardPlan":
        """This process's plan on the DeviceMesh ``mesh`` for the
        parameter ParamSpec tree ``spec_tree`` of ``cfg``."""
        sizes = axis_sizes(mesh)
        coords = {a: mesh.get_local_rank(a) for a in sizes}
        groups = {a: mesh.get_group(a) for a in sizes}
        m = sizes.get("model", 1)
        h, kv = cfg.n_heads, cfg.n_kv_heads
        _, hm, kvm, _, _ = paged_partition(sizes, "data", "model", 1, h, kv)
        dropped: List[Tuple[str, int]] = []
        flags: Dict[str, Tuple[str, ...]] = {}

        def resolve(path: str, ps: ParamSpec) -> Spec:
            spec = resolve_spec(ps.logical, ps.shape, mesh, rules, dropped)
            for logical, entry in zip(ps.logical, spec):
                if logical and entry is not None:
                    flags.setdefault(logical, spec_axes(entry))
            return spec

        raw = _walk(spec_tree, resolve)
        heads = hm is not None and flags.get("heads") == ("model",)
        kv_split = heads and kvm is not None and \
            flags.get("kv_heads") == ("model",)
        kv_mode = "split" if kv_split else ("slice" if heads else "full")
        plan = cls(sizes=sizes, coords=coords, groups=groups,
                   specs=None, dropped=dropped,
                   shapes=_walk(spec_tree, lambda _, ps: tuple(ps.shape)))
        plan.heads = heads
        idx = coords.get("model", 0)
        plan.h_local = h // m if heads else h
        if kv_mode == "split":
            plan.kv_start, plan.kv_local = idx * (kv // m), kv // m
        elif kv_mode == "slice":
            plan.kv_start, plan.kv_local = local_kv_block(h, kv, m, idx)
        else:
            plan.kv_start, plan.kv_local = 0, kv
        plan.kv_mode = kv_mode
        for logical, axes in flags.items():
            if logical in ("mlp", "vocab") and axes != ("model",):
                raise NotImplementedError(
                    f"'{logical}' over {axes}: the port splits it over "
                    f"'model' only")
            if logical == "expert" and axes != ("data",):
                raise NotImplementedError(
                    f"'expert' over {axes}: the port splits experts over "
                    f"'data' only")
        plan.mlp = "mlp" in flags
        if "vocab" in flags:
            plan.vocab = True
            plan.vocab_local = cfg.vocab_size // m
            plan.vocab_start = idx * plan.vocab_local
        if "expert" in flags:
            plan.ep = sizes["data"]
            plan.expert_local = cfg.n_experts // plan.ep

        def local_spec(path: str, ps: ParamSpec) -> Spec:
            spec = list(_walk_get(raw, path))
            for i, logical in enumerate(ps.logical[:len(spec)]):
                if logical == "heads" and not heads:
                    spec[i] = None
                elif logical == "kv_heads" and kv_mode != "split":
                    spec[i] = None
                elif logical == "expert_mlp":
                    spec[i] = None  # experts whole over "model"
            while spec and spec[-1] is None:
                spec.pop()
            return tuple(spec)

        plan.specs = _walk(spec_tree, local_spec)
        return plan

    # ------------------------------------------------------- collectives

    def reduce(self, x: Tensor, axis: str) -> Tensor:
        """Sum of the ranks' partial ``x`` over ``axis``."""
        if self.sizes.get(axis, 1) == 1:
            return x
        return all_reduce_sum(x, self.groups[axis])

    def gather(self, x: Tensor, axis: str, dim: int) -> Tensor:
        """The ranks' ``x`` concatenated along ``dim`` over ``axis``."""
        if self.sizes.get(axis, 1) == 1:
            return x
        return all_gather_cat(x, self.groups[axis], dim)

    # ------------------------------------------------------- local views

    def slice_leaf(self, path: str, x: Tensor) -> Tensor:
        """The rank's shard of the full parameter leaf at ``path``. A leaf
        of exactly the shard's shape is taken as already cut and returned
        as it is; any other shape (a tree of another config, or one cut
        for another mesh) raises ValueError."""
        try:
            spec = _walk_get(self.specs, path)
            full = _walk_get(self.shapes, path)
        except KeyError:
            if not path.endswith("_scale"):
                raise
            # an int8 expert weight's (n_blocks, E) scales: cut as the
            # weight's leading dims
            base = path[:-len("_scale")]
            spec = _walk_get(self.specs, base)[:x.dim()]
            full = _walk_get(self.shapes, base)[:x.dim()]
        if tuple(x.shape) == tuple(full):
            return local_slice(x, spec, self.sizes, self.coords)
        local = local_shape(full, spec, self.sizes)
        if tuple(x.shape) != local:
            raise ValueError(f"{path}: shape {tuple(x.shape)} is neither the "
                             f"full {tuple(full)} nor this rank's shard "
                             f"{local}")
        return x

    def shard_tree(self, params: Any, prefix: str = "") -> Any:
        """The rank's shards of a full parameter tree."""
        if isinstance(params, dict):
            return {k: self.shard_tree(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in params.items()}
        return self.slice_leaf(prefix, params)

    def init_local(self, spec_tree: Any, seed: int, dtype: torch.dtype,
                   device) -> Any:
        """``init_params`` of the full tree, each leaf cut to this rank's
        shard as soon as it is built: the same values as the full tree's
        shards, without the full tree ever on the device."""
        return init_params(spec_tree, seed=seed, dtype=dtype, device=device,
                           transform=self.slice_leaf)

    def local_kv(self, k: Tensor, v: Tensor) -> Tuple[Tensor, Tensor]:
        """(B, T, KV, D) k/v projected with replicated weights -> this
        rank's KV-head block (the GQA fallback); unchanged otherwise."""
        if self.kv_mode != "slice":
            return k, v
        sl = slice(self.kv_start, self.kv_start + self.kv_local)
        return k[:, :, sl], v[:, :, sl]


def _walk_get(tree: Any, path: str) -> Any:
    for key in path.split("/"):
        tree = tree[key]
    return tree
