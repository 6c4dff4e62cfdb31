"""Parameter specification and initialization (``repro.models.params``).

A model is a nested dict of ``ParamSpec`` leaves. ``init_params`` draws
every leaf from its own ``torch.Generator`` seeded from the run seed and
the leaf's path, so full-width weights are made on the card without JAX.
``params_from_numpy`` is the weight bridge: it turns the JAX reference's
parameter tree (as numpy arrays) into the port's tensors, path for path,
keeping the stacked leading ``n_blocks`` axis of ``blocks.stack_specs``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Initializer = Callable[[torch.Generator, Tuple[int, ...], torch.dtype,
                        torch.device], torch.Tensor]
Tree = Dict[str, Any]


def normal_init(stddev: float = 0.02) -> Initializer:
    def init(gen, shape, dtype, device):
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (x * stddev).to(dtype)
    return init


def zeros_init() -> Initializer:
    def init(gen, shape, dtype, device):
        return torch.zeros(shape, dtype=dtype, device=device)
    return init


def ones_init() -> Initializer:
    def init(gen, shape, dtype, device):
        return torch.ones(shape, dtype=dtype, device=device)
    return init


def constant_init(value: float) -> Initializer:
    def init(gen, shape, dtype, device):
        return torch.full(shape, value, dtype=dtype, device=device)
    return init


def uniform_init(lo: float, hi: float) -> Initializer:
    def init(gen, shape, dtype, device):
        x = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device)
        return (lo + (hi - lo) * x).to(dtype)
    return init


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: Initializer = dataclasses.field(default_factory=normal_init)
    dtype: Optional[torch.dtype] = None  # None -> model default

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.logical):
            raise ValueError(
                f"shape {self.shape} rank != logical {self.logical}")


# -- nested-dict trees ------------------------------------------------------


def tree_items(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) for every leaf of a nested dict, in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_index(tree: Any, i: int) -> Any:
    """Slice every leaf of a stacked tree at index ``i`` of its leading
    axis (one layer's parameters or pages; views, no copies)."""
    return tree_map(lambda x: x[i], tree)


def unstack(tree: Any, n: int) -> List[Any]:
    """Per-layer views of a stacked tree: one ``unbind`` per leaf, whose
    backward stacks the layers' gradients in a single copy (indexing
    layer by layer would add a full stacked-size zero tensor per layer)."""
    if isinstance(tree, dict):
        subs = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: subs[k][i] for k in subs} for i in range(n)]
    return list(tree.unbind(0))


def _fold_path(seed: int, path: str) -> int:
    """32-bit generator seed of one leaf: FNV-1a over the run seed's
    bytes then the path (the CPU generator keeps only 32 seed bits)."""
    h = 2166136261
    for ch in seed.to_bytes(8, "little", signed=True) + path.encode():
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return h


def init_params(spec_tree: Tree, seed: int = 0,
                dtype: torch.dtype = torch.float32,
                device: DeviceLike = None) -> Tree:
    """Materialize parameters on ``device`` (the card unless the caller
    asks for the CPU); each leaf draws from a generator seeded by the
    run seed and its path."""
    dev = resolve_device(device)

    def build(path: str, spec: ParamSpec) -> torch.Tensor:
        gen = torch.Generator(device=dev)
        gen.manual_seed(_fold_path(seed, path))
        return spec.init(gen, spec.shape, spec.dtype or dtype, dev)

    def walk(node: Any, prefix: str) -> Any:
        if isinstance(node, ParamSpec):
            return build(prefix, node)
        return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                for k, v in node.items()}

    return walk(spec_tree, "")


def params_from_numpy(tree: Tree, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Tree:
    """The weight bridge: a nested dict of numpy arrays (the JAX
    reference's ``init_params`` tree after ``np.asarray``) becomes the
    port's tensors by path, shapes unchanged (stacked expert leaves stay
    (n_blocks, E, D, F)). ``dtype`` casts floating leaves; integer leaves
    (int8 expert weights) keep theirs, and so do the f32 ``<name>_scale``
    leaves that dequantize them."""
    dev = resolve_device(device)

    def walk(node: Any, key: str) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        t = torch.from_numpy(np.array(node, copy=True))
        if dtype is not None and t.is_floating_point() \
                and not key.endswith("_scale"):
            t = t.to(dtype)
        return t.to(dev)

    return walk(tree, "")
