"""Optimizers (``repro.optim.optimizers``): AdamW and Adafactor over
nested-dict parameter trees.

State stays fp32. ``update`` writes the new parameters and state into the
given tensors in place, under ``torch.no_grad()``, where the reference
returns new trees (and donates the old ones); it returns the same trees.
Each leaf's new value is computed with the reference's operations in the
reference's order, then copied in.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.models.params import tree_items, tree_map

Tensor = torch.Tensor
Tree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree, Tensor], Tuple[Tree, Tree]]
    # update(grads, state, params, step) -> (params, state), in place


def _leaves(tree: Tree) -> List[Tensor]:
    """Leaves in sorted-key order (the reference's pytree order)."""
    return [x for _, x in tree_items(tree)]


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_fraction: float = 0.1
                    ) -> Callable[[Tensor], Tensor]:
    def lr(step: Tensor) -> Tensor:
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_fraction + (1 - final_fraction)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, Tensor]:
    """Scale every gradient by min(1, max_norm / global norm), in place.
    Returns (grads, global norm)."""
    gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in _leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    with torch.no_grad():
        for g in _leaves(grads):
            g.copy_(g.float() * scale)
    return grads, gn


def adamw(lr: Callable[[Tensor], Tensor], *, b1: float = 0.9,
          b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params: Tree) -> Tree:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        t = step.float() + 1.0
        lr_t = lr(step)
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)
        for g, m, v, p in zip(_leaves(grads), _leaves(state["m"]),
                              _leaves(state["v"]), _leaves(params)):
            gf = g.float()
            m.copy_(b1 * m + (1 - b1) * gf)
            v.copy_(b2 * v + (1 - b2) * gf * gf)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            pf = p.float()
            p.copy_(pf - lr_t * (delta + weight_decay * pf))
        return params, state

    return Optimizer(init, update)


def adafactor(lr: Callable[[Tensor], Tensor], *, decay: float = 0.8,
              eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0,
              min_dim_size_to_factor: int = 128) -> Optimizer:
    """Adafactor (Shazeer & Stern, 2018), beta1=None (no momentum)."""

    def factored(p: Tensor) -> bool:
        return (p.dim() >= 2 and p.shape[-1] >= min_dim_size_to_factor
                and p.shape[-2] >= min_dim_size_to_factor)

    def init(params: Tree) -> Tree:
        def leaf(p):
            kw = dict(dtype=torch.float32, device=p.device)
            if factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **kw),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **kw)}
            return {"v": torch.zeros(p.shape, **kw)}
        return tree_map(leaf, params)

    def _states(state: Tree, params: Tree) -> List[Dict[str, Tensor]]:
        """The per-leaf state dicts, in the parameters' leaf order."""
        if isinstance(params, dict):
            return [s for k in sorted(params)
                    for s in _states(state[k], params[k])]
        return [state]

    @torch.no_grad()
    def update(grads, state, params, step):
        t = step.float() + 1.0
        beta2 = 1.0 - torch.pow(t, -decay)
        lr_t = lr(step)
        for g, s, p in zip(_leaves(grads), _states(state, params),
                           _leaves(params)):
            gf = g.float()
            g2 = gf * gf + eps
            if factored(p):
                vr = beta2 * s["vr"] + (1 - beta2) * g2.mean(dim=-1)
                vc = beta2 * s["vc"] + (1 - beta2) * g2.mean(dim=-2)
                denom = (vr / torch.clamp(vr.mean(dim=-1, keepdim=True),
                                          min=eps))[..., None] \
                    * vc[..., None, :]
                upd = gf * torch.rsqrt(torch.clamp(denom, min=eps))
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
            else:
                v = beta2 * s["v"] + (1 - beta2) * g2
                upd = gf * torch.rsqrt(torch.clamp(v, min=eps))
                s["v"].copy_(v)
            # update clipping by RMS
            rms = torch.sqrt(torch.mean(upd * upd) + 1e-30)
            upd = upd / torch.clamp(rms / clip_threshold, min=1.0)
            pf = p.float()
            p.copy_(pf - lr_t * upd - lr_t * weight_decay * pf)
        return params, state

    return Optimizer(init, update)
