"""Train-step factory (``repro.train.step``): microbatched gradient
accumulation, clipping, optimizer.

The step takes the parameters as fp32 leaves (``accum_dtype``), so the
gradients and their accumulation are fp32 while the forward casts to the
compute dtype at use, as the reference does. Microbatches run one
backward each with their loss scaled by 1/n, accumulating into the same
gradient buffers; the reference's scan-AD sums the same terms. The state
is updated in place (the reference donates it): after the call, the
given state holds the new parameters, optimizer state and step.

The step never waits for the device: the batch is copied from pinned host
memory without blocking, and the metrics it returns are device scalars
(the trainer's ``float(loss)`` is the one host sync per step, as in the
reference).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import api
from repro_torch.models.blocks import ModelContext
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import init_params, tree_map
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    microbatches: int = 1
    grad_clip: float = 1.0
    accum_dtype: torch.dtype = torch.float32


def _batch_axis(key: str) -> int:
    return 1 if key == "positions" else 0


def split_microbatches(batch: Dict[str, Tensor], n: int
                       ) -> Dict[str, Tensor]:
    """Reshape each entry's batch axis B -> (n, B/n), microbatch axis
    front."""
    out = {}
    for key, val in batch.items():
        ax = _batch_axis(key)
        b = val.shape[ax]
        if b % n:
            raise ValueError(f"batch {b} not divisible by {n} microbatches")
        v = val.reshape(val.shape[:ax] + (n, b // n) + val.shape[ax + 1:])
        out[key] = torch.movedim(v, ax, 0)
    return out


def init_train_state(seed: int, cfg: ModelConfig, optimizer: Optimizer,
                     param_dtype: torch.dtype = torch.float32,
                     device: DeviceLike = None) -> Dict[str, Any]:
    dev = resolve_device(device)
    params = init_params(api.model_specs(cfg), seed, param_dtype, dev)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _to_device(batch: Dict[str, Any], device: torch.device
               ) -> Dict[str, Tensor]:
    """numpy or host arrays -> device tensors, copied without blocking."""
    out = {}
    for key, val in batch.items():
        t = torch.from_numpy(np.asarray(val)) if not isinstance(
            val, torch.Tensor) else val
        if t.device != device:
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            else:
                t = t.to(device)
        out[key] = t
    return out


def make_train_step(cfg: ModelConfig, ctx: ModelContext,
                    optimizer: Optimizer,
                    settings: TrainSettings = TrainSettings()
                    ) -> Callable[[Dict[str, Any], Dict[str, Any]],
                                  Tuple[Dict[str, Any], Dict[str, Tensor]]]:
    n = settings.microbatches

    def train_step(state, batch):
        batch = _to_device(batch, ctx.device)
        # accum-dtype leaves that require grad; fp32 parameters alias them
        params_acc = tree_map(
            lambda p: p.detach().to(settings.accum_dtype).requires_grad_(),
            state["params"])
        if n == 1:
            loss, m = api.loss_fn(params_acc, batch, cfg, ctx)
            loss.backward()
            metrics = {key: m[key].detach()
                       for key in ("loss", "xent", "tokens")}
        else:
            sums = []
            mbs = split_microbatches(batch, n)
            for i in range(n):
                mb = {key: val[i] for key, val in mbs.items()}
                loss, m = api.loss_fn(params_acc, mb, cfg, ctx)
                (loss / n).backward()
                sums.append((m["loss"].detach() / n, m["xent"].detach() / n,
                             m["tokens"].detach()))
            metrics = {key: torch.stack([s[j] for s in sums]).sum()
                       for j, key in enumerate(("loss", "xent", "tokens"))}
        grads, gnorm = clip_by_global_norm(
            tree_map(lambda p: p.grad, params_acc), settings.grad_clip)
        optimizer.update(grads, state["opt"], state["params"],
                         state["step"])
        state["step"] = state["step"] + 1
        metrics["grad_norm"] = gnorm.detach()
        return state, metrics

    return train_step

