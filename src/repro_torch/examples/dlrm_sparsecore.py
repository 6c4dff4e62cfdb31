"""DLRM-style recommendation model on the embedding-bag path (the port of
``examples/dlrm_sparsecore.py``).

Three embedding bags (the hand-written ``sparse_gather_sum`` kernel on the
card) feed a dense MLP tower, trained end to end with SGD on synthetic
click data whose label is the parity of the user indices' sum.

    PYTHONPATH=src python -m repro_torch.examples.dlrm_sparsecore
    PYTHONPATH=src python -m repro_torch.examples.dlrm_sparsecore \
        --device cpu --steps 20

The Pallas kernel has no backward and the reference trains through
``jax.grad`` of its oracle, so the kernel route is ``_EmbeddingBag``: the
kernel forward and the oracle's gradient backward. One forward and
backward per step gives both the logged loss and the gradient, so a run
launches the kernel 3 x steps times. Weights and batches are drawn on the
CPU from seeded generators and moved to the device, so every device
trains from the same numbers.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.sparse_gather import table_rows, wrap_negative

TABLES = {"user": (5000, 32), "item": (20000, 32), "cat": (200, 16)}
BAG = 4
MLP = [32 + 32 + 16, 64, 32, 1]
LR = 0.05
STEPS = 120
BATCH = 256

Tensor = torch.Tensor
Params = Dict[str, Tensor]


class _EmbeddingBag(torch.autograd.Function):
    """Forward through ``kops.sparse_gather_sum`` (the kernel for
    ``impl="cuda"``); backward in plain torch, as ``jax.grad`` of the
    reference's gather differentiates it: the table gradient is the
    weighted scatter-add of ``w[i,j] * g[i]`` into row ``idx[i,j]`` after
    a negative index wraps once, with an index still outside [0, V)
    dropped (the forward clamped it; the gradient does not), and the
    weight gradient is ``<table[row], g[i]>`` at the clamped row the
    forward read."""

    @staticmethod
    def forward(ctx, table, indices, weights, impl):
        ctx.save_for_backward(table, indices, weights)
        return kops.sparse_gather_sum(table, indices, weights, impl=impl)

    @staticmethod
    def backward(ctx, grad):
        table, indices, weights = ctx.saved_tensors
        v, d = table.shape
        g = grad.float()
        d_table = d_weights = None
        if ctx.needs_input_grad[0]:
            idx = wrap_negative(indices, v)
            keep = ((idx >= 0) & (idx < v)).flatten()
            rows = (weights.float()[..., None] * g[:, None, :]).reshape(-1, d)
            d_table = torch.zeros((v, d), dtype=torch.float32,
                                  device=table.device)
            d_table.index_add_(0, idx.flatten()[keep], rows[keep])
            d_table = d_table.to(table.dtype)
        if ctx.needs_input_grad[2]:
            gathered = table[table_rows(indices, v)].float()
            d_weights = (gathered * g[:, None, :]).sum(-1).to(weights.dtype)
        return d_table, None, d_weights, None


def init(generator: torch.Generator, device: DeviceLike = None) -> Params:
    """Tables normal(0.05), weights normal(a^-0.5), biases 0, drawn in
    order from ``generator`` on its own device, then moved to
    ``device``."""
    dev = resolve_device(device)
    gdev = generator.device
    params: Params = {}
    for name, (v, d) in TABLES.items():
        params[f"emb_{name}"] = torch.randn(
            (v, d), generator=generator, device=gdev) * 0.05
    for i, (a, b) in enumerate(zip(MLP[:-1], MLP[1:])):
        params[f"w{i}"] = torch.randn((a, b), generator=generator,
                                      device=gdev) * (a ** -0.5)
        params[f"b{i}"] = torch.zeros((b,), device=gdev)
    return {k: p.to(dev) for k, p in params.items()}


def make_batch(generator: torch.Generator, n: int = BATCH,
               device: DeviceLike = None) -> Dict[str, Tensor]:
    """Uniform int32 indices drawn from ``generator`` on its own device,
    bags of BAG with weights 1 / BAG, and the label idx_user.sum(-1) % 2,
    a signal the user table can learn; moved to ``device``."""
    dev = resolve_device(device)
    batch: Dict[str, Tensor] = {}
    for name, (v, _) in TABLES.items():
        batch[f"idx_{name}"] = torch.randint(
            0, v, (n, BAG), generator=generator, device=generator.device,
            dtype=torch.int32).to(dev)
        batch[f"w_{name}"] = torch.ones((n, BAG), device=dev) / BAG
    batch["label"] = (batch["idx_user"].sum(-1) % 2).float()
    return batch


def forward(params: Params, batch: Dict[str, Tensor], impl: str) -> Tensor:
    """Logits (N,): the three bags concatenated, then the MLP tower."""
    feats = [_EmbeddingBag.apply(params[f"emb_{name}"], batch[f"idx_{name}"],
                                 batch[f"w_{name}"], impl)
             for name in TABLES]
    x = torch.cat(feats, dim=-1)
    n = len(MLP) - 1
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    return x[:, 0]


def loss_fn(params: Params, batch: Dict[str, Tensor], impl: str) -> Tensor:
    """The reference's stable logistic loss, written as it writes it."""
    logits = forward(params, batch, impl)
    y = batch["label"]
    return torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                      - logits * y + torch.log1p(torch.exp(-logits.abs())))


def sgd_step(params: Params, batch: Dict[str, Tensor], impl: str,
             lr: float = LR) -> Tuple[Params, Tensor]:
    """One forward and backward: returns (params - lr * grad, the loss at
    the params given)."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    loss = loss_fn(leaves, batch, impl)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    new = {k: (p - lr * g).detach()
           for (k, p), g in zip(leaves.items(), grads)}
    return new, loss.detach()


def train(params: Params, steps: int, *, impl: str,
          device: DeviceLike = None) -> Tuple[Params, List[float]]:
    """``steps`` SGD steps on the batches of CPU generators seeded 100,
    101, ... (the reference's keys); returns the final params and each
    step's loss."""
    dev = resolve_device(device)
    losses = []
    for i in range(steps):
        gen = torch.Generator()
        gen.manual_seed(100 + i)
        params, loss = sgd_step(params, make_batch(gen, BATCH, dev), impl)
        losses.append(loss)
    return params, [float(x) for x in losses]


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' on request)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    impl = "cuda" if dev.type == "cuda" else "ref"
    gen = torch.Generator()
    gen.manual_seed(0)
    params = init(gen, dev)
    t0 = time.perf_counter()
    _, losses = train(params, args.steps, impl=impl, device=dev)
    print(f"DLRM embedding-bag training: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} in {time.perf_counter() - t0:.1f}s")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses[0]} -> "
                             f"{losses[-1]}")
    print("OK: SparseCore-path (gather/scatter) model trains")
    return losses


if __name__ == "__main__":
    main()
