"""Task functions that the port's multi-rank tests run in each rank of a
gloo group (task jobs of ``repro_torch.serve.sharded.serve_on_mesh``).
They import torch and the port only, so a spawned rank starts without
JAX. Each is called as ``task(rank=, world=, device=, **kwargs)`` with
the default process group formed, and returns plain data."""

import numpy as np
import torch


def expert_parallel_gemm(*, rank, world, device, x, w, gids):
    """``ops.grouped_matmul`` over a (world, 1) mesh: this rank holds its
    contiguous block of the experts of ``w`` and the full output comes
    back from the sum over "data"."""
    from repro_torch.kernels import ops
    from repro_torch.sharding.comm import make_mesh
    mesh = make_mesh((world, 1), device)
    e_local = w.shape[0] // world
    wl = torch.from_numpy(w[rank * e_local:(rank + 1) * e_local].copy())
    out = ops.grouped_matmul(torch.from_numpy(x), wl,
                             torch.from_numpy(gids), impl="ref", mesh=mesh,
                             n_experts=w.shape[0])
    return out.numpy()


def expert_parallel_moe(*, rank, world, device, arch, x, seed):
    """One MoE layer of the smoke config through the grouped dispatch over
    a (world, 1) mesh, this rank holding its contiguous block of the
    layer's experts; returns the layer's output."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    from repro_torch.sharding.comm import make_mesh
    cfg = get_smoke(arch)
    mesh = make_mesh((world, 1), device)
    full = init_params(moe.moe_param_specs(cfg), seed=seed, device="cpu")
    e_local = cfg.n_experts // world
    params = {k: v if k == "router" else
              v[rank * e_local:(rank + 1) * e_local].clone()
              for k, v in full.items()}
    out, _ = moe.moe_ffn(params, torch.from_numpy(x), cfg, torch.float32,
                         dispatch="grouped", impl="ref", with_aux=False,
                         mesh=mesh)
    return out.numpy()


def compressed_means(*, rank, world, device, grads):
    """Three (or len(grads)) steps of the int8 error-feedback mean, this
    rank feeding ``grads[step][rank]``; returns each step's (mean,
    error state)."""
    from repro_torch.train import compress
    err = torch.zeros(grads[0][rank].shape, dtype=torch.float32)
    out = []
    for step in grads:
        mean, err = compress.compressed_mean_one(
            torch.from_numpy(step[rank]), err)
        out.append((mean.numpy(), err.numpy()))
    return out


def _linear_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = ((pred - batch["y"]) ** 2).mean()
    return loss, {"mse": loss.detach(), "y_mean": batch["y"].mean()}


def compressed_grads(*, rank, world, device, params, batches, steps):
    """``make_compressed_grad_fn`` of a linear least-squares loss, this
    rank on ``batches[rank]``, ``steps`` times with the error state
    carried; returns each step's loss, metrics, mean gradient and error
    state as numpy."""
    from repro_torch.train import compress
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    batch = {k: torch.from_numpy(v) for k, v in batches[rank].items()}
    fn = compress.make_compressed_grad_fn(_linear_loss)
    err = compress.init_error_state(tp)
    out = []
    for _ in range(steps):
        (loss, metrics), g, err = fn(tp, batch, err)
        out.append((float(loss), {k: float(v) for k, v in metrics.items()},
                    {k: v.numpy() for k, v in g.items()},
                    {k: v.numpy() for k, v in err.items()}))
    return out


def wire_bytes(*, rank, world, device, n_params):
    from repro_torch.train import compress
    return [compress.wire_bytes_per_step(n_params, world, c)
            for c in (True, False)]


def gloo_collectives(*, rank, world, device):
    """The collectives the port's mesh path issues, on this rank's
    device: all-reduce of f32 and bf16, all-gather of int8."""
    from repro_torch.sharding.comm import all_gather_cat, all_reduce_sum
    import torch.distributed as dist
    group = dist.group.WORLD
    x = torch.full((3,), float(rank + 1), device=device)
    s = all_reduce_sum(x.to(torch.bfloat16), group).float()
    g = all_gather_cat(torch.tensor([rank], dtype=torch.int8,
                                    device=device), group, 0)
    return s.cpu().numpy(), g.cpu().numpy().astype(np.int64)
