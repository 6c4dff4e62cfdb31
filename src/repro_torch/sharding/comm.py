"""Process groups, the serving mesh and the collectives of the port's
multi-rank paths.

The port runs one process per rank (SPMD by hand). ``run_ranks`` starts
them with ``torch.multiprocessing`` (the spawn start method) and joins
them through a file store, so parallel test workers never compete for a
port; ``init_rank`` forms the default process group:

  * the CPU: gloo;
  * the card, one card per rank (as many cards as ranks): NCCL;
  * the card, ranks sharing one card: gloo on CUDA tensors (NCCL refuses
    two ranks on one device). Gloo takes CUDA tensors for both
    collectives the port issues (all-reduce, all-gather), so no tensor of
    the model is moved to the host by the port's code to get round it.

``make_mesh`` builds the (data, model) ``DeviceMesh`` over the default
group, its sub-groups on the default group's backend.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

MESH_AXES = ("data", "model")


def backend_for(device: torch.device, world: int) -> str:
    """gloo on the CPU and for ranks that share a card; NCCL when every
    rank has a card of its own."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def rank_device(device: torch.device, rank: int) -> torch.device:
    """The rank's device: the CPU, or card ``rank % count``."""
    if device.type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_rank(rank: int, world: int, store: str, device: torch.device,
              timeout_s: float = 120.0) -> torch.device:
    """Join the default process group through the file store ``store``;
    returns the rank's device (set as the current CUDA device)."""
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend_for(device, world), init_method=f"file://{store}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def make_mesh(shape: Tuple[int, int], device: torch.device):
    """The (data, model) DeviceMesh over the default process group. On
    the card over gloo (ranks sharing it), the mesh's sub-groups are built
    on gloo too, where DeviceMesh would pick NCCL for "cuda"."""
    import inspect
    from torch.distributed.device_mesh import init_device_mesh
    kw = {}
    if device.type == "cuda" and dist.get_backend() == "gloo" and \
            "backend_override" in inspect.signature(init_device_mesh
                                                    ).parameters:
        kw["backend_override"] = {a: "gloo" for a in MESH_AXES}
    return init_device_mesh("cuda" if device.type == "cuda" else "cpu",
                            tuple(shape), mesh_dim_names=MESH_AXES, **kw)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the group, added in f32 and returned in x's
    dtype (one rounding of a bf16 sum, where bf16 adds would round at
    every rank)."""
    y = x.float().contiguous()
    if y.data_ptr() == x.data_ptr():
        y = y.clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _rank_main(fn: Callable, rank: int, world: int, store: str, out,
               args: Sequence[Any]) -> None:
    try:
        result = fn(rank, world, store, *args)
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    out.put((rank, True, result))


def run_ranks(fn: Callable, world: int, args: Sequence[Any] = (), *,
              timeout_s: float = 120.0,
              store_dir: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, world, store, *args)`` in ``world`` fresh processes
    and return their results in rank order. ``store`` is the path of the
    file store the ranks join through (``init_rank``), under
    ``store_dir`` or a new temporary directory. A rank that raises, or a
    run past ``timeout_s``, stops every rank and raises here. ``fn`` and
    ``args`` must pickle (a module-level function, plain data)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    base = store_dir or tempfile.mkdtemp(prefix="ranks_")
    store = os.path.join(base, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store, out, tuple(args)),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results: List[Any] = [None] * world
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=timeout_s)
    try:
        got = 0
        while got < world:
            left = (deadline - datetime.datetime.now()).total_seconds()
            if left <= 0:
                raise RuntimeError(
                    f"{world} ranks: no result within {timeout_s:.0f} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if not dead:
                    continue
                try:  # its report may still be in the pipe
                    rank, ok, value = out.get(timeout=2.0)
                except queue.Empty:  # died without one (e.g. at start-up)
                    raise RuntimeError(
                        f"rank {dead[0]} of {world} exited with code "
                        f"{procs[dead[0]].exitcode}") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                   f"{value}")
            results[rank] = value
            got += 1
        for p in procs:
            p.join(timeout=max(
                (deadline - datetime.datetime.now()).total_seconds(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
    return results
