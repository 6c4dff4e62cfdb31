"""Serving on a (data, model) mesh, one process per rank: the body every
rank runs, shared by the launcher (``--mesh``), the tests and the chip
smoke test.

``serve_on_mesh(jobs, mesh, device)`` starts D*M ranks
(sharding.comm.run_ranks), each joining the mesh through a file store;
for each job in turn every rank builds the engine with the mesh, gets its
parameter shards, runs the requests ``runs`` times on that engine (a
second run hits the prefix cache) and returns its tokens, the engine's
counters, the kernels' launch counts and its wall times. One start-up
serves several jobs. No CUDA tensor crosses a process boundary: a job
carries either the parameters as numpy arrays (small models) or a seed
and a dtype, from which each rank builds its shards leaf by leaf on its
device (``ServeEngine.local_params``); ranks that share a card build in
turn, so one full leaf at most is on it at a time.

A job is a dict of plain data:

  arch, smoke (bool), overrides (ModelConfig fields, e.g. n_layers),
  rules, compute_dtype, cache_dtype (None | "bfloat16" | "int8"),
  q_chunk, moe_dispatch, engine (ServeEngine keyword arguments),
  requests (a list of {rid, prompt, max_new, arrival}), runs, params
  (numpy tree or None), seed, param_dtype.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.registry import get_arch, get_smoke
from repro_torch.kernels import decode_attention, moe_gemm
from repro_torch.models.blocks import ModelContext
from repro_torch.models.params import params_from_numpy
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import Request
from repro_torch.sharding.comm import init_rank, make_mesh, run_ranks

# the kernels of the paged attention and MoE stacks, with their counts
_KERNEL_MODULES = (decode_attention, moe_gemm)


def _launches() -> Dict[str, int]:
    out: Dict[str, int] = {}
    for mod in _KERNEL_MODULES:
        out.update(mod.launches)
    return out


def serve_rank(rank: int, world: int, store: str, spec: Dict[str, Any]
               ) -> List[Dict[str, Any]]:
    """One rank of ``serve_on_mesh``: joins the mesh, runs every job of
    ``spec["jobs"]``; returns one result dict a job."""
    dev = init_rank(rank, world, store, torch.device(spec["device"]),
                    timeout_s=spec.get("timeout_s", 120.0))
    if dev.type == "cpu":
        torch.set_num_threads(spec.get("threads", 1))
    meshes: Dict[Tuple[int, int], Any] = {}
    out = []
    for job in spec["jobs"]:
        if "task" in job:
            out.append(_task(job["task"])(
                rank=rank, world=world, device=dev,
                **job.get("kwargs", {})))
        else:
            shape = tuple(job.get("mesh", spec["mesh"]))
            if shape not in meshes:
                meshes[shape] = make_mesh(shape, dev)
            out.append(_serve_job(rank, world, dev, meshes[shape], job))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _task(name: str):
    """The function a "module:function" name names."""
    import importlib
    mod, fn = name.split(":")
    return getattr(importlib.import_module(mod), fn)


def _serve_job(rank: int, world: int, dev: torch.device, mesh,
               job: Dict[str, Any]) -> Dict[str, Any]:
    import torch.distributed as dist

    cfg = get_smoke(job["arch"]) if job.get("smoke") else \
        get_arch(job["arch"])
    if job.get("overrides"):
        cfg = dataclasses.replace(cfg, **job["overrides"])
    cache = job.get("cache_dtype")
    ctx = ModelContext(
        compute_dtype=getattr(torch, job.get("compute_dtype", "float32")),
        decode_cache_dtype=None if cache is None else getattr(torch, cache),
        q_chunk=job.get("q_chunk", 64), device=dev,
        moe_dispatch=job.get("moe_dispatch", "grouped"))
    engine = ServeEngine(cfg, ctx, mesh=mesh,
                         rules=job.get("rules", "baseline_dp_tp"),
                         **job.get("engine", {}))
    report_built = engine.sharding_report
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    if job.get("params") is not None:
        params = engine.shard_params(params_from_numpy(job["params"],
                                                       device=dev))
    else:
        dtype = getattr(torch, job.get("param_dtype", "float32"))
        shared = dev.type == "cuda" and torch.cuda.device_count() < world
        params = None
        for turn in range(world) if shared else (rank,):
            if turn == rank:
                params = engine.local_params(job.get("seed", 0), dtype)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                    torch.cuda.empty_cache()
            if shared:
                dist.barrier()
    init_s = time.perf_counter() - t0
    local_bytes = sum(p.numel() * p.element_size()
                      for p in _leaves(params))
    runs: List[Dict[str, Any]] = []
    for _ in range(job.get("runs", 1)):
        reqs = [Request(rid=r["rid"], prompt=np.asarray(r["prompt"]),
                        max_new=r["max_new"], arrival=r.get("arrival", 0))
                for r in job["requests"]]
        for mod in _KERNEL_MODULES:
            mod.reset_launches()
        dist.barrier()
        t0 = time.perf_counter()
        out = engine.run(params, reqs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        runs.append({
            "tokens": {rid: v.tolist() for rid, v in out.items()},
            "wall_s": wall, "launches": _launches(),
            "counters": dict(engine.counters.items()),
            "prefix_hit_rate": engine.prefix_hit_rate,
            "kv": dict(engine.kv.counters),
            "stats": dict(engine.scheduler.stats),
            "transfer": engine.transfer_stats(),
            "faults": dict(engine.fault_stats.items()),
        })
    dist.barrier()
    plan = engine.ctx.plan
    result = {"rank": rank, "coords": plan.coords,
              "report_built": report_built,
              "report": engine.sharding_report, "runs": runs,
              "init_s": init_s, "local_param_bytes": local_bytes,
              "kv_local": plan.kv_local, "kv_mode": plan.kv_mode,
              "h_local": plan.h_local, "expert_local": plan.expert_local,
              "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else 0)}
    del engine, params
    return result


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def serve_on_mesh(jobs: Sequence[Dict[str, Any]], mesh: Tuple[int, int],
                  device: str = "cuda", *, timeout_s: float = 120.0,
                  threads: int = 1, store_dir: Optional[str] = None
                  ) -> List[List[Dict[str, Any]]]:
    """Run ``jobs`` in turn on a (D, M) ``mesh`` of D*M ranks on
    ``device`` ("cpu" or "cuda"; ranks beyond the cards share them).
    Returns ``res[rank][job]``. Raises when a rank fails, the run passes
    ``timeout_s``, or the ranks' tokens differ."""
    d, m = mesh
    spec = {"mesh": (d, m), "device": device, "timeout_s": timeout_s,
            "threads": threads, "jobs": list(jobs)}
    res = run_ranks(serve_rank, d * m, (spec,), timeout_s=timeout_s,
                    store_dir=store_dir)
    for r in res[1:]:
        for j, (a, b) in enumerate(zip(res[0], r)):
            if "task" in jobs[j]:
                continue
            for i, (ra, rb) in enumerate(zip(a["runs"], b["runs"])):
                if ra["tokens"] != rb["tokens"]:
                    raise AssertionError(
                        f"job {j} run {i}: rank {b['rank']}'s tokens "
                        f"differ from rank 0's")
    return res


def request_dicts(reqs) -> List[Dict[str, Any]]:
    """Requests as plain data for a job."""
    return [{"rid": r.rid, "prompt": np.asarray(r.prompt).tolist(),
             "max_new": r.max_new, "arrival": r.arrival} for r in reqs]
