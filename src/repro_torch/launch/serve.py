"""Serving launcher of the port: the engine over a request trace, on the
paged KV backend where the family supports it (dense caches otherwise),
as the reference launcher picks it.

Two modes, as ``repro.launch.serve``:

  * default: one batch of identical-length prompts through ``generate``;
  * ``--trace N``: N requests with seeded arrivals and lengths drained by
    the continuous-batching scheduler, reporting tokens/s, host syncs and
    the prefix-cache hit rate.

Weights are random, made from ``--seed`` on the device. Compute is f32, as
in the reference driver, unless ``--dtype bfloat16``. The device is the card
unless ``--device cpu``. ``--profile`` runs the serve under
``torch.profiler`` and prints the device-busy share of that run's wall
time and the operations that took the most device time.

Resilience, as the reference launcher: ``--bist`` runs the startup self-test
(FBIST golden patterns through the matmul kernel, one golden pattern
through the paged-decode kernel) on the serving device and refuses to
serve on a mismatch; ``--chaos SEED`` turns on the deterministic fault
schedule; ``--ttft-deadline`` and ``--spec-off-depth`` turn on SLO
admission; ``--quantize`` stores the weights in fp8 (or int8, a storage
demo that zeroes nearly every weight).

Multi-device, as the reference launcher: ``--mesh D,M`` serves on a
(data, model) mesh of D*M ranks, which the launcher starts itself (one
process each, ``torch.multiprocessing``, joined through a file store in a
temporary directory); rank 0 prints. ``--rules`` names the AxisRules set.
The ranks talk over gloo on the CPU, NCCL when every rank has a card of
its own, and gloo on CUDA tensors when ranks share a card (NCCL refuses
two ranks on one device): ``--mesh 1,2`` on one card runs two ranks on
it. Each rank builds its own parameter shards from ``--seed``.
``--disaggregate`` turns on prefill/decode disaggregation with
``--prefill-workers`` modeled workers handing pages over a modeled
``--link`` (ici | dcn); ``--chaos`` then also kills prefill workers and
drops page transfers.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b \
      --smoke --trace 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b \
      --smoke --trace 8 --bist --chaos 7 --ttft-deadline 64 \
      --spec-off-depth 2 --draft-k 2 --quantize fp8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral_8x22b \
      --smoke --trace 4 --device cpu [--moe-dispatch capacity]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_1_6b \
      --smoke --trace 4 --device cpu        # or --arch jamba_v01_52b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b \
      --smoke --trace 8 --device cpu --mesh 1,2 --disaggregate \
      --prefill-workers 2 --link dcn
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.registry import get_arch, get_smoke
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.blocks import ModelContext
from repro_torch.obs.trace import SpanTracer
from repro_torch.serve.admission import AdmissionController, AdmissionPolicy
from repro_torch.serve.engine import ServeEngine, quantize_weights
from repro_torch.serve.faults import FaultInjector, FaultPlan, startup_bist
from repro_torch.serve.scheduler import Request
from repro_torch.sharding.axes import RULE_SETS


def make_trace(n: int, vocab: int, seed: int, *, prompt_lo=8, prompt_hi=32,
               new_lo=8, new_hi=24, mean_gap=3) -> List[Request]:
    """Deterministic multi-user arrival trace (geometric inter-arrivals),
    the same draws as ``repro.launch.serve.make_trace``."""
    prompt_lo = min(prompt_lo, prompt_hi)
    new_lo = min(new_lo, new_hi)
    rng = np.random.default_rng(seed)
    reqs, t = [], 0
    for rid in range(n):
        t += int(rng.geometric(1.0 / max(mean_gap, 1)) - 1)
        reqs.append(Request(
            rid=rid,
            prompt=rng.integers(0, vocab, int(rng.integers(prompt_lo,
                                                           prompt_hi + 1))),
            max_new=int(rng.integers(new_lo, new_hi + 1)),
            arrival=t))
    return reqs


def slo_line(engine: ServeEngine) -> str:
    s = engine.slo_summary()
    return (f"slo: requests={s['requests']:.0f} "
            f"ttft p50={s['ttft_p50_s'] * 1e3:.1f}ms "
            f"p95={s['ttft_p95_s'] * 1e3:.1f}ms | "
            f"tpot p50={s['tpot_p50_s'] * 1e3:.2f}ms "
            f"p95={s['tpot_p95_s'] * 1e3:.2f}ms | "
            f"prefill {s['prefill_time_s']:.2f}s "
            f"({s['prefill_tok_s']:.0f} tok/s) / "
            f"decode {s['decode_time_s']:.2f}s "
            f"({s['decode_tok_s']:.0f} tok/s)")


def dump_telemetry(engine: ServeEngine, args) -> None:
    """--metrics-out / --trace-out / --steptrace-out epilogue."""
    if args.metrics_out:
        engine.metrics.to_jsonl(args.metrics_out)
        print(f"metrics snapshot appended to {args.metrics_out}")
    if args.trace_out:
        engine.tracer.write(args.trace_out)
        print(f"chrome trace written to {args.trace_out} "
              f"({len(engine.tracer.events)} events)")
    if args.steptrace_out:
        engine.steptrace.write(args.steptrace_out)
        print(f"steptrace written to {args.steptrace_out} "
              f"({len(engine.steptrace)} events)")


def _profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def print_profile(prof, wall_s: float, top: int = 12) -> float:
    """Device time of a profiled run against that run's own wall time
    (``wall_s``, timed inside the profiler from the first launch to a
    final sync): the device-busy share, then the kernels that took the
    most device time. Only device-side events count (kernels and copies),
    so an op and the kernels it launched are not added twice. Returns the
    busy share."""
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy_s = sum(us for us, _, _ in rows) / 1e6
    print(f"profile: wall {wall_s:.3f}s (profiled) device busy "
          f"{busy_s:.3f}s ({100 * busy_s / wall_s:.1f}%), "
          f"{sum(c for _, c, _ in rows)} device events")
    for us, count, key in rows[:top]:
        print(f"  {us / 1e3:10.3f} ms {count:7d}x  {key[:90]}")
    return busy_s / wall_s


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--trace", type=int, default=0,
                    help="serve N trace requests via continuous batching")
    ap.add_argument("--draft-k", type=int, default=0,
                    help="self-speculative draft length")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable prompt-prefix page sharing")
    ap.add_argument("--prefill-chunk", type=int, default=128,
                    help="span size for chunked prefill")
    ap.add_argument("--moe-dispatch", choices=["grouped", "capacity"],
                    default="grouped",
                    help="MoE serving dispatch: sort-based dropless "
                         "grouped GEMM (default) or the dense capacity "
                         "buffer")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 paged KV pages")
    ap.add_argument("--quantize", choices=["none", "int8", "fp8"],
                    default="none", help="weight storage dtype")
    ap.add_argument("--bist", action="store_true",
                    help="run the built-in self-test (golden patterns "
                         "through the matmul and paged-decode kernels) on "
                         "the serving device first; refuse to serve on a "
                         "mismatch")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="turn on the deterministic fault schedule with "
                         "this seed (worker kills, KV page flips, transfer "
                         "drops, stragglers)")
    ap.add_argument("--ttft-deadline", type=int, default=None,
                    metavar="STEPS",
                    help="shed requests whose best-case TTFT exceeds this "
                         "many engine steps")
    ap.add_argument("--spec-off-depth", type=int, default=None,
                    metavar="DEPTH",
                    help="drop speculative decoding while more than DEPTH "
                         "requests queue")
    ap.add_argument("--mesh", default=None, metavar="D,M",
                    help="serve on a (data, model) mesh of D*M ranks, "
                         "started by the launcher")
    ap.add_argument("--rules", default="baseline_dp_tp",
                    choices=sorted(RULE_SETS),
                    help="AxisRules set for the serving mesh")
    ap.add_argument("--disaggregate", action="store_true",
                    help="prefill/decode disaggregation (paged archs)")
    ap.add_argument("--prefill-workers", type=int, default=1)
    ap.add_argument("--link", choices=["ici", "dcn"], default="ici",
                    help="modeled prefill->decode page-transfer link")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' on request)")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="float32", help="compute and weight dtype")
    ap.add_argument("--profile", action="store_true",
                    help="profile the serve: device-busy share, top ops")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="append a timestamped JSONL metrics snapshot")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the request-lifecycle Chrome trace")
    ap.add_argument("--steptrace-out", default=None, metavar="PATH",
                    help="write the measured step-time trace")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.profile and device.type != "cuda":
        raise SystemExit("--profile measures device time: it needs a GPU")
    if args.bist:
        impl = "cuda" if device.type == "cuda" else "ref"
        res = startup_bist(impl=impl, device=device)
        print(f"bist: matmul max_err={res.matmul_report.max_abs_err:.3e} "
              f"paged_decode max_err={res.paged_decode_max_err:.3e} "
              f"-> {'PASS' if res.passed else 'FAIL'}")
        if not res.passed:
            raise SystemExit(
                "bist: kernel self-test failed; refusing to serve")
    if args.mesh is None:
        serve(args, device)
        return
    d, m = mesh_shape(args.mesh)
    if args.profile:
        raise SystemExit("--profile reads one device: run it without "
                         "--mesh")
    from repro_torch.sharding.comm import run_ranks
    if device.type == "cuda":
        torch.cuda.empty_cache()  # the ranks share what the BIST held
    run_ranks(_mesh_rank, d * m, (list(sys.argv[1:] if argv is None
                                       else argv), str(device)),
              timeout_s=MESH_TIMEOUT_S)


MESH_TIMEOUT_S = 3600.0


def mesh_shape(text: str) -> Tuple[int, int]:
    try:
        d, m = (int(x) for x in text.split(","))
    except ValueError:
        raise SystemExit(f"--mesh takes D,M, got {text!r}") from None
    if d < 1 or m < 1:
        raise SystemExit(f"--mesh {text}: both sizes must be >= 1")
    return d, m


def _mesh_rank(rank: int, world: int, store: str, argv: List[str],
               device: str) -> None:
    """One rank of ``--mesh``: join the mesh, then serve with it."""
    from repro_torch.sharding.comm import init_rank, make_mesh
    args = _parser().parse_args(argv)
    dev = init_rank(rank, world, store, torch.device(device),
                    timeout_s=MESH_TIMEOUT_S)
    mesh = make_mesh(mesh_shape(args.mesh), dev)
    serve(args, dev, mesh=mesh, rank=rank)


def serve(args, device: torch.device, *, mesh=None, rank: int = 0
          ) -> None:
    """The launcher's serve on ``device``; on a mesh, this rank's part of
    it (rank 0 prints)."""
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    dtype = getattr(torch, args.dtype)
    ctx = ModelContext(
        compute_dtype=dtype, mamba_chunk=16, rwkv_chunk=8,
        decode_cache_dtype=torch.int8 if args.kv_int8 else None,
        device=device, moe_dispatch=args.moe_dispatch)
    window = args.prompt_len + args.max_new
    paged = api.supports_paged_decode(cfg)
    tracer = SpanTracer() if args.trace_out else None
    faults = None
    if args.chaos is not None:  # the reference launcher's plan
        faults = FaultInjector(FaultPlan(
            seed=args.chaos, worker_fail_rate=0.05, page_flip_rate=0.05,
            transfer_drop_rate=0.05, straggler_rate=0.05))
    admission = None
    if args.ttft_deadline is not None or args.spec_off_depth is not None:
        admission = AdmissionController(AdmissionPolicy(
            ttft_deadline_steps=args.ttft_deadline,
            spec_off_queue_depth=args.spec_off_depth))

    def make_engine() -> ServeEngine:
        return ServeEngine(
            cfg, ctx, window=window, max_batch=args.max_batch,
            chunk=args.chunk, page_size=args.page_size,
            temperature=args.temperature,
            draft_k=args.draft_k if paged else 0,
            prefix_cache=paged and not args.no_prefix_cache,
            prefill_chunk=args.prefill_chunk, tracer=tracer,
            faults=faults, admission=admission, mesh=mesh, rules=args.rules,
            disaggregate=args.disaggregate,
            prefill_workers=args.prefill_workers, transfer_link=args.link)

    engine = make_engine()
    # on a mesh, this rank's shards, built leaf by leaf from the seed
    params = engine.local_params(args.seed, dtype)
    if args.quantize != "none":
        params = quantize_weights(params, {"fp8": torch.float8_e4m3fn,
                                           "int8": torch.int8}[args.quantize])
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    where = f"{'paged' if engine.paged else 'dense'} on {device}"
    if mesh is not None:
        where += f", mesh {args.mesh}"
        rep = engine.sharding_report
        say(f"mesh={rep['mesh']} rules={rep['rules']}")
        for line in rep["dropped_rules"]:
            say(f"  fallback: {line}")
    if args.disaggregate:
        where += f", disaggregated over {args.link}"

    if args.trace:
        def trace():
            reqs = make_trace(args.trace, cfg.vocab_size, args.seed,
                              prompt_hi=args.prompt_len, new_hi=args.max_new)
            if cfg.is_encoder_decoder:
                # enc-dec requests carry their audio features
                rng = np.random.default_rng(args.seed)
                for req in reqs:
                    req.extras["enc_feats"] = rng.standard_normal(
                        (1, cfg.encoder_seq, cfg.d_model),
                        dtype=np.float32) * 0.1
            return reqs

        if args.profile:
            # a warm-up run builds the kernels and initializes the
            # libraries; fresh engines keep the prefix cache cold
            make_engine().run(params, trace(), generator=gen)
        t0 = time.perf_counter()
        out = engine.run(params, trace(), generator=gen)
        _sync(device)
        wall = time.perf_counter() - t0
        if args.profile:
            with _profiler(device) as prof:
                t1 = time.perf_counter()
                make_engine().run(params, trace(), generator=gen)
                _sync(device)
                prof_wall = time.perf_counter() - t1
            print_profile(prof, prof_wall)
        toks = sum(len(v) for v in out.values())
        s = engine.scheduler
        say(f"[{where}] {args.trace} requests, {toks} tokens in "
              f"{wall:.2f}s ({toks / wall:.1f} tok/s) "
              f"host_syncs={engine.counters['host_syncs']}")
        say(f"occupancy={s.mean_occupancy:.2f} stats={s.stats}")
        say(slo_line(engine))
        if engine.paged:
            say(f"prefix_hit_rate={engine.prefix_hit_rate:.2f} "
                  f"acceptance_length={engine.acceptance_length:.2f} "
                  f"kv={engine.kv.counters}")
        elif engine.bucket_prefill:
            say(f"prefill_bucket_sizes="
                  f"{sorted(engine.prefill_bucket_sizes)}")
        if faults is not None or admission is not None:
            say(f"[faults] {dict(engine.fault_stats.items())}")
        if args.disaggregate:
            ts = engine.transfer_stats()
            say(f"[disagg] link={ts['link']} transfers={ts['transfers']} "
                f"pages={ts['transfer_pages']} "
                f"bytes={ts['transfer_bytes']} "
                f"stall_boundaries={ts['transfer_stall_boundaries']} "
                f"idle_boundaries={ts['decode_idle_boundaries']}")
            say(f"[disagg] prefill queue depth mean="
                f"{ts['prefill_depth_mean']:.2f} "
                f"peak={ts['prefill_depth_peak']} | decode queue depth "
                f"mean={ts['decode_depth_mean']:.2f} "
                f"peak={ts['decode_depth_peak']} | "
                f"pool={engine.prefill_pool.stats}")
        if rank == 0:
            dump_telemetry(engine, args)
        return

    rng = np.random.default_rng(args.seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (args.batch, args.prompt_len))}
    if cfg.is_encoder_decoder:
        batch["enc_feats"] = rng.standard_normal(
            (args.batch, cfg.encoder_seq, cfg.d_model),
            dtype=np.float32) * 0.1
    t0 = time.perf_counter()
    out = engine.generate(params, batch, max_new=args.max_new,
                          temperature=args.temperature, generator=gen)
    _sync(device)
    wall = time.perf_counter() - t0
    toks = args.batch * args.max_new
    say(f"[{where}] generated {toks} tokens in {wall:.2f}s "
          f"({toks / wall:.1f} tok/s batch={args.batch}) "
          f"host_syncs={engine.counters['host_syncs']}")
    say(slo_line(engine))
    say("sample:", out[0, :16].tolist())
    if rank == 0:
        dump_telemetry(engine, args)


if __name__ == "__main__":
    main()
