"""Training driver of the port: config -> state -> resilient loop.

As ``repro.launch.train``: a seeded deterministic data pipeline, async
verified checkpoints, injected cube failures with OCS spare substitution,
restore and replay, and a goodput ledger. Weights are random, made from
``--seed`` on the device. Compute is f32, as in the reference driver,
unless ``--dtype bfloat16`` (parameters, gradients and optimizer state
stay f32). The device is the card unless ``--device cpu``. Its last lines
include the ``carbon:`` line of the reference driver: the paper's Ironwood
CCI (gCO2e per EFLOP) applied to the run's 6 * N * tokens FLOPs, a figure
for those FLOPs on an Ironwood pod, not a reading of this device.

On the card the attention of the loss's forward runs the hand-written
flash kernel and the RWKV-6 WKV its forward and backward kernels; the
Mamba and RWKV chunks are the reference trainer's (64 and 16). On the card
``build_trainer`` turns on PyTorch's deterministic mode
(``torch.use_deterministic_algorithms(True)``, with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` unless already set): replay after a
failure must reproduce the uninterrupted losses bit for bit, and the
embedding gradient's index accumulation is otherwise unordered. The mode
is process-wide. The workspace setting takes effect only if it precedes
the process's first CUDA work, so ``build_trainer`` raises if it is unset
once CUDA has started; set it in the environment first in that case.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b \\
      --smoke --steps 12 --batch 4 --seq 32 --ckpt-dir /tmp/ck \\
      --ckpt-every 5 --fail-at 8 --device cpu
"""

from __future__ import annotations

import argparse
import os
import statistics
import tempfile
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_arch, get_smoke
from repro_torch.core.cci import CCI_BY_NAME, CarbonLedger
from repro_torch.core.ocs import OCSPodScheduler
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.blocks import ModelContext
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import SpanTracer
from repro_torch.optim.optimizers import (Optimizer, adafactor, adamw,
                                          cosine_schedule)
from repro_torch.resilience.driver import FailurePlan, ResilientTrainer
from repro_torch.train.step import (TrainSettings, init_train_state,
                                    make_train_step)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_optimizer(name: str, total_steps: int = 10000) -> Optimizer:
    """``repro.launch.cells.make_optimizer``: 200 warmup steps to 3e-4."""
    lr = cosine_schedule(3e-4, 200, total_steps)
    if name == "adamw":
        return adamw(lr)
    if name == "adafactor":
        return adafactor(lr)
    raise ValueError(name)


def deterministic_mode() -> None:
    """Bit-reproducible CUDA training: deterministic algorithms (ordered
    index accumulation in the embedding gradient) and a fixed cuBLAS
    workspace, which must be set before cuBLAS starts to take effect:
    unset once CUDA has started, it raises rather than set it too late."""
    if "CUBLAS_WORKSPACE_CONFIG" not in os.environ:
        if torch.cuda.is_initialized():
            raise RuntimeError(
                "CUBLAS_WORKSPACE_CONFIG is unset and CUDA has already "
                "started, so cuBLAS may ignore it and replay lose bit-"
                "identity; set CUBLAS_WORKSPACE_CONFIG=:4096:8 before any "
                "CUDA work")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)


def build_trainer(cfg: ModelConfig, *, batch: int, seq: int,
                  ckpt_dir: str, microbatches: int = 1,
                  checkpoint_every: int = 20, seed: int = 0,
                  optimizer: str = "adamw",
                  failures: Optional[Dict[int, int]] = None,
                  compute_dtype: torch.dtype = torch.float32,
                  metrics=None, tracer=None, device: DeviceLike = None):
    dev = resolve_device(device)
    if dev.type == "cuda":
        deterministic_mode()
    ctx = ModelContext(compute_dtype=compute_dtype, q_chunk=2048,
                       mamba_chunk=64, rwkv_chunk=16, device=dev)
    opt = make_optimizer(optimizer, total_steps=10_000)
    step_fn = make_train_step(cfg, ctx, opt,
                              TrainSettings(microbatches=microbatches))
    pipeline = DataPipeline(
        DataConfig(global_batch=batch, seq_len=seq,
                   vocab_size=cfg.vocab_size, seed=seed), cfg)
    ckpt = CheckpointManager(ckpt_dir)
    sched = OCSPodScheduler(total_cubes=144)  # Ironwood-scale cube count
    sched.allocate("train", 128 * 64)
    trainer = ResilientTrainer(
        train_step=step_fn, pipeline=pipeline, ckpt=ckpt, scheduler=sched,
        job="train", checkpoint_every=checkpoint_every,
        failure_plan=FailurePlan(failures=dict(failures or {})),
        metrics=metrics, tracer=tracer)
    state = init_train_state(seed, cfg, opt, device=dev)
    # restore-if-present (restart semantics)
    latest = ckpt.latest_step()
    if latest is not None:
        state = ckpt.restore(latest, state)
    return trainer, state


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a cube failure at this step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32",
                    help="compute dtype (parameters stay float32)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain paths)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="append a timestamped JSONL metrics snapshot")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the step/ckpt/replay Chrome trace")
    ap.add_argument("--steptrace-out", default=None, metavar="PATH",
                    help="write the measured step-time trace")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    failures = {args.fail_at: 0} if args.fail_at is not None else None
    tracer = SpanTracer() if args.trace_out else None
    trainer, state = build_trainer(
        cfg, batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
        microbatches=args.microbatches, checkpoint_every=args.ckpt_every,
        seed=args.seed, failures=failures, tracer=tracer,
        compute_dtype=DTYPES[args.dtype], device=device)

    carbon = CarbonLedger(CCI_BY_NAME["ironwood"])
    t0 = time.time()
    state, ledger, losses = trainer.run(state, args.steps)
    wall = time.time() - t0
    flops_per_step = 6.0 * cfg.active_params() * args.batch * args.seq
    carbon.record_step(flops_per_step * len(losses))
    print(f"\ntrained {len(losses)} effective steps in {wall:.1f}s on "
          f"{device.type}; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    # one-line goodput/step-time summary from the telemetry registry
    # (rescales is always 0 here: the trainer restores at full scale)
    rs = trainer.replay_summary()
    hist = trainer.metrics.histogram("train_step_s")
    median = statistics.median(r.duration_s for r in trainer.records
                               if not r.replayed)
    print(f"telemetry: goodput={ledger.goodput:.4f} "
          f"steps={rs['effective_steps']} "
          f"replayed={rs['replayed_steps']} rescales={rs['rescales']} "
          f"ckpts={trainer.metrics.counter('train_ckpt_saves').value:.0f} "
          f"| step p50={hist.quantile(0.5) * 1e3:.0f}ms "
          f"p95={hist.quantile(0.95) * 1e3:.0f}ms (histogram buckets) "
          f"| median step {median * 1e3:.1f}ms, "
          f"{args.batch * args.seq / median:.0f} tok/s")
    # the paper's Ironwood CCI (Figure 6) applied to the run's model FLOPs:
    # what these FLOPs would emit on an Ironwood pod, not this device's
    print("carbon: (the paper's Ironwood CCI applied to this run's "
          "6*N*tokens FLOPs, not a measurement of this device)",
          {k: f"{v:.3e}" for k, v in carbon.summary().items()})
    if args.metrics_out:
        trainer.metrics.to_jsonl(args.metrics_out)
        print(f"metrics snapshot appended to {args.metrics_out}")
    if args.trace_out:
        trainer.tracer.write(args.trace_out)
        print(f"chrome trace written to {args.trace_out} "
              f"({len(trainer.tracer.events)} events)")
    if args.steptrace_out:
        trainer.steptrace().write(args.steptrace_out)
        print(f"steptrace written to {args.steptrace_out}")


if __name__ == "__main__":
    main()
