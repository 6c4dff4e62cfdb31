#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

  1. device  - needs CUDA; prints the card's name and power limit;
  2. build   - compiles every CUDA source of the port with nvcc, in parallel;
  3. kernels - each kernel variant against its plain torch version on the
               card at the shapes of the serving paths, with its time, the
               plain version's, one library call's (a yardstick the port
               never calls) and the least time the card could take; the
               kernel's and the library call's times both as the
               wrapper's (CUDA events, host time included: ms,
               library_ms) and as device time (torch.profiler over the
               same 20 L2-flushed launches, the flushes left out:
               device_ms, library_device_ms):
               the paged-attention kernels x {f32, bf16, int8} pages at
               qwen's shapes (H=14, KV=2, D=64, P=16, B=8, contexts up to
               2048, spans of 3 and 128 tokens, and a D=128 windowed case)
               and at Mixtral's (H=48, KV=8, D=128, B=4, a 4096-token
               window, contexts up to 4608, the pages behind the window
               trimmed from the table as the engine does); the grouped MoE
               GEMM x {f32, bf16, int8 weights} at Mixtral's widths
               (D=6144, F=16384, 8 experts, top-2) for a decode step of 4
               tokens and a 128-token prefill chunk, up and down, plus a
               ragged smoke shape, an all -1 plan, Mixtral's 4500-token
               ring prefill and Jamba's experts (16, 4096 x 14336) at a
               decode step, each through the body the host plan picks
               (Mixtral's bf16 shapes also through the other body), each
               also with the tile ids rotated by one expert (a planted
               fault that must fail the limit); then the plan's readings:
               the stream body's device time at 1-8 splits and both
               bodies' at 8-1024 tokens; the dense ring
               decode kernel x {f32, bf16} at phi4-mini's (H=24, KV=8,
               D=128: a GQA group of 3), qwen2.5-3B's (16/2), internlm2's
               (16/8) and Mixtral's (48/8) head shapes: a 4096-slot ring
               with wrapped rows, a ragged 1000-slot ring, rows at pos 0, a
               window below the ring width, phi4's serving shape, and
               Whisper-small's decoder self and cross attention (12/12,
               D=64, W 448 and 1500); each
               also run at pos - 1 (one key dropped), a planted fault that
               must fail the limit; the paged kernels also at phi4's heads;
               the span's bf16 and int8 cases (the bf16 route, through
               csrc/paged_span_attention.cu) also row by row within
               FLASH_ROW_C bf16 steps of each row's largest |value|, as the
               flash cases are, with its windowed cases run again with the
               window one key short and one key long (a planted fault that
               must fail that limit), and 16-token spans at Mixtral's heads;
               the span kernel's ptxas lines, shared memory per block and
               blocks per SM are logged;
  4. qwen    - full-width qwen2-0.5B from seeded random weights through
               ServeEngine.run: bf16 pages, draft_k=2, an int8 pool; then a
               short f32 run (TF32 off) whose greedy tokens through the
               kernels must equal the gather path's;
  5. mixtral - full-width Mixtral-8x22B cut to 4 of its 56 layers (the
               only reduction: 56 layers of bf16 weights need ~281 GB),
               bf16, through ServeEngine.run: 8 requests plus one whose
               4500-token prompt passes the 4096-token window (pages are
               trimmed), bf16 pages, draft_k=2, an int8 pool, then the bf16
               run again under torch.profiler; one layer's experts in int8
               (quantize_moe_params) through moe_ffn, kernel against plain,
               with any host sync an error; then 2 layers in f32 (TF32 off)
               whose greedy tokens through the kernels must equal the plain
               path's, one prompt of 4500 tokens trimming pages; and on the
               dense backend (paged=False), where the 4096-token window
               makes every layer's cache a 4096-slot ring: 6 prompts of
               3000-4500 tokens (full-prompt prefill through the flash and
               grouped-GEMM kernels, rolled into the ring; one row wraps
               during decode) decoded through the dense decode kernel, in
               bf16 at 4 layers (then again under torch.profiler) and,
               greedy tokens equal to the plain path's, in f32 at 2;
  5b. dense  - full-width, full-depth phi4-mini-3.8B (32 layers, bf16) on
               the dense backend: 8 requests of 64-1024 prompt tokens and 32
               new ones through the chunked dense-span prefill and the dense
               decode kernel (launches = 32 x decode steps), two of the
               requests under torch.profiler, then generate_pertoken
               (flash prefill, dense decode); then 4 layers in f32 (TF32
               off) whose greedy tokens through the kernels equal the
               plain path's, on run and generate_pertoken;
  5c. state  - full-width, full-depth rwkv6-1.6B (24 layers, bf16) on the
               dense backend: 8 requests of 64-1024 prompt tokens front-
               padded to power-of-two buckets, 32 new each, through the
               chunked WKV kernel (launches = 24 x (prefills + decode
               steps)), two of them under torch.profiler (the WKV
               kernels' device time logged by name), then
               generate_pertoken; then f32 at full depth (TF32 off), greedy
               tokens through the kernel equal to the plain path's on run
               and generate_pertoken (97-token prompts: WKV chunk 1); then
               Jamba-v0.1-52B at full width cut to one block of 8 of its 32
               layers (7 Mamba + 1 attention, 4 MoE; the only reduction: 32
               layers of bf16 weights need ~104 GB), bf16, paged=False: 6
               requests of 64-1024 prompt tokens through the chunked
               dense-span prefill (the Mamba state threads through the
               spans), the dense decode kernel (launches = decode steps)
               and the grouped GEMM; then the same 8 layers in f32, greedy
               tokens through the kernels equal to the plain path's;
  5d. dlrm   - the port's DLRM example (python -m
               repro_torch.examples.dlrm_sparsecore) on the card: 120 SGD
               steps of batch 256, every embedding bag through the
               embedding-bag kernel (launches = 3 x 120), the loss falling;
               then the plain route from the same params and batches, each
               step's loss within rel 1e-5 of the kernel route's (f32);
  5e. enc-dec and M-RoPE - full-width, full-depth Whisper-small (12 + 12
               layers, bf16) on the dense backend: 8 requests of 4-64
               decoder tokens, each with (1, 1500, 768) frames from the
               seed, 64 new, window 448, the prefill through the flash
               kernel (launches = (12 + 2 x 12) x prefills; the cross-
               attention with S_k = 1500), the decode through the dense
               decode kernel twice per layer (launches = 2 x 12 x decode
               steps), one request under torch.profiler, then f32 (TF32
               off) greedy tokens through the kernels equal to the plain
               path's at full depth; then full-width, full-depth
               Qwen2-VL-7B (28 layers, bf16), paged: 8 requests of 100-600
               tokens sharing a 64-token system prompt, 32 new, the odd
               half with explicit (3, S) M-RoPE rows (a 16 x 16 merged
               image grid, then text from max + 1), launches = 28 x decode
               steps and 28 x span calls, prefix-cache hits from the text
               half only, one request under torch.profiler, then f32
               token equality at 4 layers;
  6. resilient serve - full-width qwen2-0.5B under the startup self-test,
               the deterministic fault schedule and SLO admission: BIST on
               the card (8 matmul-kernel launches, 1 paged-decode launch;
               it must fail with a corrupted matmul and with a decode that
               returns zeros); the JAX test's chaos plan at f32 (TF32 off),
               6 requests (three share a 64-token prefix) with draft_k 0
               and 2, whose survivors' tokens must equal the fault-free
               run's; TTFT shedding and speculation dropped under queue
               pressure, served tokens equal to the run without admission;
               the chaos run at bf16 for timing (host seconds in CRC
               verification); fp8 weights; the serve launcher with
               --bist --chaos --ttft-deadline --spec-off-depth --quantize;
  6b. multi-device - (a) full-width qwen2-0.5B disaggregated (bf16, the
               qwen serve's 8 requests, 2 modeled prefill workers) on the
               "ici" and "dcn" links: tokens equal to the co-located
               serve's, 8 transfers, stalls, one host drain a chunk; then
               the chaos plan (prefill-worker kills, transfer drops, page
               flips, stragglers) over "dcn": at bf16 a reading (a replay
               re-prefills its generated tokens as a span, which rounds
               otherwise), at f32 on the resilient phase's requests with
               survivors' tokens equal to the fault-free run's; then
               serving meshes whose ranks share the card (one process
               each, gloo on CUDA tensors, parameters
               built by each rank from the seed, leaf by leaf, after the
               solo references are computed and freed; a rank that fails
               fails the phase): (b) qwen2-0.5B on (1, 2), all 24 layers:
               f32 with draft_k 2 run twice (tokens equal to the solo f32
               engine's on every rank, prefix hits on the second run),
               bf16 (tok/s, the share of tokens equal to the solo bf16
               serve's, each rank's paged-kernel launches), and (f) in the
               same ranks make_compressed_grad_fn over the 2 ranks within
               1e-6 of one rank's arithmetic; then 4 ranks: (d)
               Mixtral's smoke widths (h 8, kv 2) on (1, 4), the GQA
               fallback: tokens equal to solo's, the kv_heads rule
               reported dropped; and (c) Mixtral-8x22B at full width, 2 of
               56 layers, f32 on (2, 2) (experts over "data"; heads, KV
               heads and vocabulary over "model"), run twice: every rank's
               tokens equal to the solo f32 engine's on both runs, the
               grouped GEMM's launches per rank;
  7. train   - full-width, full-depth qwen2-0.5B from seeded random weights
               through build_trainer + ResilientTrainer.run at batch
               4 x seq 2048, bf16 compute: step p50/p95, tok/s, MFU, then
               a step under torch.profiler to warm it, then three
               windows of two steps under it (device time over each
               window's own wall time, top device operations); then in f32 (TF32 off) 3 steps through the
               flash kernel against 3 through the plain attention (the
               train step build_trainer makes, with attn_impl "cuda" and
               "ref"; losses within rel 1e-4, grad norms within rel
               1e-3), and a
               run with a cube failure injected at step 5 (checkpoints every
               2 steps; full width, 2 layers) against an uninterrupted one:
               bit-identical losses, with replayed steps;
  7b. train_state - full-width, full-depth rwkv6-1.6B (24 layers) through
               build_trainer + ResilientTrainer.run at batch 4 x seq 2048,
               bf16 compute, 6 steps through the WKV forward and backward
               kernels (launches = 2 x 24 x steps forward, the block
               checkpoint's recompute included, and 24 x steps backward):
               step times, median, tok/s, MFU, peak memory, losses, then
               one profiled window of 2 steps (device busy share and time
               by class); then f32 (TF32 off) 3 steps at 4 of the 24
               layers (batch 1 x 2048) through attn_impl "cuda" and "ref"
               from the same parameters: losses within rel 1e-4, grad
               norms within rel 1e-3 and every leaf of the first batch's
               gradient within 1e-3 of its largest |value|, a run with the
               backward's planted fault (drop_carry: every group's
               gradient walk from zero) failing that check; a failure
               replay at 2 layers bit-identical to the uninterrupted run;
               Jamba's smoke config (Mamba, attention through the flash
               kernel, MoE) f32 kernel vs plain under the same limits; and
               the WKV backward kernel at the training shape and the smoke
               heads (hd 16): all six gradients within WKV_GRAD_LIMIT of
               each one's largest |value| against wkv_backward_plain, a
               repeat bitwise, the planted fault failing, its time beside
               autograd's backward through the plain chunked WKV, each of
               its four kernels' device time, its scratch bytes and its
               byte bound; then a sweep of the forward's group length G at
               the training shape (the backward follows the forward's
               groups): the backward's device ms and each kernel's at every
               G, each held to the limit;
  7c. train_encdec - the encoder-decoder and M-RoPE families through the
               training loss: (a) full-size Whisper-small (12 + 12
               layers, d 768, 1500 frames) through build_trainer +
               ResilientTrainer.run at batch 8 x 448 decoder tokens, bf16
               compute, 6 steps through the flash kernel (launches = 2 x
               (12 + 2 x 12) x steps: the encoder's bidirectional layers,
               the decoder's causal and cross attention, forward and the
               layer checkpoint's recompute): step times, median, tok/s,
               peak memory, one profiled window of 2 steps (busy share,
               time by class) and the plain attention backward's time at
               the three shapes (CUDA events), scaled to a step; (b)
               Whisper f32 (TF32 off) 3 steps at batch 2 x 448 through
               attn_impl "cuda" and "ref" from the same parameters: losses
               within rel 1e-4, grad norms within rel 1e-3, flash launches
               only on the kernel route; (c) a failure replay at 2 + 2
               layers bit-identical to the uninterrupted run; (d)
               Qwen2-VL-7B at full width cut to 2 of its 28 layers, f32
               kernel vs plain at batch 1 x 1024 on image-grid M-RoPE rows
               (vl_rows), the limits of (b); (e) the port's serve_decode
               and failure_recovery examples on the card (the latter must
               print "loss trajectories identical: True");
  8. fleet   - the fleet simulator fed by the card: (a) the bridge
               (fleet.run_bridge on the card: qwen2-smoke, 18 steps, a
               checkpoint every 6, failures {9: 0, 14: 1}; the real and
               simulated ledger structures must match and speak the
               five-kind grammar); (b) a full-width qwen2-0.5B serve through
               python -m repro_torch.launch.serve --trace 8 with its Chrome
               trace and steptrace, then the trace gate
               (launch.trace_gate.run_gate) on them on the card: stages 1-4
               fatal, stage 5 (the affine service model's calibration
               against the card's chunks) logged as a reading, beside the
               chunks' mean time at each batch and the fit's slope before
               it is clamped at 0;
               (c) the train phase's bf16 steptrace (first step with its
               warm-up, as recorded) through fleet.perf.job_spec_from_trace
               into a simulator at fleet_week's pod (Ironwood, 144 cubes, 16
               spares): the job must finish with its ledger in the grammar;
               (d) the five benchmarks/scenarios files, read in place,
               through scenarios.run_scenario, every expect held, then
               serve_train_mix with the service model fitted to the card's
               serve steptrace (its gates logged as readings); (e) the
               port's fleet_week at its defaults and its quickstart on the
               card at its defaults (300 steps of 8 x 128, bf16), whose
               assertion that the loss fell is fatal, then two of its
               steps under torch.profiler (the device's busy share). The
               bridge and the quickstart must launch the flash kernel.

The kernels phase also holds the matmul kernel against its plain version
(f32 and bf16 inputs at the self-test's 128^3, the JAX test shapes, a
ragged shape and qwen2-0.5B's MLP up projection of a 4096-token prefill),
each with the kernel run with its last K tile skipped, a planted fault that
must fail the limit, and torch.matmul's time beside it. The build logs the
ptxas lines of the matmul's and the dense decode's sources and the shared
memory of their bf16 bodies.
The kernels phase also holds the flash-attention kernel against its plain
version at qwen2-0.5B's training shape (4 x 14 heads, S=2048, D=64), bf16
and f32, causal, windowed (512) and bidirectional, at smoke widths and at
Mixtral's ring prefill (48 heads x 128, a 4500-token prompt, window 4096):
max |error| within TOL, bf16 also within FLASH_ROW_C bf16 steps of each
row's largest |value|; the windowed cases also run the kernel with the
window one key off, a planted fault that must fail the same limits. Each
bf16 case logs its key-range splits (flash_plan), and the build logs the
flash source's ptxas lines (registers, spills, shared memory).
The kernels phase also holds the chunked RWKV-6 WKV kernel against its
plain version (f32, the model's only WKV dtype) at rwkv6's heads (32 x
64): a 1024-token bucketed prefill, a batch of 16-token spans from a
nonzero state, chunks 8 and 13, the decode shape (B 4, S 1), the smoke
width hd 16, a front-padded row whose outputs and state must stay
exactly 0, generate_pertoken's 97-token prompt at chunk 1, chunk 10 at
200 tokens and a 256-token span from a nonzero state run in place (the
same bits as out of place); out and the final state within WKV_LIMIT of
the case's largest |value|, the kernel without the current-token bonus
and the output pass started one group behind (planted faults; the second
a no-op where the plan has one group) failing it. Each case logs the
plan's body (wkv_plan: state pass + scan + output pass, one pass, or
decode), G and blocks; two sweeps time the split body at every G and
each of its three kernels (the 1024-token prefill, up to one group of all
64 chunks, and the 97-token prompt at chunk 1).
The kernels phase also holds the embedding-bag kernel against its plain
version, f32 and bf16 tables: the DLRM example's three tables (5000 x 32,
20000 x 32, 200 x 16; N 256, bag 4), the JAX tests' shapes, a ragged D,
repeated indices in a bag, negative and out-of-range indices (wrapped
once, then clamped), bags of one index with weight 1 (the row exactly),
and one table at MLPerf DLRM-DCNv2's scale (40M x 128; N 8192, bag 100);
f32 within GATHER_F32_LIMIT of the case's largest |value|, bf16 within
one bf16 step of each row's, the kernel without the bag's last position
failing the limit, F.embedding_bag timed beside it. And the flash kernel
at Whisper's cross-attention (12 heads x 64, S_q 64 and 448, S_k 1500,
bidirectional, f32 and bf16), the kernel told S_k - 1 keys failing the
flash limits.
Training turns on torch's deterministic mode (process-wide), so it runs
after the serving phases.

Each serve or train run sets every launch counter to 0 just before it and
reads them just after; a kernel of that path launched no time fails the
run. On the bf16 paged serves (qwen2-0.5B, Mixtral, Qwen2-VL) the span
launches must equal layers x span calls, every one through the span
kernel's source, and the one-token decode launches must go through
csrc/paged_decode_attention.cu; their serve profiles log the paged decode
kernels' device time by name.
The kernels phase also holds the bf16 paged one-token decode body
(csrc/paged_decode_attention.cu: one launch, a row's key-range splits
merged in a cluster) at every bf16 and int8 decode case above and at
Qwen2-VL-7B's heads (B 4, 28/4 x 128, contexts 132-632), at the 131,072-
token row over 8-slot pages and at a floor case (B 8 at qwen's heads,
every context 16): each logs its source, splits and stages, runs the two
planted faults (each rank skipping its last stage; the merge leaving out
the last rank holding keys, a bitwise no-op where no row's keys span two
ranks), the device time of paged_attention.cu's wmma body on the same
inputs (the body the decode took before) and a sweep of the splits.
The kernels phase also holds the paged kernels at the serving mesh's
per-rank shapes on model=2 (e): qwen2-0.5B's decode at 7 query heads over
1 KV head (bf16 and int8 pages) and Mixtral's 128-token span at 24 over
4, each against the plain version on the rank's inputs and against the
same heads of the plain version over the whole pool, the kernel reading
another rank's KV-head block failing the limit (a planted fault); and
the grouped GEMM under expert parallelism on data=2 (rank 0's 4 of
Mixtral's 8 experts, about half the tiles -1; bf16 and f32, a decode
step and a 128-token chunk, up and down), the ranks' plain outputs
summing to the one-device product, a non-local tile given a real expert
id failing the limit (a planted fault).
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, no sparsity
TOL = {"f32": 1e-4, "bf16": 2e-2, "int8": 2e-2}
# bf16 flash and span outputs are held, besides TOL, row by row within
# FLASH_ROW_C bf16 steps of the row's largest |want| (row_steps); both come
# from repro_torch.kernels.ref, which the gpu tests hold too, and main()
# binds them once the port is on the path.
KERNELS = {
    "decode_attention": "src/repro/kernels/decode_attention.py:81",
    "matmul": "src/repro/kernels/matmul.py:42",
    "flash_attention": "src/repro/kernels/flash_attention.py:75",
    "paged_decode_attention": "src/repro/kernels/decode_attention.py:330",
    "paged_decode_span_attention":
        "src/repro/kernels/decode_attention.py:276",
    "grouped_matmul": "src/repro/kernels/moe_gemm.py:55",
    "rwkv_wkv": "src/repro/kernels/rwkv_scan.py:75",
    # no Pallas kernel: the reference trains through jax.grad of this
    # function, and its Pallas rwkv_wkv has no backward
    "rwkv_wkv_backward": "src/repro/models/rwkv6.py:123 (the gradient of "
                         "_chunked_wkv)",
    "sparse_gather_sum": "src/repro/kernels/sparse_gather.py:44",
}
SOURCES = {
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "matmul": "src/repro_torch/kernels/csrc/matmul.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "paged_decode_attention":
        "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
    "paged_decode_span_attention":
        "src/repro_torch/kernels/csrc/paged_span_attention.cu",
    "grouped_matmul": "src/repro_torch/kernels/csrc/grouped_gemm.cu",
    "rwkv_wkv": "src/repro_torch/kernels/csrc/rwkv_wkv.cu",
    "rwkv_wkv_backward": "src/repro_torch/kernels/csrc/rwkv_wkv_bwd.cu",
    "sparse_gather_sum": "src/repro_torch/kernels/csrc/sparse_gather.cu",
}
EPS32 = 1.1920929e-07
# the kernels of csrc/grouped_gemm.cu as torch.profiler names them
GROUPED_KERNELS = ("table_kernel", "stream_path::stream_kernel",
                   "wgmma_path::wgmma_kernel", "fma_path::kernel")
# the paged one-token decode's kernels as torch.profiler names them: the
# bf16 body of csrc/paged_decode_attention.cu, and paged_attention.cu's
# bodies and its merge kernel (the decode's route before it)
PAGED_DECODE_KERNELS = ("paged_decode_kernel", "paged_attention_mma_kernel",
                        "paged_attention_kernel", "combine_kernel<")
# the kernels of csrc/rwkv_wkv.cu as torch.profiler names them
WKV_KERNELS = ("wkv_state_pass", "wkv_state_scan", "wkv_output_pass",
               "wkv_onepass", "wkv_decode")
MIXTRAL_LAYERS = 4  # of 56: the bf16 weights of 4 layers fill ~21 GB
JAMBA_LAYERS = 8  # of 32: one Jamba block, ~27 GB of bf16 weights
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 8


T_START = time.perf_counter()


def log(msg: str) -> None:
    """A line of the run's log, stamped with the seconds since the script
    started, so the log shows where the time limit goes."""
    print(f"[{time.perf_counter() - T_START:6.1f}s] {msg}", flush=True)


# ------------------------------------------------------------------ timing


def timed_ms(fn, flush, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, each launch after an L2 flush
    (the serving path reads a layer's pages cold)."""
    import torch
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


_FLUSH_KERNELS: set = set()


def _device_rows(prof):
    """(name, device us, count) of each kind of device activity in a
    profile."""
    for e in prof.key_averages():
        if "CUDA" in str(getattr(e, "device_type", "")):
            yield e.key, getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0)), \
                e.count


def _profiled(fn, flush, iters: int):
    """torch.profiler (device activity only) over ``iters`` L2-flushed
    launches of ``fn``. A session may lose its first device events, so it
    opens with a flush and a sync of its own."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flush.zero_()
        torch.cuda.synchronize()
        for _ in range(iters):
            flush.zero_()
            if fn is not None:
                fn()
        torch.cuda.synchronize()
    return list(_device_rows(prof))


def device_ms(fn, flush, iters: int = 20, tries: int = 3) -> float:
    """Device time of ``fn`` in ms a launch, from torch.profiler over the
    same ``iters`` L2-flushed launches that timed_ms times: the case's own
    device activity, the flush's left out. Below ~0.03 ms, timed_ms reads
    the host's pace (the wrapper's Python and the launch); this reads the
    card's. A kind of activity seen ``count`` times adds its mean time
    round(count / iters) times, so an event the profiler lost does not
    lower the reading; a session that recorded none of the case's
    activity is run again, at most ``tries`` times."""
    import torch
    for _ in range(tries):
        if not _FLUSH_KERNELS:
            _FLUSH_KERNELS.update(name for name, us, _ in
                                  _profiled(None, flush, 2) if us > 0)
    if not _FLUSH_KERNELS:
        raise AssertionError("the profile recorded no flush")
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        rows = [(us, count) for name, us, count in _profiled(fn, flush, iters)
                if name not in _FLUSH_KERNELS and us > 0]
        if rows:
            return sum(us / count * max(1, round(count / iters))
                       for us, count in rows) / 1e3
    raise AssertionError("the profile recorded no device time")


def case_times(run, plain, library, flush, plain_iters: int = 20):
    """A kernel case's times in ms: ``ms``, ``plain_ms`` and
    ``library_ms`` from timed_ms (host time included), ``device_ms`` and
    ``library_device_ms`` from device_ms; the library's are None where no
    PyTorch call computes the same function."""
    return {
        "ms": timed_ms(run, flush),
        "plain_ms": timed_ms(plain, flush, iters=plain_iters),
        "library_ms": None if library is None else timed_ms(library, flush),
        "device_ms": device_ms(run, flush),
        "library_device_ms": (None if library is None
                              else device_ms(library, flush)),
    }


def times_text(v) -> str:
    """A case's times for its log line."""
    lib = ("null" if v["library_ms"] is None else
           f"{v['library_ms']:.4f} library_device_ms="
           f"{v['library_device_ms']:.4f}")
    return (f"ms={v['ms']:.4f} device_ms={v['device_ms']:.4f} "
            f"plain_ms={v['plain_ms']:.4f} library_ms={lib}")


# ----------------------------------------------------------------- kernels


def paged_inputs(name: str, pages: str, *, t: int, d: int = 64,
                 window=None, b: int = 8, h: int = 14, kv: int = 2,
                 p: int = 16, max_ctx: int = 2048, ctxs=None, seed: int = 0):
    """Inputs of a paged-attention kernel case on the card: a dict of q,
    pages k and v (with scales ks, vs for int8), table, pos, qpos (the
    queries' positions) and the shape. Row contexts are ``ctxs``, else
    spread from max_ctx/8 to max_ctx. With a window, table entries of pages
    wholly behind the first query's window are 0 (the null page), as the
    engine's trimming leaves them."""
    import torch
    from repro_torch.models.blocks import paged_quantize

    dev = torch.device("cuda")
    dtype = torch.float32 if pages == "f32" else torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if ctxs is None:
        ctx = torch.linspace(max_ctx // 8, max_ctx, b,
                             device=dev).round().int()
    else:
        ctx = torch.tensor(ctxs, dtype=torch.int32, device=dev)
        b, max_ctx = len(ctxs), max(ctxs)
    m = max_ctx // p + 1
    n = 1 + b * m
    pos = ctx if name == "paged_decode_attention" else ctx - t
    q = torch.randn((b, t, h, d), generator=g, device=dev).to(dtype)
    kf = torch.randn((n, p, kv, d), generator=g, device=dev)
    vf = torch.randn((n, p, kv, d), generator=g, device=dev)
    ks = vs = None
    if pages == "int8":
        k, ks = paged_quantize(kf, torch.int8)
        v, vs = paged_quantize(vf, torch.int8)
    else:
        k, v = kf.to(dtype), vf.to(dtype)
    table = 1 + torch.randperm(n - 1, generator=g, device=dev)[:b * m]
    table = table.reshape(b, m).int()
    used = (ctx + p - 1) // p  # pages holding the row's context
    col = torch.arange(m, device=dev)[None, :]
    table[col >= used[:, None]] = 0
    pos = pos.int().contiguous()
    first_q = pos.long() - (1 if name == "paged_decode_attention" else 0)
    trimmed = 0
    if window is not None:  # pages wholly behind every query's window
        keep = (first_q - window + 1).clamp(min=0) // p
        table[col < keep[:, None]] = 0
        trimmed = int(keep.sum())
    if name == "paged_decode_attention":
        qpos = pos[:, None].long() - 1  # (B, 1) the query's position
    else:
        qpos = pos[:, None].long() + torch.arange(t, device=dev)[None, :]
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, table=table, pos=pos,
                qpos=qpos, trimmed=trimmed, b=b, h=h, kv=kv, d=d,
                max_ctx=max_ctx, dtype=dtype)


def kernel_case(kern, name: str, pages: str, *, t: int, d: int = 64,
                window=None, fault: bool = False, inputs=None, **shape):
    """One kernel variant at serving shapes: returns its report dict.
    ``shape`` as paged_inputs takes it (``inputs``: paged_inputs' dict,
    made already). The span's bf16 and int8 cases are also held row by
    row, like the flash cases; with ``fault`` the span kernel also runs
    with the window one key short and one key long, a planted fault that
    must fail that limit."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref

    x = inputs if inputs is not None else paged_inputs(
        name, pages, t=t, d=d, window=window, **shape)
    q, k, v, ks, vs = x["q"], x["k"], x["v"], x["ks"], x["vs"]
    table, pos, qpos, dtype = x["table"], x["pos"], x["qpos"], x["dtype"]
    b, h, kv, max_ctx, trimmed = (x["b"], x["h"], x["kv"], x["max_ctx"],
                                  x["trimmed"])
    dev = q.device
    if name == "paged_decode_attention":
        qk = q[:, 0]
        decode = lambda **kw: kern.paged_decode_attention(
            qk, k, v, table, pos, k_scale=ks, v_scale=vs, window=window,
            **kw)
        run = decode
        plain = lambda: kern.paged_decode_attention_plain(
            qk, k, v, table, pos, k_scale=ks, v_scale=vs, window=window)
        source = kern.decode_source(q.dtype, k.dtype, d, h // kv)
        by_source = kern.decode_launches
    else:
        span = lambda w: kern.paged_decode_span_attention(
            q, k, v, table, pos, k_scale=ks, v_scale=vs, window=w)
        run = lambda: span(window)
        plain = lambda: kern.paged_decode_span_attention_plain(
            q, k, v, table, pos, k_scale=ks, v_scale=vs, window=window)
        source = kern.span_source(q.dtype, k.dtype, d)
        by_source = kern.span_launches
    before = dict(by_source)
    got, want = run(), plain()
    torch.cuda.synchronize()
    if by_source[source] != before[source] + 1:
        raise AssertionError(f"{name} {pages}: the launch did not go "
                             f"through {source}")
    err = float((got.float() - want.float()).abs().max())
    rowwise = name != "paged_decode_attention" and pages != "f32"
    steps = row_steps(got, want) if rowwise else None
    if (not bool(torch.isfinite(got.float()).all()) or err > TOL[pages]
            or (rowwise and steps > FLASH_ROW_C)):
        raise AssertionError(f"{name} {pages} t={t} h={h} d={d} "
                             f"window={window}: max_abs_err {err} (limit "
                             f"{TOL[pages]}), row steps {steps} (limit "
                             f"{FLASH_ROW_C})")
    planted = []
    for w in ((window - 1, window + 1) if fault else ()):
        reading = row_steps(span(w), want)
        planted.append(reading)
        if reading <= FLASH_ROW_C:
            raise AssertionError(f"{name} {pages} t={t} h={h}: window {w} "
                                 f"instead of {window} passes the row "
                                 f"limit ({reading})")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    body = {}
    if source == kern.PAGED_DECODE_SOURCE:
        body = decode_body(kern, x, window, decode, got, want, pages, flush)
        planted = body.pop("planted_fault")

    # SDPA on the gathered view: the library's time for the same function
    kg = ref.paged_gather_dequant_ref(k, table, ks, dtype)
    vg = ref.paged_gather_dequant_ref(v, table, vs, dtype)
    s_len = kg.shape[1]
    spos = torch.arange(s_len, device=dev)[None, None, :]
    allow = spos <= qpos[..., None]
    if window is not None:
        allow &= spos > qpos[..., None] - window
    kh = kg.repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
    vh = vg.repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
    qh = q.transpose(1, 2).contiguous()
    mask = allow[:, None]
    library = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                     attn_mask=mask)

    times = case_times(run, plain, library, flush)

    # least time for this work: every valid key read once, q read once,
    # out written once; 4*D flops per (query row, valid key)
    keys = allow.sum(-1).long()  # (B, T) valid keys per query
    lo = qpos[:, 0] - (window - 1 if window is not None else qpos[:, 0])
    rows_read = (qpos[:, -1] + 1 - lo.clamp(min=0)).sum().item()
    per_key = kv * d * k.element_size() * 2
    if ks is not None:
        per_key += kv * 2 * 2
    nbytes = (rows_read * per_key + 2 * q.numel() * q.element_size()
              + table.numel() * 4 + pos.numel() * 4)
    flops = 4 * d * h * float(keys.sum().item())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]]
    return {
        "name": name, "pages": pages, "t": t, "b": b, "h": h, "kv": kv,
        "d": d, "window": window, "max_ctx": max_ctx,
        "trimmed_pages": trimmed, "source": source, "max_abs_err": err,
        "row_steps": steps, "planted_fault": planted, **body, **times,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }


def decode_body(kern, x, window, decode, got, want, pages, flush):
    """The bf16 paged decode body at one kernel case: its plan (splits,
    stages, shared memory); besides TOL, its output within one bf16 step
    of each row's largest |value| (bf16_steps, the dense decode's limit);
    both planted faults, each of which must fail TOL or that row limit
    where it applies (drop_stage: each rank skips its last stage, 1/256 of
    the keys at the 131,072-token row, which only the row limit sees;
    merge_short: the merge leaves out the last rank holding keys, which
    must be a bitwise no-op where no row's keys span two ranks); the
    device time of paged_attention.cu's wmma body on the same inputs (the
    body this decode took before; held to TOL too) and of the body at
    each split count. Returns the readings for the case's report."""
    import torch
    q, k, v, ks, vs = x["q"], x["k"], x["v"], x["ks"], x["vs"]
    table, pos = x["table"], x["pos"]
    b, h, kv, d = x["b"], x["h"], x["kv"], x["d"]
    p, m = k.shape[1], table.shape[1]
    plan = kern.paged_decode_plan(b, kv, h // kv, d, p, m, kern._num_sms(
        torch.cuda.current_device()), k.dtype)
    what = f"paged decode {pages} b={b} h={h}/{kv} d={d} window={window}"
    steps = bf16_steps(got, want)
    if steps > 1.0:
        raise AssertionError(f"{what}: {steps} bf16 steps of a row's "
                             f"largest |value| (limit 1)")
    # (max_abs_err, bf16 steps) of a planted fault's output
    reading = lambda y: (float((y.float() - want.float()).abs().max()),
                         bf16_steps(y, want))
    fails = lambda r: r[0] > TOL[pages] or r[1] > 1.0
    drop = reading(decode(drop_stage=True))
    if not fails(drop):
        raise AssertionError(f"{what}: every rank skipping its last stage "
                             f"passes TOL and the row limit {drop}")
    spans = [sum(1 for part in kern.paged_split_slots(
        c, p, m, window, plan.splits) if part) for c in pos.tolist()]
    short = decode(merge_short=True)
    if max(spans) >= 2:
        merge = reading(short)
        if not fails(merge):
            raise AssertionError(f"{what}: the merge without its last "
                                 f"rank passes TOL and the row limit "
                                 f"{merge}")
    elif torch.equal(short, got):
        merge = "no-op"
    else:
        raise AssertionError(f"{what}: merge_short changed a call whose "
                             f"rows each lie in one rank")
    old = lambda: kern._launch(q[:, 0, None], k, v, table, pos, ks, vs,
                               window, pos_offset=-1)[:, 0]
    old_err = reading(old())[0]
    if not old_err <= TOL[pages]:
        raise AssertionError(f"{what}: the wmma body of {kern.SOURCE} "
                             f"reads {old_err}")
    sweep = {s: device_ms(lambda: decode(splits=s), flush)
             for s in (1, 2, 4, 8) if s <= -(-m * p // kern.PAGED_KEYS)}
    out = {"splits": plan.splits, "stages": plan.stages,
           "smem": plan.smem, "ranks_with_keys": spans, "bf16_steps": steps,
           "planted_fault": {"drop_stage": drop, "merge_short": merge},
           "wmma_device_ms": device_ms(old, flush),
           "wmma_max_abs_err": old_err, "splits_device_ms": sweep}
    log(f"  {what}: {out}")
    return out


def shard_inputs(x, m: int, idx: int):
    """Rank ``idx`` of ``m`` along "model"'s share of a paged case's
    inputs, as the serving mesh hands them to the kernel: its block of the
    query heads and a contiguous pool of its KV-head block (split with the
    heads where the KV heads divide ``m``, else the GQA fallback's
    group-aligned block). Returns (inputs, (first KV head, KV heads))."""
    from repro_torch.kernels.ops import local_kv_block, paged_partition
    h, kv = x["h"], x["kv"]
    _, hm, kvm, _, _ = paged_partition({"model": m}, "data", "model",
                                       x["b"], h, kv)
    if hm is None:
        raise AssertionError(f"{h} heads do not split over model={m}")
    hl = h // m
    start, n = ((idx * (kv // m), kv // m) if kvm is not None
                else local_kv_block(h, kv, m, idx))
    block = slice(start, start + n)
    out = dict(x, h=hl, kv=n,
               q=x["q"][:, :, idx * hl:(idx + 1) * hl].contiguous())
    for key in ("k", "v", "ks", "vs"):
        if x[key] is not None:
            out[key] = x[key][:, :, block].contiguous()
    return out, (start, n)


def shard_kernel_case(kern, name: str, pages: str, *, t: int, m: int,
                      d: int = 64, window=None, **shape):
    """A paged kernel at one rank's shape on a (1, m) serving mesh: rank
    0's query heads over its KV-head block, held to the plain version on
    those inputs (kernel_case: limits, times, bound) and to the same heads
    of the plain version over the whole pool. A planted fault, the kernel
    reading another rank's KV-head block, must fail the limit."""
    import torch
    x = paged_inputs(name, pages, t=t, d=d, window=window, **shape)
    local, (start, n) = shard_inputs(x, m, 0)
    v = kernel_case(kern, name, pages, t=t, d=d, window=window,
                    inputs=local)
    wrong, (wstart, _) = shard_inputs(x, m, m - 1)
    wrong["q"] = local["q"]
    outs = {}
    for label, y in (("full", x), ("local", local), ("wrong", wrong)):
        kw = dict(k_scale=y["ks"], v_scale=y["vs"], window=window)
        if name == "paged_decode_attention":
            fn = kern.paged_decode_attention_plain if label == "full" \
                else kern.paged_decode_attention
            outs[label] = fn(y["q"][:, 0], y["k"], y["v"], y["table"],
                             y["pos"], **kw).float()
        else:
            fn = kern.paged_decode_span_attention_plain if label == "full" \
                else kern.paged_decode_span_attention
            outs[label] = fn(y["q"], y["k"], y["v"], y["table"], y["pos"],
                             **kw).float()
    torch.cuda.synchronize()
    want = outs["full"][..., :local["h"], :]
    full_err = float((outs["local"] - want).abs().max())
    block_fault = float((outs["wrong"] - want).abs().max())
    if full_err > TOL[pages]:
        raise AssertionError(f"{name} {pages} shard of model={m}: "
                             f"{full_err} from the whole pool's heads")
    if block_fault <= TOL[pages]:
        raise AssertionError(f"{name} {pages} shard of model={m}: the KV "
                             f"block of rank {m - 1} passes ({block_fault})")
    v.update(shard=f"rank 0 of model={m}: heads {local['h']} of "
                   f"{x['h']}, KV heads {start}..{start + n - 1} of "
                   f"{x['kv']}", full_pool_err=full_err,
             planted_fault_block=block_fault, wrong_block_start=wstart)
    return v


def gemm_inputs(xdt: str, wdt: str, *, t: int, d: int, f: int, e: int = 8,
                k: int = 2, bm: int = 8, seed: int = 0):
    """Inputs of a grouped MoE GEMM case on the card: t tokens routed
    top-k over e experts, sorted and padded by the real dispatch plan,
    and (e, d, f) weights (int8 with per-expert scales). Returns x, w,
    the tile ids, the scale (or None) and the plan's counts."""
    import torch
    from repro_torch.models.moe import (grouped_dispatch_plan,
                                        grouped_permute)

    dev = torch.device("cuda")
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[xdt]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    scores = torch.rand((t, e), generator=g, device=dev)
    gate_idx = torch.argsort(scores, dim=1)[:, :k].to(torch.int32)
    plan = grouped_dispatch_plan(gate_idx, n_experts=e, block_m=bm)
    x = grouped_permute(torch.randn((t, d), generator=g, device=dev), plan,
                        dtype)
    scale = None
    if wdt == "int8":
        w = torch.randint(-127, 128, (e, d, f), generator=g, device=dev,
                          dtype=torch.int8)
        scale = torch.rand((e,), generator=g, device=dev) * 1e-3 + 1e-4
    else:
        w = (torch.randn((e, d, f), generator=g, device=dev)
             * d ** -0.5).to(dtype)
    return x, w, plan.block_experts, scale, plan.counts


def gemm_case(name: str, xdt: str, wdt: str, *, t: int, d: int, f: int,
              e: int = 8, k: int = 2, bm: int = 8, all_pad: bool = False,
              seed: int = 0, body=None, ep=None):
    """The grouped MoE GEMM at one shape of the serving path: t tokens
    routed top-k over e experts, sorted and padded by the real dispatch
    plan, times (e, d, f) weights, through the body the host's plan picks
    (``body``: the other bf16 body forced instead). Also the same call
    with the tile ids rotated by one expert, a planted fault that must
    fail the limit. ``ep`` = (ranks, rank): that rank's share under
    expert parallelism over "data" (its contiguous block of the experts,
    the tile ids remapped into it, every other tile -1); the ranks'
    plain outputs must then sum to the one-device product, and a second
    planted fault, a non-local tile given a real expert id, must fail the
    limit. Returns its report dict."""
    import torch
    from repro_torch.kernels import moe_gemm, ref
    from repro_torch.kernels.ops import local_group_ids

    x, w, gids, scale, counts = gemm_inputs(xdt, wdt, t=t, d=d, f=f, e=e,
                                            k=k, bm=bm, seed=seed)
    if all_pad:
        gids = torch.full_like(gids, -1)
    shard = None
    if ep is not None:
        ranks, rank = ep
        el = e // ranks
        lo = rank * el
        full = (w, gids, scale)
        shard = lambda r: (
            full[0][r * el:(r + 1) * el].contiguous(),
            local_group_ids(full[1], r * el, el),
            None if full[2] is None else full[2][r * el:(r + 1) * el])
        w, gids, scale = shard(rank)
        pad = -(-counts // bm) * bm
        rows = (int(pad[:lo].sum()), int(pad[:lo + el].sum()))
        counts, e = counts[lo:lo + el], el
    plan = moe_gemm.grouped_plan(
        x.dtype, w.dtype, x.shape[0], gids.numel(), d, f, e,
        torch.cuda.get_device_properties(0).multi_processor_count)
    if body is not None and body != plan.body:
        plan = (moe_gemm.wgmma_plan() if body == "wgmma"
                else moe_gemm.stream_plan(w.dtype))
    run = lambda: moe_gemm.grouped_matmul(x, w, gids, w_scale=scale,
                                          plan=plan)
    plain = lambda: ref.grouped_matmul_ref(x, w, gids, w_scale=scale)
    before = moe_gemm.launches["grouped_matmul"]
    got, want = run(), plain()
    torch.cuda.synchronize()
    if moe_gemm.launches["grouped_matmul"] != before + 1:
        raise AssertionError(f"{name}: the wrapper did not count its launch")
    err = float((got.float() - want.float()).abs().max())
    big = float(want.float().abs().max())
    # f32: summation order over d terms, which grows as sqrt(d) (the limit
    # is 6-12x the error measured at d=64..16384; a product from inputs
    # rounded to TF32 or bf16 is 15x and more past it); bf16 out: one
    # bf16 step
    tol = (3 * d ** 0.5 * EPS32 * big if xdt == "f32"
           else 2 ** -7 * big) + 1e-6
    if not bool(torch.isfinite(got.float()).all()) or err > tol:
        raise AssertionError(f"{name} x={xdt} w={wdt} t={t} d={d} f={f} "
                             f"body={plan.body}: max_abs_err {err} > {tol}")
    if all_pad and big != 0.0:
        raise AssertionError(f"{name}: all -1 plan gave nonzero rows")
    # a planted fault: the tile ids rotated by one expert
    planted = None
    if not all_pad:
        bad = torch.where(gids >= 0, (gids + 1) % e, gids)
        planted = float((moe_gemm.grouped_matmul(
            x, w, bad, w_scale=scale, plan=plan).float()
            - want.float()).abs().max())
        if planted <= tol:
            raise AssertionError(f"{name} t={t} d={d} f={f}: ids rotated "
                                 f"by one expert pass the limit ({planted})")
    ep_info = {}
    if shard is not None:
        # the ranks' shares sum to the one-device product
        whole = ref.grouped_matmul_ref(x, full[0], full[1],
                                       w_scale=full[2]).float()
        total = sum(ref.grouped_matmul_ref(x, *shard(r)[:2],
                                           w_scale=shard(r)[2]).float()
                    for r in range(ranks))
        sum_err = float((total - whole).abs().max())
        if sum_err > tol:
            raise AssertionError(f"{name} ep {ep}: the ranks' sum is "
                                 f"{sum_err} from the whole product")
        # a planted fault: a non-local tile given a real expert id
        foreign = ((full[1] >= 0) & (gids < 0)).nonzero()
        bad = gids.clone()
        bad[int(foreign[0])] = 0
        nonlocal_fault = float((moe_gemm.grouped_matmul(
            x, w, bad, w_scale=scale, plan=plan).float()
            - want.float()).abs().max())
        if nonlocal_fault <= tol:
            raise AssertionError(f"{name} ep {ep}: a non-local tile with "
                                 f"a real id passes ({nonlocal_fault})")
        ep_info = {"ep": f"rank {rank} of data={ranks}: experts "
                         f"{lo}..{lo + el - 1}",
                   "tiles_minus_one": int((gids < 0).sum()),
                   "tiles": int(gids.numel()), "ep_sum_err": sum_err,
                   "planted_fault_nonlocal": nonlocal_fault}
    del got, want

    # torch._grouped_mm on the same sorted rows (bf16 only): the library's
    # time for the same product; the port never calls it (under expert
    # parallelism: the rows of this rank's experts)
    library = None
    if xdt == "bf16" and wdt == "bf16" and not all_pad:
        ends = torch.cumsum(-(-counts // bm) * bm, 0).to(torch.int32)
        xl = x if shard is None else x[rows[0]:rows[1]]
        library = lambda: torch._grouped_mm(xl, w, offs=ends)

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=x.device)
    times = case_times(run, plain, library, flush)

    # least time: the rows of live tiles read once, the weights of every
    # expert they route to read once, the output written once, and the
    # products of the live rows at the card's peak
    live = gids >= 0
    rows = int(live.sum()) * bm
    experts = torch.unique(gids[live]).numel()
    w_bytes = experts * d * f * w.element_size()
    nbytes = (rows * d * x.element_size() + w_bytes
              + x.shape[0] * f * x.element_size() + gids.numel() * 4
              + (0 if scale is None else e * 4))
    flops = 2.0 * rows * d * f
    peak = PEAK_FLOPS["float32" if xdt == "f32" else "bfloat16"]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    # what this body reads from device memory at the least: an expert's
    # weights once per chunk of its rows (64 rows: the stream body; 128:
    # the wgmma body, whose blocks running at once share 8 chunks' weight
    # panels in L2; 32: the f32 body)
    chunks, _ = moe_gemm.chunk_table(gids.tolist(), bm, e, plan.chunk_rows)
    reads = len(chunks)
    if plan.body == "wgmma":
        reads = sum(-(-sum(1 for c in chunks if c[2] == g) // 8)
                    for g in range(e))
    return {
        "name": name, "x": xdt, "w": wdt, "t": t, "d": d, "f": f, "e": e,
        "m": int(x.shape[0]), "experts": experts, "body": plan.body,
        "splits": plan.splits, "forced": body is not None,
        "grid": (None if plan.body == "fma"
                 else moe_gemm.built_grid(plan, w.dtype)),
        "max_abs_err": err, "max_abs_out": big, "tol": tol,
        "planted_fault": planted, **times,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
        "design_weight_bytes": reads * d * f * w.element_size(),
        **ep_info,
    }


def gemm_sweep(label: str, *, t: int, d: int, f: int, plans, e: int = 8,
               wdt: str = "bf16") -> None:
    """Device ms of the grouped GEMM (bf16 activations, ``wdt`` weights) at
    one shape under each forced plan, every output within one bf16 step
    of the plain version's: the readings behind moe_gemm.WGMMA_MIN_ROWS
    and STREAM_ROUNDS."""
    import torch
    from repro_torch.kernels import moe_gemm, ref

    x, w, gids, scale, _ = gemm_inputs("bf16", wdt, t=t, d=d, f=f, e=e)
    want = ref.grouped_matmul_ref(x, w, gids, w_scale=scale).float()
    tol = 2 ** -7 * float(want.abs().max()) + 1e-6
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=x.device)
    readings = []
    for plan in plans:
        run = lambda: moe_gemm.grouped_matmul(x, w, gids, w_scale=scale,
                                              plan=plan)
        err = float((run().float() - want).abs().max())
        if err > tol:
            raise AssertionError(f"sweep {label} {plan}: max_abs_err {err} "
                                 f"> {tol}")
        readings.append(f"{plan.body}/{plan.splits}"
                        f"({moe_gemm.built_grid(plan, w.dtype)} blocks)="
                        f"{device_ms(run, flush):.4f}")
    log(f"kernel grouped_matmul sweep {label} w={wdt} t={t} M={x.shape[0]} "
        f"D={d} F={f}: device_ms {' '.join(readings)}")


def matmul_case(in_dt: str, out_dt: str, m: int, k: int, n: int,
                seed: int = 0):
    """The matmul kernel at one shape: max error against its plain version
    (f32 out: within 4 * sqrt(K) * eps32 of max |out|, the summation order;
    bf16 out: one bf16 step of it), the reading of the kernel run with its
    last K tile skipped, which must fail the limit, times of the kernel,
    the plain version and torch.matmul, and the bound."""
    import torch
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    idt, odt = dt[in_dt], dt[out_dt]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    a = torch.randn((m, k), generator=g, device=dev).to(idt)
    b = torch.randn((k, n), generator=g, device=dev).to(idt)
    run = lambda: mm.matmul(a, b, out_dtype=odt)
    plain = lambda: ref.matmul_ref(a, b, odt)
    before = mm.launches["matmul"]
    got, want = run(), plain()
    torch.cuda.synchronize()
    if mm.launches["matmul"] != before + 1:
        raise AssertionError("matmul: the wrapper did not count its launch")
    err = float((got.float() - want.float()).abs().max())
    big = float(want.float().abs().max())
    tol = (2 ** -7 * big if odt == torch.bfloat16
           else 4 * k ** 0.5 * EPS32 * big) + 1e-6
    if not bool(torch.isfinite(got.float()).all()) or err > tol:
        raise AssertionError(f"matmul {in_dt}->{out_dt} ({m},{k},{n}): "
                             f"max_abs_err {err} > {tol}")
    # a planted fault: the kernel with the last K tile of its sum skipped
    kt = mm.K_TILE[idt]
    cut = k - (k % kt or kt)
    bad = mm.matmul(a[:, :cut].contiguous(), b[:cut].contiguous(),
                    out_dtype=odt)
    bad_err = float((bad.float() - want.float()).abs().max())
    if bad_err <= tol:
        raise AssertionError(f"matmul {in_dt}->{out_dt} ({m},{k},{n}): "
                             f"the last K tile skipped passes ({bad_err})")
    # torch.matmul in the inputs' dtype (TF32 off): the library's time
    library = lambda: torch.matmul(a, b)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    times = case_times(run, plain, library, flush)
    flops = 2.0 * m * n * k
    nbytes = (m * k + k * n) * a.element_size() + m * n * got.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS["float32" if in_dt == "f32" else "bfloat16"]
    return {
        "name": "matmul", "in": in_dt, "out": out_dt, "m": m, "k": k,
        "n": n, "max_abs_err": err, "tol": tol, "max_abs_out": big,
        "planted_fault": bad_err, **times,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }


def flash_splits(q, k, v, causal, window):
    """The key-range splits of a bf16 flash call (flash_plan); None for
    f32, whose body never splits."""
    import torch
    from repro_torch.kernels import flash_attention as flash
    if q.dtype != torch.bfloat16:
        return None
    return flash.flash_plan(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                            causal=causal, window=window,
                            num_sms=flash._num_sms(q.device.index)).splits


def flash_case(dtype: str, *, causal: bool = True, window=None, bh: int = 56,
               s: int = 2048, d: int = 64, drop_key_fault: bool = False,
               seed: int = 0):
    """The flash kernel at one shape: max error against its plain version
    (bf16: also row by row, and with a window, the reading of the kernel
    run with the window one key off, which must fail the limit; with
    ``drop_key_fault``, the reading of the kernel told S_k - 1 keys, which
    must fail it too), times of both and of SDPA on the same inputs, and
    the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as flash

    dev = torch.device("cuda")
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q, k, v = (torch.randn((bh, s, d), generator=g, device=dev).to(dt)
               for _ in range(3))
    run = lambda: flash.flash_attention(q, k, v, causal=causal,
                                        window=window)
    plain = lambda: flash.flash_attention_plain(q, k, v, causal=causal,
                                                window=window)
    before = flash.launches["flash_attention"]
    got, want = run(), plain()
    torch.cuda.synchronize()
    if flash.launches["flash_attention"] != before + 1:
        raise AssertionError("flash: the wrapper did not count its launch")
    err = float((got.float() - want.float()).abs().max())
    steps = row_steps(got, want) if dtype == "bf16" else None
    if (not bool(torch.isfinite(got.float()).all()) or err > TOL[dtype]
            or (steps is not None and steps > FLASH_ROW_C)):
        raise AssertionError(f"flash_attention {dtype} bh={bh} s={s} d={d} "
                             f"causal={causal} window={window}: "
                             f"max_abs_err {err} (limit {TOL[dtype]}), "
                             f"row steps {steps} (limit {FLASH_ROW_C})")
    # a planted fault: the window one key short and one key long, or the
    # kernel told S_k - 1 keys
    planted, faults = [], []
    for w in ((window - 1, window + 1) if window is not None else ()):
        faults.append((f"window {w} instead of {window}",
                       dict(causal=causal, window=w)))
    if drop_key_fault:
        faults.append(("S_k - 1 keys", dict(causal=causal, window=window,
                                            drop_last_key=True)))
    for what, kw in faults:
        bad = flash.flash_attention(q, k, v, **kw)
        bad_err = float((bad.float() - want.float()).abs().max())
        reading = (row_steps(bad, want) if dtype == "bf16" else bad_err)
        planted.append(reading)
        if bad_err <= TOL[dtype] and (dtype != "bf16"
                                      or reading <= FLASH_ROW_C):
            raise AssertionError(f"flash_attention {dtype} bh={bh} s={s}: "
                                 f"{what} passes the limit ({reading})")
    # SDPA on the same (BH, S, D) inputs: the library's time. A window
    # needs a materialized boolean mask, which rules out SDPA's flash
    # backend: that reading is a handicapped yardstick
    mask = None
    if window is not None:
        pos = torch.arange(s, device=dev)
        diff = pos[:, None] - pos[None, :]
        mask = (diff < window) & ((diff >= 0) if causal else True)
    q4, k4, v4 = q[None], k[None], v[None]  # (1, BH, S, D): SDPA's layout
    library = lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, is_causal=causal and mask is None)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    times = case_times(run, plain, library, flush, plain_iters=5)
    # least time: q, k, v read once, out written once; 4 * D flops per
    # (query, allowed key) pair, counted from the mask
    qi = torch.arange(s, device=dev, dtype=torch.float64)
    if window is None:
        keys = qi + 1 if causal else torch.full_like(qi, s)
    else:
        hi = qi + 1 if causal else torch.full_like(qi, s)
        keys = hi - torch.clamp(qi - window + 1, min=0)
    pairs = float(keys.sum())
    flops = 4.0 * d * bh * pairs
    nbytes = 4 * bh * s * d * q.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS["float32" if dtype == "f32" else "bfloat16"]
    return {
        "name": "flash_attention", "dtype": dtype, "bh": bh, "s": s, "d": d,
        "causal": causal, "window": window, "splits": flash_splits(q, k, v,
                                                                  causal,
                                                                  window),
        "max_abs_err": err,
        "row_steps": steps, "planted_fault": planted,
        "fault": "; ".join(what for what, _ in faults) or "none", **times,
        "library": ("SDPA, materialized mask (no flash backend)"
                    if mask is not None else "SDPA"),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }


def bf16_steps(got, want) -> float:
    """max |got - want| in bf16 steps of its row's largest |want| (the
    spacing of bf16 values at that magnitude)."""
    import torch
    err = (got.float() - want.float()).abs()
    top = want.float().abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    step = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return float((err / step).max())


# (label, H, KV, D, W, pos of each row, window): head shapes of phi4-mini,
# qwen2.5-3B, internlm2 and Mixtral; rings of 4096 slots with wrapped rows,
# a ragged 1000-slot ring, rows at pos 0 (no valid key: the uniform mean),
# a window below the ring width, phi4's serving shape (the dense serve's
# window of 1056 slots, B = 4), and Whisper-small's decoder at the serve's
# max_batch 4 (12 heads of 64, g = 1): self attention over its 448-slot
# text window, cross attention over the 1500 encoder frames
DENSE_CASES = (
    ("phi4_serve", 24, 8, 128, 1056, (211, 530, 817, 1050), None),
    ("phi4_ring", 24, 8, 128, 4096, (0, 1000, 4096, 6000), None),
    ("phi4_ragged", 24, 8, 128, 1000, (1, 999, 1000, 2345), None),
    ("qwen2_5_3b", 16, 2, 128, 4096, (64, 1024, 4095, 4500), None),
    ("internlm2", 16, 8, 128, 1000, (0, 500, 1000, 1001), None),
    ("mixtral_ring", 48, 8, 128, 4096, (1000, 4096, 4400, 9000), 4096),
    ("mixtral_window", 48, 8, 128, 4096, (300, 2000, 4500, 9000), 512),
    ("whisper_self", 12, 12, 64, 448, (5, 40, 97, 128), None),
    ("whisper_cross", 12, 12, 64, 1500, (1500, 1500, 1500, 1500), None),
)
DENSE_F32_TOL = 1e-5  # fp32 rounding of the same sums in another order


def dense_case(label: str, dtype: str, h: int, kv: int, d: int, w: int,
               pos, window=None, seed: int = 0):
    """The dense ring decode kernel at one shape: max error against its
    plain version (f32: within DENSE_F32_TOL; bf16: within one bf16 step
    of each row's largest |value|, both sides rounding an fp32 result),
    the reading of the kernel run at pos - 1 (one key dropped), which must
    fail the limit, times of the kernel, the plain version and SDPA over
    the same ring with its validity mask, and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as kern

    dev = torch.device("cuda")
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    b = len(pos)
    q = torch.randn((b, h, d), generator=g, device=dev).to(dt)
    kc = torch.randn((b, w, kv, d), generator=g, device=dev).to(dt)
    vc = torch.randn((b, w, kv, d), generator=g, device=dev).to(dt)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    run = lambda: kern.decode_attention(q, kc, vc, p, window=window)
    plain = lambda: kern.decode_attention_plain(q, kc, vc, p, window=window)
    before = kern.launches["decode_attention"]
    got, want = run(), plain()
    torch.cuda.synchronize()
    if kern.launches["decode_attention"] != before + 1:
        raise AssertionError("decode_attention: the wrapper did not count "
                             "its launch")
    err = float((got.float() - want.float()).abs().max())

    def reading(x):
        return (bf16_steps(x, want) if dtype == "bf16"
                else float((x.float() - want.float()).abs().max()))

    limit = 1.0 if dtype == "bf16" else DENSE_F32_TOL
    if not bool(torch.isfinite(got.float()).all()) or reading(got) > limit:
        raise AssertionError(f"decode_attention {label} {dtype}: reading "
                             f"{reading(got)} > {limit} (max_abs_err "
                             f"{err})")
    bad = kern.decode_attention(q, kc, vc, p - 1, window=window)
    planted = reading(bad)
    if planted <= limit:
        raise AssertionError(f"decode_attention {label} {dtype}: the kernel"
                             f" at pos - 1 passes the limit ({planted})")

    # SDPA over the same ring with the validity mask: the library's time
    slot = torch.arange(w, device=dev)[None, :]
    pl = p[:, None].long()
    abs_pos = slot + torch.clamp(pl - 1 - slot, min=0) // w * w
    valid = abs_pos < pl
    if window is not None:
        valid &= abs_pos >= pl - window
    kh = kc.repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
    vh = vc.repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
    qh = q[:, :, None]  # (B, H, 1, D)
    bias = torch.where(valid, 0.0, -1e30).to(dt)[:, None, None, :]
    library = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                     attn_mask=bias)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    times = case_times(run, plain, library, flush)

    # least time: each valid key and value read once (a row with none
    # averages all W values), q read once, out written once; 4 * D flops
    # per (query head, valid key)
    n_valid = valid.sum(-1)
    elem = kc.element_size()
    kv_bytes = float((n_valid * 2 + (n_valid == 0) * w).sum()) * kv * d * elem
    nbytes = kv_bytes + 2 * q.numel() * elem + b * 4
    flops = 4.0 * d * h * float(n_valid.sum()) \
        + 2.0 * d * h * float(((n_valid == 0) * w).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS["float32" if dtype == "f32" else "bfloat16"]
    return {
        "name": "decode_attention", "label": label, "dtype": dtype, "b": b,
        "splits": kern.dense_plan(dt, b, kv, w, kern._num_sms(
            torch.cuda.current_device())),
        "h": h, "kv": kv, "d": d, "w": w, "pos": list(pos),
        "window": window, "max_abs_err": err, "reading": reading(got),
        "limit": limit, "planted_fault": planted, **times,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }


# (label, B, S, H, hd, chunk, nonzero s0, front pad, in place): rwkv6-1.6B's
# heads (32 x 64) at a bucketed 1024-token prefill from a zero state, a
# batch of 16-token spans, chunks of 8 and 13 (fit_chunk of S 8 and 13), the
# decode shape (B 4, S 1, chunk 1), the smoke width hd 16, a row
# front-padded with zeros for its first half, generate_pertoken's 97-token
# prompt (prime: chunk 1), chunk 10 at 200 tokens (20 chunks in groups of
# 6), and a batch of 256-token spans from a nonzero state whose final state
# is written over it (the serving cache row)
WKV_CASES = (
    ("prefill_1024", 1, 1024, 32, 64, 16, False, False, False),
    ("batch4_s16", 4, 16, 32, 64, 16, True, False, False),
    ("s8_chunk8", 4, 8, 32, 64, 8, True, False, False),
    ("s13_chunk13", 4, 13, 32, 64, 13, True, False, False),
    ("decode", 4, 1, 32, 64, 1, True, False, False),
    ("smoke_hd16", 2, 48, 4, 16, 16, True, False, False),
    ("front_pad", 1, 256, 32, 64, 16, False, True, False),
    ("s97_chunk1", 1, 97, 32, 64, 1, True, False, False),
    ("s200_chunk10", 1, 200, 32, 64, 10, True, False, False),
    ("span256_in_place", 4, 256, 32, 64, 16, True, False, True),
)
# the split body at every G: (label, B, S, H, hd, chunk, groups); G 64 at
# 1024 tokens is one group, a block a head walking all 64 chunks in series
WKV_SWEEPS = (
    ("prefill_1024", 1, 1024, 32, 64, 16, (1, 2, 4, 8, 16, 64)),
    ("s97_chunk1", 1, 97, 32, 64, 1, (4, 8, 16, 32, 64)),
)
# the WKV's limit, of the case's largest |want| (at least 1): f32 sums in
# another order, and the cumulative log decay's rounding, which the
# factors exp(cum_excl) and exp(-cum) (up to e^64 at chunk 16) carry
WKV_LIMIT = 1e-5


def _wkv_inputs(b: int, s: int, h: int, hd: int, with_s0: bool,
                front_pad: bool, seed: int = 0):
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    shape = (b, s, h, hd)
    r, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
    lw = torch.clamp(-torch.exp(torch.randn(shape, generator=g, device=dev)),
                     -4.0, 0.0)
    u = torch.randn((h, hd), generator=g, device=dev) * 0.5
    s0 = (torch.randn((b, h, hd, hd), generator=g, device=dev) * 0.3
          if with_s0 else None)
    if front_pad:  # a zeroed pad prefix, as a bucketed prefill feeds it
        for x in (r, k, v):
            x[:, :s // 2] = 0.0
    return r, k, v, lw, u, s0


def _wkv_blocks(plan) -> int:
    """Blocks a call of ``plan`` launches, its kernels together (the split
    body's state pass has the output pass's grid)."""
    blocks = math.prod(plan.grid) * (2 if plan.body == "split" else 1)
    return blocks + (math.prod(plan.scan_grid) if plan.scan_grid else 0)


def wkv_case(label: str, b: int, s: int, h: int, hd: int, chunk: int,
             with_s0: bool, front_pad: bool, in_place: bool, seed: int = 0):
    """The chunked WKV kernel at one shape, through the body wkv_plan picks:
    max error of out and of the final state against the plain version
    (within WKV_LIMIT of the case's largest |want|), the readings of two
    planted faults that must fail the limit (no current-token bonus; the
    output pass started one group behind, a no-op with one group), times,
    and the bound. ``in_place``: the final state is written over the
    initial one, which must give the out-of-place call's bits, and that is
    the call timed. No single PyTorch call computes this recurrence:
    library_ms is None."""
    import torch
    from repro_torch.kernels import rwkv_scan

    r, k, v, lw, u, s0 = _wkv_inputs(b, s, h, hd, with_s0, front_pad, seed)
    plan = rwkv_scan.wkv_plan(b, s, h, hd, chunk)
    run = lambda: rwkv_scan.rwkv_wkv(r, k, v, lw, u, s0, chunk=chunk)
    plain = lambda: rwkv_scan.chunked_wkv_plain(r, k, v, lw, u, s0,
                                                chunk=chunk)
    before = rwkv_scan.launches["rwkv_wkv"]
    (got, got_s), (want, want_s) = run(), plain()
    torch.cuda.synchronize()
    if rwkv_scan.launches["rwkv_wkv"] != before + 1:
        raise AssertionError("rwkv_wkv: the wrapper did not count its launch")

    def reading(x, y):
        return float((x - y).abs().max())

    err = max(reading(got, want), reading(got_s, want_s))
    limit = WKV_LIMIT * max(1.0, float(want.abs().max()),
                            float(want_s.abs().max()))
    if (not bool(torch.isfinite(got).all())
            or not bool(torch.isfinite(got_s).all()) or err > limit):
        raise AssertionError(f"rwkv_wkv {label}: max_abs_err {err} > "
                             f"{limit}")
    if in_place:  # the final state over the initial one: the same bits
        state = s0.clone()
        out_ip, s_ip = rwkv_scan.rwkv_wkv(r, k, v, lw, u, state,
                                          chunk=chunk, state_out=state)
        if (s_ip is not state or not torch.equal(out_ip, got)
                or not torch.equal(state, got_s)):
            raise AssertionError(f"rwkv_wkv {label}: in place differs from "
                                 f"out of place")
        run = lambda: rwkv_scan.rwkv_wkv(r, k, v, lw, u, state, chunk=chunk,
                                         state_out=state)
    bad, _ = rwkv_scan.rwkv_wkv(r, k, v, lw, u, s0, chunk=chunk,
                                skip_bonus=True)
    planted = reading(bad, want)
    if planted <= limit:
        raise AssertionError(f"rwkv_wkv {label}: the kernel without the "
                             f"bonus passes the limit ({planted})")
    stale, _ = rwkv_scan.rwkv_wkv(r, k, v, lw, u, s0, chunk=chunk,
                                  stale_state=True)
    stale_fault = reading(stale, want)
    if plan.n_groups > 1 and stale_fault <= limit:
        raise AssertionError(f"rwkv_wkv {label}: the output pass one group "
                             f"behind passes the limit ({stale_fault})")
    if plan.n_groups == 1 and not torch.equal(stale, got):
        raise AssertionError(f"rwkv_wkv {label}: stale_state changed a "
                             f"one-group call")
    if front_pad:  # out and the state exactly 0 through the pad prefix
        half = [x[:, :s // 2].contiguous() for x in (r, k, v, lw)]
        _, head_s = rwkv_scan.rwkv_wkv(*half, u, chunk=chunk)
        if bool((got[:, :s // 2] != 0).any()) or bool((head_s != 0).any()):
            raise AssertionError(f"rwkv_wkv {label}: a zero pad prefix "
                                 f"left nonzero outputs or state")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    times = case_times(run, plain, None, flush, plain_iters=5)
    # least time: r, k, v, logw read once and out written once, u and the
    # initial state read once, the final state written once; f32 flops
    # ~ B*H*S*(4*hd^2 + 4*chunk*hd) (inter, state update, scores, intra)
    nbytes = 4.0 * (5 * b * s * h * hd + h * hd
                    + (2 if with_s0 else 1) * b * h * hd * hd)
    flops = float(b * h * s * (4 * hd * hd + 4 * chunk * hd))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS["float32"]
    return {
        "name": "rwkv_wkv", "label": label, "b": b, "s": s, "h": h,
        "hd": hd, "chunk": chunk, "s0": with_s0, "front_pad": front_pad,
        "in_place": in_place, "body": plan.body, "group": plan.group,
        "n_groups": plan.n_groups,
        "blocks": _wkv_blocks(plan),
        "max_abs_err": err, "limit": limit, "planted_fault": planted,
        "stale_fault": stale_fault, **times,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }


def wkv_sweep(label: str, b: int, s: int, h: int, hd: int, chunk: int,
              groups) -> None:
    """Device ms of the split body forced at each G, each held to
    WKV_LIMIT, beside the plan's own choice, with each of its kernels'
    device ms a call (state pass, scan, output pass) from one profile: the
    measurement behind rwkv_scan.MAX_GROUP and the rule of wkv_plan."""
    import torch
    from repro_torch.kernels import rwkv_scan

    r, k, v, lw, u, s0 = _wkv_inputs(b, s, h, hd, True, False, seed=3)
    want, want_s = rwkv_scan.chunked_wkv_plain(r, k, v, lw, u, s0,
                                               chunk=chunk)
    limit = WKV_LIMIT * max(1.0, float(want.abs().max()),
                            float(want_s.abs().max()))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    planned = rwkv_scan.wkv_plan(b, s, h, hd, chunk)
    readings = []
    for g in groups:
        plan = rwkv_scan.make_plan("split", b, s, h, hd, chunk, group=g)
        fn = lambda: rwkv_scan.rwkv_wkv(r, k, v, lw, u, s0, chunk=chunk,
                                        plan=plan)
        got, got_s = fn()
        err = max(float((got - want).abs().max()),
                  float((got_s - want_s).abs().max()))
        if err > limit:
            raise AssertionError(f"wkv sweep {label} G={g}: max_abs_err "
                                 f"{err} > {limit}")
        parts = []
        rows = _profiled(fn, flush, 20)
        for kernel in WKV_KERNELS:  # its mean a launch, once a call
            mine = [(us, n) for name, us, n in rows if kernel in name]
            if mine:
                ms = sum(us / n for us, n in mine) / 1e3
                parts.append(f"{kernel} {ms:.4f}")
        readings.append(f"G={g} ({plan.n_groups} groups) "
                        f"{device_ms(fn, flush):.4f} ({'; '.join(parts)})")
    log(f"kernel rwkv_wkv sweep {label} b={b} s={s} h={h} hd={hd} "
        f"chunk={chunk}, device ms of the split body: " + "; ".join(readings)
        + f"; the plan takes {planned.body} G={planned.group}")


# (label, V, D, N, bag, kind): the DLRM example's three tables (N 256, bag
# 4), the JAX tests' shapes, a ragged D (scalar loads), repeated indices in
# every bag, negative and out-of-range indices, bags of one index with
# weight 1 (the row itself, exactly), and one table at the scale of MLPerf
# Training's DLRM-DCNv2 (Criteo 1TB multi-hot): 40M rows, the cap of its
# largest tables, 128 wide, N 8192 bags of 100, its largest multi-hot bag
GATHER_CASES = (
    ("dlrm_user", 5000, 32, 256, 4, "uniform"),
    ("dlrm_item", 20000, 32, 256, 4, "uniform"),
    ("dlrm_cat", 200, 16, 256, 4, "uniform"),
    ("jax_128x64", 128, 64, 16, 4, "uniform"),
    ("jax_512x128", 512, 128, 8, 8, "uniform"),
    ("ragged_d37", 1000, 37, 64, 5, "uniform"),
    ("repeated", 50, 64, 128, 16, "repeat"),
    ("out_of_range", 1000, 32, 64, 6, "oob"),
    ("bag1_weight1", 127, 32, 127, 1, "one_hot"),
    ("dcnv2_40m", 40_000_000, 128, 8192, 100, "uniform"),
)
# f32: of the case's largest |want| (fmaf against a product and a sum in
# the plain version); bf16: one bf16 step of each row's largest |want|
GATHER_F32_LIMIT = 1e-5


def gather_case(label: str, dtype: str, v: int, d: int, n: int, bag: int,
                kind: str, seed: int = 0):
    """The embedding-bag kernel at one shape: its reading against the
    plain version (and, for bags of one index with weight 1, equality with
    the row), the reading of the kernel without the bag's last position,
    which must fail the limit, times of the kernel, the plain version and
    F.embedding_bag on the same inputs, and the bound. The table is freed
    before the case returns."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import sparse_gather as sg

    dev = torch.device("cuda")
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    table = torch.randn((v, d), generator=g, device=dev).to(dt)
    idx = torch.randint(0, v, (n, bag), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.randn((n, bag), generator=g, device=dev)
    if kind == "repeat":  # every bag names its first row again
        idx[:, bag // 2:] = idx[:, :1]
    elif kind == "oob":  # wrap once then clamp, as JAX's gather
        idx[:, 0] = -1
        idx[:, 1] = v + 2
        idx[:, 2] = -v - 4
        idx[::2, 3] = -torch.arange(1, n // 2 + 1, device=dev,
                                    dtype=torch.int32)
    elif kind == "one_hot":
        idx[:, 0] = torch.arange(n, device=dev, dtype=torch.int32) % v
        w.fill_(1.0)
    run = lambda: sg.sparse_gather_sum(table, idx, w)
    plain = lambda: sg.sparse_gather_sum_plain(table, idx, w)
    before = sg.launches["sparse_gather_sum"]
    got, want = run(), plain()
    torch.cuda.synchronize()
    if sg.launches["sparse_gather_sum"] != before + 1:
        raise AssertionError("sparse_gather_sum: the wrapper did not count "
                             "its launch")
    err = float((got.float() - want.float()).abs().max())

    def reading(x):
        if dtype == "bf16":
            return bf16_steps(x, want)
        return (float((x.float() - want.float()).abs().max())
                / max(float(want.float().abs().max()), 1e-30))

    limit = 1.0 if dtype == "bf16" else GATHER_F32_LIMIT
    got_reading = reading(got)
    if not bool(torch.isfinite(got.float()).all()) or got_reading > limit:
        raise AssertionError(f"sparse_gather_sum {label} {dtype}: reading "
                             f"{got_reading} > {limit} (max_abs_err {err})")
    rows = sg.table_rows(idx, v)
    if kind == "one_hot" and not torch.equal(got, table[rows[:, 0]]):
        raise AssertionError(f"sparse_gather_sum {label} {dtype}: a bag of "
                             f"one row with weight 1 is not the row")
    planted = reading(sg.sparse_gather_sum(table, idx, w, skip_last=True))
    if planted <= limit:
        raise AssertionError(f"sparse_gather_sum {label} {dtype}: the kernel"
                             f" without the last bag position passes the "
                             f"limit ({planted})")
    # F.embedding_bag over the rows the gather reads (it refuses indices
    # out of range) with the weights in the table's dtype, as it requires
    w_lib = w.to(dt)
    library = lambda: F.embedding_bag(rows, table, mode="sum",
                                      per_sample_weights=w_lib)
    lib_err = float((library().float() - want.float()).abs().max())
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    times = case_times(run, plain, library, flush, plain_iters=5)
    # least time: each distinct row these indices name read once, idx and
    # w read once, out written once; 2 flops per weighted element (f32)
    unique = int(torch.unique(rows).numel())
    elem = table.element_size()
    nbytes = float(unique * d * elem + n * bag * 8 + n * d * elem)
    flops = 2.0 * n * bag * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS["float32"]
    del table, idx, w, w_lib, rows, got, want
    torch.cuda.empty_cache()
    return {
        "name": "sparse_gather_sum", "label": label, "dtype": dtype,
        "v": v, "d": d, "n": n, "bag": bag, "kind": kind,
        "unique_rows": unique, "max_abs_err": err, "reading": got_reading,
        "limit": limit, "planted_fault": planted,
        "library_max_abs_err": lib_err, **times,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }


def flash_cross_case(dtype: str, sq: int, sk: int = 1500, bh: int = 12,
                     d: int = 64, seed: int = 0):
    """The flash kernel with keys of another length than the queries
    (bidirectional): Whisper-small's cross-attention, 12 heads x 64 over
    its 1500 encoder frames, at a decode prompt's S_q. The limits of
    flash_case; the kernel told S_k - 1 keys (a planted fault) must fail
    them. Inputs are drawn on the CPU from the seed."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as flash

    dev = torch.device("cuda")
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((bh, sq, d), generator=g).to(dt).to(dev)
    k, v = (torch.randn((bh, sk, d), generator=g).to(dt).to(dev)
            for _ in range(2))
    run = lambda: flash.flash_attention(q, k, v, causal=False)
    plain = lambda: flash.flash_attention_plain(q, k, v, causal=False)
    before = flash.launches["flash_attention"]
    got, want = run(), plain()
    torch.cuda.synchronize()
    if flash.launches["flash_attention"] != before + 1:
        raise AssertionError("flash: the wrapper did not count its launch")
    err = float((got.float() - want.float()).abs().max())
    steps = row_steps(got, want) if dtype == "bf16" else None
    if (not bool(torch.isfinite(got.float()).all()) or err > TOL[dtype]
            or (steps is not None and steps > FLASH_ROW_C)):
        raise AssertionError(f"flash_attention cross {dtype} sq={sq} sk={sk}"
                             f": max_abs_err {err} (limit {TOL[dtype]}), "
                             f"row steps {steps} (limit {FLASH_ROW_C})")
    bad = flash.flash_attention(q, k, v, causal=False, drop_last_key=True)
    bad_err = float((bad.float() - want.float()).abs().max())
    planted = row_steps(bad, want) if dtype == "bf16" else bad_err
    if bad_err <= TOL[dtype] and (dtype != "bf16"
                                  or planted <= FLASH_ROW_C):
        raise AssertionError(f"flash_attention cross {dtype}: S_k - 1 keys "
                             f"pass the limit ({planted})")
    library = lambda: F.scaled_dot_product_attention(q[None], k[None],
                                                     v[None])
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    times = case_times(run, plain, library, flush, plain_iters=5)
    flops = 4.0 * d * bh * sq * sk
    nbytes = 2 * bh * (sq + sk) * d * q.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS["float32" if dtype == "f32" else "bfloat16"]
    return {
        "name": "flash_attention", "dtype": dtype, "bh": bh, "s": sq,
        "sk": sk, "d": d, "causal": False, "window": None,
        "splits": flash_splits(q, k, v, False, None),
        "max_abs_err": err, "row_steps": steps, "planted_fault": [planted],
        "fault": "S_k - 1 keys", **times,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }


# ------------------------------------------------------------------- serve


def serve_requests(vocab: int, seed: int, n: int = 8, max_new: int = 32,
                   long_prompt: int = 0):
    """n prompts of 100-600 tokens; the first half share a 256-token
    prefix (a system prompt), so the prefix cache has work. With
    ``long_prompt``, one more request of that many prompt tokens and
    2 * max_new new ones."""
    import numpy as np
    from repro_torch.serve.scheduler import Request
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 256)
    reqs = []
    for rid in range(n):
        if rid < n // 2:
            tail = rng.integers(0, vocab, int(rng.integers(1, 345)))
            prompt = np.concatenate([shared, tail])
        else:
            prompt = rng.integers(0, vocab, int(rng.integers(100, 601)))
        reqs.append(Request(rid=rid, prompt=prompt, max_new=max_new))
    if long_prompt:
        reqs.append(Request(rid=n, prompt=rng.integers(0, vocab, long_prompt),
                            max_new=2 * max_new))
    return reqs


def reset_counts(mods) -> None:
    for mod in mods:
        mod.reset_launches()


def read_counts(mods):
    counts = {}
    for mod in mods:
        counts.update(mod.launches)
    return counts


def dense_requests(vocab: int, seed: int, lens, max_new: int):
    import numpy as np
    from repro_torch.serve.scheduler import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, n),
                    max_new=max_new) for i, n in enumerate(lens)]


def _window(reqs) -> int:
    w = max(len(r.prompt) + r.max_new for r in reqs)
    return -(-w // 16) * 16


def dense_decode_launches(label, engine, counts, n_layers) -> None:
    """Every decode step runs the dense kernel once per layer."""
    steps = engine.counters["decode_steps"]
    if steps == 0 or counts["decode_attention"] != n_layers * steps:
        raise AssertionError(f"{label}: decode_attention launches "
                             f"{counts['decode_attention']} != {n_layers} x "
                             f"{steps} decode steps")


def span_route_launches(label, engine, counts, n_layers) -> None:
    """A bf16 paged serve: every span call (chunked and suffix prefill
    and, with draft_k, each verify step) launches the span kernel once per
    layer, and every launch goes through the span kernel's source; every
    one-token decode launch goes through the bf16 decode body's."""
    from repro_torch.kernels import decode_attention as kern
    n_dec = counts["paged_decode_attention"]
    if kern.decode_launches[kern.PAGED_DECODE_SOURCE] != n_dec:
        raise AssertionError(f"{label}: decode launches {n_dec} (through "
                             f"{kern.decode_launches}), not all through "
                             f"{kern.PAGED_DECODE_SOURCE}")
    calls = engine.counters["prefill_span_calls"]
    if engine.draft_k:
        calls += engine.counters["decode_steps"]
    n = counts["paged_decode_span_attention"]
    if (calls == 0 or n != n_layers * calls
            or kern.span_launches[kern.SPAN_SOURCE] != n):
        raise AssertionError(f"{label}: span launches {n} (through "
                             f"{kern.span_launches}) != {n_layers} x "
                             f"{calls} span calls, all through "
                             f"{kern.SPAN_SOURCE}")
    log(f"  span launches {n} = {n_layers} x {calls} span calls, all "
        f"through {kern.SPAN_SOURCE}; decode launches {n_dec}, all "
        f"through {kern.PAGED_DECODE_SOURCE}")


def serve_run(label, mods, engine, params, reqs, vocab, need):
    """One run of a serving path with every launch counter set to 0 just
    before it and read just after. Every request is served, unless the
    engine's fault schedule failed it or its admission policy shed it;
    the served tokens must be whole and in range."""
    import torch
    from repro_torch.launch.serve import slo_line
    reset_counts(mods)
    t0 = time.perf_counter()
    out = engine.run(params, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(mods)
    toks = sum(len(v) for v in out.values())
    s = engine.scheduler
    lost = [r.rid for r in s.failed] + [r.rid for r in s.shed]
    if sorted(list(out) + lost) != sorted(r.rid for r in reqs):
        raise AssertionError(f"{label}: served {sorted(out)}, lost {lost}")
    for r in reqs:
        got = out.get(r.rid)
        if got is not None and (len(got) != r.max_new or got.min() < 0
                                or got.max() >= vocab):
            raise AssertionError(f"{label}: request {r.rid} gave {got}")
    for name in need:
        if counts[name] == 0:
            raise AssertionError(f"{label}: {name} never launched")
    faults = {k: v for k, v in engine.fault_stats.items() if v}
    log(f"serve[{label}]: {len(out)} of {len(reqs)} requests {toks} tokens "
        f"{wall:.3f}s {toks / wall:.1f} tok/s "
        f"host_syncs={engine.counters['host_syncs']} "
        f"chunks={engine.counters['chunks']} "
        f"pages_trimmed={engine.counters['pages_trimmed']} "
        f"prefix_hit_rate={engine.prefix_hit_rate:.3f} "
        f"acceptance_length={engine.acceptance_length:.2f} "
        f"stats={s.stats} faults={faults} launches={counts}")
    log(f"  {slo_line(engine)}")
    return out, counts, wall


def device_profiler():
    """torch.profiler recording the card's activity only (kernels, copies
    and the CUDA runtime calls that launch them): the busy share and the
    kernel table read nothing else, and the host's op events, three or
    more for each kernel, took about half of this script's time to
    process."""
    import torch
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def read_profile(prof, wall_s: float, top: int = 12) -> float:
    """``print_profile``'s busy share of a profiled window, which must
    hold device time."""
    from repro_torch.launch.serve import print_profile
    busy = print_profile(prof, wall_s, top=top)
    if not busy > 0:
        raise AssertionError("the profile recorded no device time")
    return busy


def profiled_serve(label, engine, params, reqs, wall=None) -> None:
    """A serve on a fresh engine under torch.profiler: the device-busy
    share of its wall and the kernels that took the most device time.
    ``wall``: the unprofiled wall of the same serve, when it ran."""
    import torch
    with device_profiler() as prof:
        t0 = time.perf_counter()
        engine.run(params, reqs)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    log(f"profile[{label}]: {len(reqs)} requests"
        + ("" if wall is None else
           f", unprofiled wall of the same run {wall:.3f}s"))
    t0 = time.perf_counter()
    read_profile(prof, prof_wall)
    rows = list(_device_rows(prof))
    for what, names in (("grouped GEMM", GROUPED_KERNELS),
                        ("WKV", WKV_KERNELS),
                        ("paged decode", PAGED_DECODE_KERNELS)):
        mine = [(name, us, count) for name, us, count in rows
                if any(k in name for k in names)]
        if mine:
            log(f"profile[{label}]: {what} kernels "
                f"{sum(us for _, us, _ in mine) / 1e3:.3f} ms of device "
                f"time: " + "; ".join(f"{name[:60]} {us / 1e3:.3f} ms "
                                      f"{count}x" for name, us, count in mine))
    log(f"profile[{label}]: its events read in "
        f"{time.perf_counter() - t0:.1f}s of the host")


def _fresh(req):
    """An unserved copy of a request, its extras included."""
    out = type(req)(rid=req.rid, prompt=req.prompt, max_new=req.max_new)
    out.extras = dict(req.extras)
    return out


def f32_equality(label, mods, cfg, params, reqs, need, trim=False,
                 paged=True, pertoken=None, launches=None,
                 pertoken_need=("flash_attention", "decode_attention")):
    """Greedy tokens through the kernels equal the plain path's (f32,
    TF32 off). With ``trim``, both runs must have trimmed pages. With
    ``paged=False`` the runs take the dense backend, whose kernel launches
    ``launches(label, engine, counts)`` checks (default: the dense kernel
    once per layer and decode step); ``pertoken`` is a batch that
    generate_pertoken must then decode to equal tokens too, through the
    kernels ``pertoken_need``."""
    import torch
    from repro_torch.models.blocks import ModelContext
    from repro_torch.serve.engine import ServeEngine
    outs, pert = {}, {}
    for impl in ("cuda", "ref"):
        ctx = ModelContext(compute_dtype=torch.float32, attn_impl=impl,
                           device="cuda")
        engine = ServeEngine(cfg, ctx, window=_window(reqs), max_batch=4,
                             chunk=8, page_size=16, paged=paged)
        outs[impl], counts, _ = serve_run(
            f"{label}_f32_{impl}", mods, engine, params,
            [_fresh(r) for r in reqs], cfg.vocab_size,
            need if impl == "cuda" else ())
        if impl == "ref" and any(counts.values()):
            raise AssertionError(f"{label}: the plain path launched {counts}")
        if trim and engine.counters["pages_trimmed"] == 0:
            raise AssertionError(f"{label} {impl}: the window trimmed no "
                                 f"page")
        if impl == "cuda" and not paged:
            if launches is None:
                dense_decode_launches(f"{label}_f32", engine, counts,
                                      cfg.n_layers)
            else:
                launches(f"{label}_f32", engine, counts)
        if pertoken is not None:
            reset_counts(mods)
            pert[impl] = engine.generate_pertoken(
                params, {"tokens": pertoken}, max_new=16).cpu()
            c = read_counts(mods)
            used = all(c[name] > 0 for name in pertoken_need)
            if used != (impl == "cuda") or (impl == "ref"
                                            and any(c.values())):
                raise AssertionError(f"{label} generate_pertoken {impl}: "
                                     f"launches {c}")
    for rid in outs["cuda"]:
        if not (outs["cuda"][rid] == outs["ref"][rid]).all():
            raise AssertionError(f"{label} f32 request {rid}: cuda tokens "
                                 f"{outs['cuda'][rid]} != ref "
                                 f"{outs['ref'][rid]}")
    if pertoken is not None and not torch.equal(pert["cuda"], pert["ref"]):
        raise AssertionError(f"{label} f32 generate_pertoken: cuda "
                             f"{pert['cuda']} != ref {pert['ref']}")
    log(f"serve[{label}_f32]: greedy tokens through the kernels equal the "
        f"plain path's" + ("" if paged else " on the dense backend")
        + (" (run and generate_pertoken)" if pertoken is not None else ""))


def serve_qwen(mods):
    """Slice 1's path: full-width qwen2-0.5B through the paged kernels.
    Returns the launch counts of its bf16 run."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import api
    from repro_torch.models.blocks import ModelContext
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import ServeEngine

    cfg = get_arch("qwen2_0_5b")
    params = init_params(api.model_specs(cfg), seed=0,
                         dtype=torch.bfloat16, device="cuda")
    paged = ("paged_decode_attention", "paged_decode_span_attention")
    counts, wall = None, None
    for label, cache, draft_k, need in (
            ("qwen_bf16", None, 0, paged),
            # greedy speculation verifies every step through the span
            # kernel; the one-token decode kernel is not on that path
            ("qwen_bf16_draft_k2", None, 2, paged[1:]),
            ("qwen_int8", torch.int8, 0, paged)):
        ctx = ModelContext(compute_dtype=torch.bfloat16,
                           decode_cache_dtype=cache, device="cuda")
        engine = ServeEngine(cfg, ctx, window=640, max_batch=4, chunk=8,
                             page_size=16, draft_k=draft_k)
        _, c, w = serve_run(label, mods, engine, params,
                            serve_requests(cfg.vocab_size, seed=0),
                            cfg.vocab_size, need)
        span_route_launches(label, engine, c, cfg.n_layers)
        if counts is None:
            counts, wall = c, w
    ctx = ModelContext(compute_dtype=torch.bfloat16, device="cuda")
    profiled_serve("qwen_bf16", ServeEngine(
        cfg, ctx, window=640, max_batch=4, chunk=8, page_size=16), params,
        serve_requests(cfg.vocab_size, seed=0), wall)
    del params
    torch.cuda.empty_cache()

    params = init_params(api.model_specs(cfg), seed=1, device="cuda")
    short = serve_requests(cfg.vocab_size, seed=1, n=4, max_new=16)
    for r in short:
        r.prompt = r.prompt[:160]
    f32_equality("qwen", mods, cfg, params, short, paged)
    del params
    torch.cuda.empty_cache()
    return counts


def serve_mixtral(mods):
    """Slice 2's path: Mixtral-8x22B at full width and cut depth through
    the paged and grouped-GEMM kernels, then its dense ring serve through
    the flash, grouped-GEMM and dense decode kernels. Returns the launch
    counts of the paged and the ring bf16 runs."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import api
    from repro_torch.models.blocks import ModelContext
    from repro_torch.models.moe import moe_ffn, quantize_moe_params
    from repro_torch.models.params import init_params, tree_index
    from repro_torch.serve.engine import ServeEngine

    device = "cuda"
    full = get_arch("mixtral_8x22b")
    cfg = dataclasses.replace(full, n_layers=MIXTRAL_LAYERS)
    log(f"mixtral: {cfg.n_layers} of {full.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads x "
        f"{cfg.resolved_head_dim}, {cfg.n_experts} experts top-"
        f"{cfg.experts_per_token} x d_ff {cfg.d_ff}, window "
        f"{cfg.sliding_window}")
    t0 = time.perf_counter()
    params = init_params(api.model_specs(cfg), seed=0, dtype=torch.bfloat16,
                         device=device)
    torch.cuda.synchronize()
    gb = sum(p.numel() * p.element_size() for p in _leaves(params)) / 1e9
    log(f"mixtral: {gb:.2f} GB of bf16 weights made in "
        f"{time.perf_counter() - t0:.1f}s")
    # one prompt past the 4096-token window, so decode trims its pages
    reqs = lambda: serve_requests(cfg.vocab_size, seed=0, long_prompt=4500)
    window = _window(reqs())
    every = ("paged_decode_attention", "paged_decode_span_attention",
             "grouped_matmul")
    counts, wall = None, None
    for label, cache, draft_k, need in (
            ("mixtral_bf16", None, 0, every),
            ("mixtral_bf16_draft_k2", None, 2,
             ("paged_decode_span_attention", "grouped_matmul")),
            ("mixtral_int8", torch.int8, 0, every)):
        ctx = ModelContext(compute_dtype=torch.bfloat16,
                           decode_cache_dtype=cache, device=device)
        engine = ServeEngine(cfg, ctx, window=window, max_batch=4, chunk=8,
                             page_size=16, draft_k=draft_k)
        _, c, w = serve_run(label, mods, engine, params, reqs(),
                            cfg.vocab_size, need)
        span_route_launches(label, engine, c, cfg.n_layers)
        if engine.counters["pages_trimmed"] == 0:
            raise AssertionError(f"{label}: the window trimmed no page")
        if counts is None:
            counts, wall = c, w
    ctx = ModelContext(compute_dtype=torch.bfloat16, device=device)
    profiled_serve("mixtral_bf16", ServeEngine(
        cfg, ctx, window=window, max_batch=4, chunk=8, page_size=16),
        params, reqs(), wall)

    # one layer's experts in int8 through moe_ffn: kernel against plain
    mlp = quantize_moe_params(tree_index(params["blocks"]["sl0"]["mlp"], 0))
    g = torch.Generator(device=device)
    g.manual_seed(2)
    x = torch.randn((1, 128, cfg.d_model), generator=g, device=device).to(
        torch.bfloat16)
    run = lambda impl: moe_ffn(mlp, x, cfg, torch.bfloat16,
                               dispatch="grouped", impl=impl,
                               with_aux=False)[0]
    outs = {"ref": run("ref")}
    torch.cuda.synchronize()
    # the serving MoE layer never waits for the device: the dispatch plan
    # is sized statically and computed on the card
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs["cuda"] = run("cuda")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    err = float((outs["cuda"].float() - outs["ref"].float()).abs().max())
    big = float(outs["ref"].float().abs().max())
    # bf16 rows round after up/gate and after down: two bf16 steps
    if not bool(torch.isfinite(outs["cuda"].float()).all()) \
            or err > 2 ** -6 * big:
        raise AssertionError(f"int8 experts: max_abs_err {err} > "
                             f"{2 ** -6 * big}")
    log(f"mixtral int8 experts (one layer, 128 tokens): moe_ffn cuda vs "
        f"ref max_abs_err={err:.3e} (max |out| {big:.3e}, limit 2^-6 of "
        f"it); no host sync in the cuda call")
    del mlp

    # the dense backend: the 4096-token window makes each layer's cache a
    # 4096-slot ring; prompts past it roll into the ring at prefill, and
    # the 4080- and 4095-token rows wrap during decode
    ring = dense_requests(cfg.vocab_size, 3,
                          (3000, 4080, 4200, 4500, 3500, 4095), 32)
    ctx = ModelContext(compute_dtype=torch.bfloat16, device=device)
    ring_engine = lambda: ServeEngine(cfg, ctx, window=_window(ring),
                                      max_batch=4, chunk=8, paged=False)
    engine = ring_engine()
    w = engine.kv.cache["blocks"]["sl0"]["k"].shape[2]
    if engine.chunk_prefill or w != cfg.sliding_window:
        raise AssertionError(f"mixtral ring: width {w}, chunk_prefill "
                             f"{engine.chunk_prefill}")
    _, ring_counts, wall = serve_run(
        "mixtral_ring_bf16", mods, engine, params, ring, cfg.vocab_size,
        ("flash_attention", "grouped_matmul", "decode_attention"))
    dense_decode_launches("mixtral_ring_bf16", engine, ring_counts,
                          cfg.n_layers)
    log(f"  ring of {w} slots in a window of {engine.window}")
    profiled_serve("mixtral_ring_bf16", ring_engine(), params,
                   dense_requests(cfg.vocab_size, 3,
                                  [len(r.prompt) for r in ring], 32), wall)
    del params, engine
    torch.cuda.empty_cache()

    # f32 (TF32 off) at fewer layers: kernels == plain path, token for
    # token, one prompt past the window so the trimmed table is compared
    cfg32 = dataclasses.replace(full, n_layers=2)  # ~21 GB of f32 weights
    params = init_params(api.model_specs(cfg32), seed=1, device=device)
    short = serve_requests(cfg32.vocab_size, seed=1, n=4, max_new=16,
                           long_prompt=4500)
    for r in short[:4]:
        r.prompt = r.prompt[:160]
    f32_equality("mixtral", mods, cfg32, params, short, every, trim=True)
    ring = dense_requests(cfg32.vocab_size, 4, (4090, 4200, 3000), 16)
    f32_equality("mixtral_ring", mods, cfg32, params, ring,
                 ("flash_attention", "grouped_matmul", "decode_attention"),
                 paged=False)
    del params
    torch.cuda.empty_cache()
    return counts, ring_counts


# ------------------------------------------------------------ dense serve


def serve_dense(mods):
    """This slice's path: full-width, full-depth phi4-mini-3.8B on the
    dense backend, its decode through the dense ring kernel. Returns the
    launch counts of its bf16 run."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import api
    from repro_torch.models.blocks import ModelContext
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import ServeEngine

    cfg = get_arch("phi4_mini_3_8b")
    t0 = time.perf_counter()
    params = init_params(api.model_specs(cfg), seed=0, dtype=torch.bfloat16,
                         device="cuda")
    torch.cuda.synchronize()
    gb = sum(p.numel() * p.element_size() for p in _leaves(params)) / 1e9
    log(f"phi4: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.resolved_head_dim}, "
        f"vocab {cfg.vocab_size}; {gb:.2f} GB of bf16 weights made in "
        f"{time.perf_counter() - t0:.1f}s")
    lens = (64, 1024, 300, 700, 128, 900, 512, 256)
    reqs = dense_requests(cfg.vocab_size, 0, lens, 32)
    ctx = ModelContext(compute_dtype=torch.bfloat16, device="cuda")
    make = lambda: ServeEngine(cfg, ctx, window=_window(reqs), max_batch=4,
                               chunk=8, paged=False)
    engine = make()
    if not engine.chunk_prefill:
        raise AssertionError("phi4 dense: expected the chunked span prefill")
    _, counts, _ = serve_run("phi4_dense_bf16", mods, engine, params, reqs,
                             cfg.vocab_size, ("decode_attention",))
    dense_decode_launches("phi4_dense_bf16", engine, counts, cfg.n_layers)
    log(f"  decode_attention launches {counts['decode_attention']} = "
        f"{cfg.n_layers} layers x {engine.counters['decode_steps']} decode "
        f"steps; span-prefill calls "
        f"{engine.counters['prefill_span_calls']}, span shapes "
        f"{engine.counters['span_prefill_dense_compiles']}")
    # two of the requests (64 and 128 prompt tokens) once more under the
    # profiler: a profile of all eight holds ~300K device events, whose
    # processing took minutes of the host
    profiled_serve("phi4_dense_bf16", make(), params,
                   dense_requests(cfg.vocab_size, 0, lens, 32)[::4])

    batch = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 256))
    reset_counts(mods)
    t0 = time.perf_counter()
    toks = engine.generate_pertoken(params, {"tokens": batch}, max_new=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = read_counts(mods)
    if (tuple(toks.shape) != (2, 16) or int(toks.min()) < 0
            or int(toks.max()) >= cfg.vocab_size
            or c["flash_attention"] != cfg.n_layers
            or c["decode_attention"] != cfg.n_layers * 16):
        raise AssertionError(f"phi4 generate_pertoken: {toks} launches {c}")
    log(f"phi4 generate_pertoken (2 x 256 prompt, 16 new): {wall:.3f}s "
        f"launches={c}")
    del params, engine
    torch.cuda.empty_cache()

    # f32 (TF32 off) at 4 layers: kernels == plain path, token for token
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    params = init_params(api.model_specs(cfg4), seed=1, device="cuda")
    short = dense_requests(cfg4.vocab_size, 1, (64, 200, 333, 150, 97), 16)
    f32_equality("phi4", mods, cfg4, params, short, ("decode_attention",),
                 paged=False, pertoken=batch[:, :100])
    del params
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------------------ state serve


def wkv_launches(label, engine, counts, n_layers=None) -> None:
    """Every prefill and every decode step runs the WKV kernel once per
    layer."""
    n_layers = n_layers or engine.cfg.n_layers
    calls = engine.counters["prefills"] + engine.counters["decode_steps"]
    if calls == 0 or counts["rwkv_wkv"] != n_layers * calls:
        raise AssertionError(f"{label}: rwkv_wkv launches "
                             f"{counts['rwkv_wkv']} != {n_layers} x ({calls} "
                             f"prefills + decode steps)")


def _gb(tree) -> float:
    return sum(p.numel() * p.element_size() for p in _leaves(tree)) / 1e9


def serve_state(mods):
    """This slice's path: the state families on the dense backend.
    Full-width, full-depth rwkv6-1.6B through the chunked WKV kernel
    (bucketed prefill, decode), then Jamba-v0.1-52B at full width cut to
    one 8-layer block through the dense decode and grouped-GEMM kernels
    (the chunked span prefill threads its Mamba state through the spans).
    Returns the launch counts of the two bf16 runs."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import api
    from repro_torch.models.blocks import ModelContext
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import ServeEngine

    # 1. rwkv6-1.6B, 24 layers, bf16
    cfg = get_arch("rwkv6_1_6b")
    t0 = time.perf_counter()
    params = init_params(api.model_specs(cfg), seed=0, dtype=torch.bfloat16,
                         device="cuda")
    torch.cuda.synchronize()
    log(f"rwkv6: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.rwkv_heads} WKV heads x {cfg.rwkv_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}; {_gb(params):.2f} GB of bf16 "
        f"weights made in {time.perf_counter() - t0:.1f}s")
    lens = (64, 1024, 300, 700, 128, 900, 512, 256)
    reqs = dense_requests(cfg.vocab_size, 0, lens, 32)
    ctx = ModelContext(compute_dtype=torch.bfloat16, device="cuda")
    make = lambda: ServeEngine(cfg, ctx, window=_window(reqs), max_batch=4,
                               chunk=8)
    engine = make()
    if engine.paged or not engine.bucket_prefill:
        raise AssertionError("rwkv6: expected the dense backend's bucketed "
                             "prefill")
    _, rwkv_counts, _ = serve_run("rwkv6_bf16", mods, engine, params, reqs,
                                  cfg.vocab_size, ("rwkv_wkv",))
    wkv_launches("rwkv6_bf16", engine, rwkv_counts)
    log(f"  rwkv_wkv launches {rwkv_counts['rwkv_wkv']} = {cfg.n_layers} "
        f"layers x ({engine.counters['prefills']} prefills + "
        f"{engine.counters['decode_steps']} decode steps); "
        f"prefill_bucket_sizes {sorted(engine.prefill_bucket_sizes)}")
    profiled_serve("rwkv6_bf16", make(), params,
                   dense_requests(cfg.vocab_size, 0, lens, 32)[::4])
    batch = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 256))
    reset_counts(mods)
    t0 = time.perf_counter()
    toks = engine.generate_pertoken(params, {"tokens": batch}, max_new=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = read_counts(mods)
    if (tuple(toks.shape) != (2, 16) or int(toks.min()) < 0
            or int(toks.max()) >= cfg.vocab_size
            or c["rwkv_wkv"] != cfg.n_layers * 17):
        raise AssertionError(f"rwkv6 generate_pertoken: {toks} launches {c}")
    log(f"rwkv6 generate_pertoken (2 x 256 prompt, 16 new): {wall:.3f}s "
        f"launches={c}")
    del params, engine
    torch.cuda.empty_cache()

    # f32 (TF32 off) at full depth: the kernel == the plain path, token for
    # token; generate_pertoken's 97-token prompts prefill at a WKV chunk
    # of 1 (97 is prime)
    params = init_params(api.model_specs(cfg), seed=1, device="cuda")
    short = dense_requests(cfg.vocab_size, 1, (64, 200, 333, 150, 97), 16)
    f32_equality("rwkv6", mods, cfg, params, short, ("rwkv_wkv",),
                 paged=False, pertoken=batch[:, :97], launches=wkv_launches,
                 pertoken_need=("rwkv_wkv",))
    del params
    torch.cuda.empty_cache()

    # 2. Jamba-v0.1-52B at full width, one block of 8 of its 32 layers
    full = get_arch("jamba_v01_52b")
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS)
    kinds = cfg.sublayer_kinds()
    log(f"jamba: {cfg.n_layers} of {full.n_layers} layers "
        f"({kinds.count('mamba')} Mamba + {kinds.count('attn')} attention, "
        f"{sum(cfg.moe_mask())} MoE), d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.resolved_head_dim}, "
        f"{cfg.n_experts} experts top-{cfg.experts_per_token} x d_ff "
        f"{cfg.d_ff}, Mamba d_inner {cfg.d_inner} N {cfg.ssm_state_dim}; "
        f"bf16 weights of all {full.n_layers} layers "
        f"{2 * full.total_params() / 1e9:.1f} GB, of {cfg.n_layers} "
        f"{2 * cfg.total_params() / 1e9:.1f} GB (the card holds 80)")
    t0 = time.perf_counter()
    params = init_params(api.model_specs(cfg), seed=0, dtype=torch.bfloat16,
                         device="cuda")
    torch.cuda.synchronize()
    log(f"jamba: {_gb(params):.2f} GB of bf16 weights made in "
        f"{time.perf_counter() - t0:.1f}s")
    reqs = dense_requests(cfg.vocab_size, 2, (64, 1024, 300, 700, 128, 900),
                          32)
    engine = ServeEngine(cfg, ctx, window=_window(reqs), max_batch=4,
                         chunk=8, paged=False)
    if not engine.chunk_prefill:
        raise AssertionError("jamba: expected the chunked span prefill")
    n_attn = kinds.count("attn")
    _, jamba_counts, _ = serve_run("jamba_bf16", mods, engine, params, reqs,
                                   cfg.vocab_size,
                                   ("decode_attention", "grouped_matmul"))
    dense_decode_launches("jamba_bf16", engine, jamba_counts, n_attn)
    log(f"  decode_attention launches {jamba_counts['decode_attention']} = "
        f"{n_attn} attention layer x {engine.counters['decode_steps']} "
        f"decode steps; grouped_matmul {jamba_counts['grouped_matmul']}; "
        f"span-prefill calls {engine.counters['prefill_span_calls']}")
    del params, engine
    torch.cuda.empty_cache()

    # f32 (TF32 off) at the same 8 layers (~53 GB): kernels == plain path
    params = init_params(api.model_specs(cfg), seed=1, device="cuda")
    log(f"jamba f32: {_gb(params):.2f} GB of weights")
    short = dense_requests(cfg.vocab_size, 3, (64, 200, 150, 97), 16)
    f32_equality("jamba", mods, cfg, params, short,
                 ("decode_attention", "grouped_matmul"), paged=False,
                 pertoken=batch[:, :97],
                 launches=lambda lb, e, c: dense_decode_launches(
                     lb, e, c, n_attn))
    del params
    torch.cuda.empty_cache()
    return rwkv_counts, jamba_counts


# ----------------------------------------------------------- dlrm train


def dlrm_gradient() -> None:
    """One backward of the kernel route's ``_EmbeddingBag`` on the card at
    the user table's shape, against gradients built independently from
    one-hot matrices in f64: the table gradient adds ``w[i,j] * g[i]`` to
    each index's row after a negative one wraps once and drops what is
    still outside [0, V); the weight gradient dots the clamped row the
    forward read with ``g[i]``. A gradient that clamped instead of
    dropping must fail the limit."""
    import torch
    from repro_torch.examples import dlrm_sparsecore as dlrm

    (v, d), n, bag = dlrm.TABLES["user"], dlrm.BATCH, dlrm.BAG
    g = torch.Generator().manual_seed(5)
    table = torch.randn((v, d), generator=g) * 0.05
    idx = torch.randint(0, v, (n, bag), generator=g, dtype=torch.int32)
    idx[:, -1] = idx[:, 0]  # a repeated row in every bag
    idx[0, 1], idx[1, 1], idx[2, 1] = -1, v + 2, -v - 4
    w, up = torch.randn((n, bag), generator=g), torch.randn((n, d),
                                                           generator=g)
    leaves = [t.cuda().requires_grad_() for t in (table, w)]
    out = dlrm._EmbeddingBag.apply(leaves[0], idx.cuda(), leaves[1], "cuda")
    got_t, got_w = (x.cpu() for x in torch.autograd.grad(out, leaves,
                                                         up.cuda()))
    flat = idx.long().flatten()
    wrapped = torch.where(flat < 0, flat + v, flat)
    keep = (wrapped >= 0) & (wrapped < v)
    rows = torch.arange(n * bag)
    contrib = (w.double().flatten()[:, None]
               * up.double().repeat_interleave(bag, 0))
    drop = torch.zeros((n * bag, v), dtype=torch.float64)
    drop[rows[keep], wrapped[keep]] = 1
    clamp = torch.zeros((n * bag, v), dtype=torch.float64)
    clamp[rows, wrapped.clamp(0, v - 1)] = 1
    want_t = drop.T @ contrib
    want_w = ((clamp @ table.double())
              * up.double().repeat_interleave(bag, 0)).sum(-1).view(n, bag)
    reading = lambda got, want: float((got.double() - want).abs().max()
                                      / want.abs().max())
    r_t, r_w = reading(got_t, want_t), reading(got_w, want_w)
    fault = reading(got_t, clamp.T @ contrib)
    if r_t > 1e-5 or r_w > 1e-5 or fault <= 1e-5:
        raise AssertionError(f"dlrm gradient: table {r_t}, weights {r_w} "
                             f"(limit 1e-5 of the largest |value|); a "
                             f"clamping gradient read {fault}")
    log(f"dlrm gradient on the card (user table {v} x {d}, N {n}, bag "
        f"{bag}, indices -1, V+2, -V-4 planted): table {r_t:.3e}, weights "
        f"{r_w:.3e} of the largest |value| against f64 one-hot products "
        f"(limit 1e-5); a gradient that clamps reads {fault:.3e}")


def train_dlrm(mods):
    """This slice's path, part A: the port's DLRM example on the card
    through its entry point (120 SGD steps, every embedding bag through
    the kernel: launches = 3 x steps), then both routes from the same
    params and batches: the kernel route's losses and final params must
    match the plain route's within rel 1e-5 at f32 (the backward's
    scatter-add uses atomics), and one backward must match gradients
    built independently (``dlrm_gradient``). Runs before the train phase
    turns on deterministic mode. Returns the launch counts of the entry
    point's run."""
    import torch
    from repro_torch.examples import dlrm_sparsecore as dlrm

    reset_counts(mods)
    t0 = time.perf_counter()
    losses = dlrm.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(mods)
    want = {name: 0 for name in counts}
    want["sparse_gather_sum"] = 3 * dlrm.STEPS
    if counts != want:
        raise AssertionError(f"dlrm: launches {counts}, want {want}")
    if not losses[-1] < losses[0] or len(losses) != dlrm.STEPS:
        raise AssertionError(f"dlrm: losses {losses}")
    init = lambda: dlrm.init(torch.Generator().manual_seed(0), "cuda")
    final = {}
    reset_counts(mods)
    t0 = time.perf_counter()
    final["ref"], plain = dlrm.train(init(), dlrm.STEPS, impl="ref",
                                     device="cuda")
    plain_wall = time.perf_counter() - t0
    if any(read_counts(mods).values()):
        raise AssertionError(f"dlrm: the plain route launched "
                             f"{read_counts(mods)}")
    final["cuda"], _ = dlrm.train(init(), dlrm.STEPS, impl="cuda",
                                  device="cuda")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
    leaf = max(float((final["cuda"][k] - p).abs().max() / p.abs().max())
               for k, p in final["ref"].items())
    if rel > 1e-5 or leaf > 1e-5:
        raise AssertionError(f"dlrm: the kernel route differs from the "
                             f"plain route's by rel {rel} in the losses, "
                             f"{leaf} of a final leaf's largest |value|")
    log(f"dlrm: {dlrm.STEPS} steps of batch {dlrm.BATCH} in {wall:.3f}s "
        f"({1e3 * wall / dlrm.STEPS:.2f} ms/step; plain route "
        f"{1e3 * plain_wall / dlrm.STEPS:.2f} ms/step), loss "
        f"{losses[0]:.6f} -> {losses[-1]:.6f}, max rel loss difference "
        f"to the plain route {rel:.3e}, final leaves within {leaf:.3e} of "
        f"their largest |value|, launches={counts}")
    dlrm_gradient()
    return counts


# ----------------------------------------------------- enc-dec and M-RoPE


WHISPER_LENS = (4, 64, 17, 40, 9, 33, 52, 25)


def whisper_requests(cfg, seed: int, lens, max_new: int):
    """Decoder prompts of ``lens`` tokens, each with (1, 1500, d_model)
    frames from the seed (x 0.1, as the serve launcher makes them)."""
    import numpy as np
    reqs = dense_requests(cfg.vocab_size, seed, lens, max_new)
    rng = np.random.default_rng(seed + 1)
    for r in reqs:
        r.extras["enc_feats"] = rng.standard_normal(
            (1, cfg.encoder_seq, cfg.d_model), dtype=np.float32) * 0.1
    return reqs


def whisper_launches(label, engine, counts) -> None:
    """Each decode step runs the dense kernel twice per decoder layer (the
    ring, then the cross k/v); each prefill runs the flash kernel once per
    encoder layer and twice per decoder layer (causal, then cross)."""
    cfg = engine.cfg
    steps, prefills = (engine.counters["decode_steps"],
                       engine.counters["prefills"])
    flash = (cfg.encoder_layers + 2 * cfg.n_layers) * prefills
    if (steps == 0 or counts["decode_attention"] != 2 * cfg.n_layers * steps
            or counts["flash_attention"] != flash):
        raise AssertionError(
            f"{label}: decode_attention {counts['decode_attention']} != 2 x "
            f"{cfg.n_layers} x {steps} steps or flash_attention "
            f"{counts['flash_attention']} != {flash}")


def vl_rows(s: int, start: int, grid: int):
    """(3, S) int32 M-RoPE rows shaped like Qwen2-VL's: text up to
    ``start``, a grid x grid merged image (t fixed, h and w in raster
    order), then text from the image's largest row + 1."""
    import numpy as np
    t = np.arange(s, dtype=np.int32)
    rows = np.stack([t, t, t])
    img = np.arange(grid * grid)
    rows[0, start:start + grid * grid] = start
    rows[1, start:start + grid * grid] = start + img // grid
    rows[2, start:start + grid * grid] = start + img % grid
    rows[:, start + grid * grid:] = start + grid + np.arange(
        s - start - grid * grid)
    return rows


def vl_requests(cfg, seed: int, n: int = 8, max_new: int = 32,
                grid: int = 16, shared: int = 64):
    """n prompts of 100-600 tokens sharing a ``shared``-token system
    prompt. The odd half carry explicit (3, S) rows shaped like
    Qwen2-VL's: the text prefix, a grid x grid merged image (t fixed, h
    and w in raster order), then text from max + 1."""
    import numpy as np
    from repro_torch.serve.scheduler import Request
    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab_size, shared)
    reqs = []
    for rid in range(n):
        s = int(rng.integers(100, 601))
        if rid % 2:
            s = max(s, shared + grid * grid + 16)
        prompt = np.concatenate([system,
                                 rng.integers(0, cfg.vocab_size, s - shared)])
        r = Request(rid=rid, prompt=prompt, max_new=max_new)
        if rid % 2:
            r.extras["positions"] = vl_rows(s, shared, grid)[:, None, :]
        reqs.append(r)
    return reqs


def serve_encdec(mods):
    """This slice's path, part B: full-width, full-depth Whisper-small
    (12 + 12 layers) on the dense backend, its prefill through the flash
    kernel (the encoder over 1500 frames, causal decoder, cross-attention
    with S_k = 1500), its decode through the dense decode kernel twice per
    layer; then f32 token equality at full depth. Then full-width,
    full-depth Qwen2-VL-7B, paged, half its requests with explicit M-RoPE
    rows, through the paged kernels; then f32 token equality at 4 layers.
    Returns the launch counts of the two bf16 runs."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import api
    from repro_torch.models.blocks import ModelContext
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import ServeEngine

    # 1. Whisper-small, bf16, window 448 (its text context)
    cfg = get_arch("whisper_small")
    t0 = time.perf_counter()
    params = init_params(api.model_specs(cfg), seed=0, dtype=torch.bfloat16,
                         device="cuda")
    torch.cuda.synchronize()
    log(f"whisper: {cfg.encoder_layers} + {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads x {cfg.resolved_head_dim}, "
        f"vocab {cfg.vocab_size}, {cfg.encoder_seq} frames; "
        f"{_gb(params):.2f} GB of bf16 weights made in "
        f"{time.perf_counter() - t0:.1f}s")
    ctx = ModelContext(compute_dtype=torch.bfloat16, device="cuda")
    reqs = whisper_requests(cfg, 0, WHISPER_LENS, 64)
    make = lambda: ServeEngine(cfg, ctx, window=448, max_batch=4, chunk=8)
    engine = make()
    if engine.paged or engine.chunk_prefill or engine.bucket_prefill:
        raise AssertionError("whisper: expected the dense full-prompt "
                             "prefill")
    need = ("flash_attention", "decode_attention")
    _, whisper_counts, wall = serve_run("whisper_bf16", mods, engine,
                                        params, reqs, cfg.vocab_size, need)
    whisper_launches("whisper_bf16", engine, whisper_counts)
    log(f"  decode_attention launches {whisper_counts['decode_attention']}"
        f" = 2 x {cfg.n_layers} layers x {engine.counters['decode_steps']} "
        f"decode steps; flash_attention {whisper_counts['flash_attention']}"
        f" = ({cfg.encoder_layers} + 2 x {cfg.n_layers}) x "
        f"{engine.counters['prefills']} prefills")
    # one request under the profiler: processing the device events of
    # two took most of a minute of the host
    profiled_serve("whisper_bf16", make(), params,
                   whisper_requests(cfg, 0, WHISPER_LENS, 64)[:1])
    del params, engine
    torch.cuda.empty_cache()
    params = init_params(api.model_specs(cfg), seed=1, device="cuda")
    f32_equality("whisper", mods, cfg, params,
                 whisper_requests(cfg, 1, (4, 30, 61, 12, 45), 24), need,
                 paged=False, launches=whisper_launches)
    del params
    torch.cuda.empty_cache()

    # 2. Qwen2-VL-7B, bf16, paged
    cfg = get_arch("qwen2_vl_7b")
    t0 = time.perf_counter()
    params = init_params(api.model_specs(cfg), seed=0, dtype=torch.bfloat16,
                         device="cuda")
    torch.cuda.synchronize()
    log(f"qwen2-vl: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.resolved_head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, mrope sections "
        f"{cfg.mrope_sections}; {_gb(params):.2f} GB of bf16 weights made "
        f"in {time.perf_counter() - t0:.1f}s")
    reqs = vl_requests(cfg, 0)
    make = lambda: ServeEngine(cfg, ctx, window=_window(reqs), max_batch=4,
                               chunk=8, page_size=16)
    engine = make()
    paged = ("paged_decode_attention", "paged_decode_span_attention")
    _, vl_counts, _ = serve_run("qwen2_vl_bf16", mods, engine, params, reqs,
                                cfg.vocab_size, paged)
    steps = engine.counters["decode_steps"]
    spans = engine.counters["prefill_span_calls"]
    if (vl_counts["paged_decode_attention"] != cfg.n_layers * steps
            or vl_counts["paged_decode_span_attention"]
            != cfg.n_layers * spans):
        raise AssertionError(f"qwen2-vl: launches {vl_counts} != "
                             f"{cfg.n_layers} x ({steps} steps, {spans} "
                             f"spans)")
    span_route_launches("qwen2_vl_bf16", engine, vl_counts, cfg.n_layers)
    hits = {r.rid: r.cached_prefix_len for r in reqs}
    text_hits = sum(v for rid, v in hits.items() if rid % 2 == 0)
    if (any(hits[rid] for rid in hits if rid % 2) or text_hits == 0
            or engine.kv.counters["prefix_hit_tokens"] != text_hits):
        raise AssertionError(f"qwen2-vl: prefix hits {hits}, kv "
                             f"{engine.kv.counters}: only the text half may "
                             f"hit")
    log(f"  paged decode launches {vl_counts['paged_decode_attention']} = "
        f"{cfg.n_layers} x {steps} decode steps; span launches "
        f"{vl_counts['paged_decode_span_attention']} = {cfg.n_layers} x "
        f"{spans} span calls; prefix hits by request {hits} (the "
        f"explicit-rows half bypasses the cache)")
    profiled_serve("qwen2_vl_bf16", make(), params,
                   vl_requests(cfg, 0)[1:2])  # one with explicit rows
    del params, engine
    torch.cuda.empty_cache()
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    params = init_params(api.model_specs(cfg4), seed=1, device="cuda")
    log(f"qwen2-vl f32: 4 layers, {_gb(params):.2f} GB of weights")
    short = vl_requests(cfg4, 1, n=4, max_new=16)
    for r in short:
        r.prompt = r.prompt[:400]
        if "positions" in r.extras:
            r.extras["positions"] = r.extras["positions"][:, :, :400]
    f32_equality("qwen2_vl", mods, cfg4, params, short, paged)
    del params
    torch.cuda.empty_cache()
    return whisper_counts, vl_counts


# ------------------------------------------------------- resilient serve

# the chaos plan of the JAX package's fault tests (tests/test_serve_faults.py)
CHAOS = dict(seed=7, worker_fail_rate=0.25, page_flip_rate=0.25,
             transfer_drop_rate=0.2, straggler_rate=0.2)


def resilient_requests(vocab: int, *, late: bool = False):
    """6 requests of 60-200 prompt tokens, the first three sharing a
    64-token prefix, 16 new tokens each. Arrivals every 8 steps (one
    chunk), so the run spans the plan's page flips; with ``late``, four
    at step 0 and two at step 1, behind a full batch."""
    import numpy as np
    from repro_torch.serve.scheduler import Request
    rng = np.random.default_rng(1)
    shared = rng.integers(0, vocab, 64)
    reqs = []
    for rid in range(6):
        if rid < 3:
            prompt = np.concatenate(
                [shared, rng.integers(0, vocab, int(rng.integers(1, 137)))])
        else:
            prompt = rng.integers(0, vocab, int(rng.integers(60, 201)))
        arrival = (0 if rid < 4 else 1) if late else 8 * rid
        reqs.append(Request(rid=rid, prompt=prompt, max_new=16,
                            arrival=arrival))
    return reqs


def _same_tokens(label, got, want) -> None:
    for rid, toks in got.items():
        if not (toks == want[rid]).all():
            raise AssertionError(f"{label} request {rid}: {toks} != "
                                 f"fault-free {want[rid]}")


def serve_resilient(mods):
    """This slice's path: the startup self-test through the matmul and
    paged-decode kernels, then full-width qwen2-0.5B served under the
    fault schedule and admission. Returns the launch counts of the BIST
    and of the f32 chaos run."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.sdc import FaultModel, faulty_wrap
    from repro_torch.kernels import matmul as mm
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import api
    from repro_torch.models.blocks import ModelContext
    from repro_torch.models.params import init_params, tree_items
    from repro_torch.serve.admission import (AdmissionController,
                                             AdmissionPolicy)
    from repro_torch.serve.engine import ServeEngine, quantize_weights
    from repro_torch.serve.faults import (FaultInjector, FaultPlan,
                                          startup_bist)

    # 1. BIST on the card, then the two planted faults
    walls = []
    for _ in range(2):  # the second run is warm
        reset_counts(mods)
        t0 = time.perf_counter()
        res = startup_bist()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        bist_counts = read_counts(mods)
        if not res.passed or bist_counts["matmul"] != 8 \
                or bist_counts["paged_decode_attention"] != 1:
            raise AssertionError(f"bist: {res} launches {bist_counts}")
    bad_mm = startup_bist(matmul_fn=faulty_wrap(
        lambda a, b: mm.matmul(a, b),
        FaultModel(rate=1.0, magnitude=0.5, seed=1)))
    bad_pd = startup_bist(decode_fn=lambda q, *a: torch.zeros_like(q))
    if bad_mm.passed or bad_mm.matmul_report.passed \
            or bad_pd.passed or bad_pd.paged_decode_ok:
        raise AssertionError(f"bist missed a planted fault: {bad_mm} "
                             f"{bad_pd}")
    log(f"bist: PASS matmul max_err={res.matmul_report.max_abs_err:.3e} "
        f"paged_decode max_err={res.paged_decode_max_err:.3e} launches="
        f"{bist_counts}; wall {walls[0] * 1e3:.2f} ms (first) "
        f"{walls[1] * 1e3:.2f} ms (warm); corrupted matmul -> FAIL "
        f"(pattern {bad_mm.matmul_report.first_failing_pattern}, err "
        f"{bad_mm.matmul_report.max_abs_err:.3e}); zero decode -> FAIL "
        f"(err {bad_pd.paged_decode_max_err:.3e})")

    cfg = get_arch("qwen2_0_5b")
    reqs = lambda **kw: resilient_requests(cfg.vocab_size, **kw)
    window = _window(reqs())
    paged = ("paged_decode_attention", "paged_decode_span_attention")

    def engine(dtype, draft_k, faults=None, admission=None):
        ctx = ModelContext(compute_dtype=dtype, device="cuda")
        return ServeEngine(cfg, ctx, window=window, max_batch=4, chunk=8,
                           page_size=16, draft_k=draft_k, prefix_cache=True,
                           faults=faults, admission=admission)

    # 2. chaos at f32 (TF32 off): survivors keep the fault-free tokens
    params = init_params(api.model_specs(cfg), seed=0, device="cuda")
    chaos_counts = None
    for draft_k in (0, 2):
        need = paged if draft_k == 0 else paged[1:]
        base, _, _ = serve_run(f"f32_fault_free_k{draft_k}", mods,
                                   engine(torch.float32, draft_k), params,
                                   reqs(), cfg.vocab_size, need)
        eng = engine(torch.float32, draft_k,
                     faults=FaultInjector(FaultPlan(**CHAOS)))
        out, c, _ = serve_run(f"f32_chaos_k{draft_k}", mods, eng,
                                  params, reqs(), cfg.vocab_size, need)
        chaos_counts = chaos_counts or c
        fs = eng.fault_stats
        if fs["fault_page_corruptions"] == 0 or fs["fault_detections"] == 0:
            raise AssertionError(f"f32_chaos_k{draft_k}: no fault landed "
                                 f"{dict(fs.items())}")
        if not eng.kv._quarantined \
                or eng.kv._quarantined & set(eng.kv._index):
            raise AssertionError(f"f32_chaos_k{draft_k}: quarantine "
                                 f"{eng.kv._quarantined}")
        _same_tokens(f"f32_chaos_k{draft_k}", out, base)
        log(f"serve[f32_chaos_k{draft_k}]: {len(out)} survivors' tokens "
            f"equal the fault-free run's; quarantined hashes "
            f"{len(eng.kv._quarantined)}, none in the prefix index")

    # 3. admission: TTFT shedding of two late arrivals behind a full
    # batch, speculation dropped while anything waits
    base, _, _ = serve_run("f32_no_admission", mods,
                               engine(torch.float32, 2), params,
                               reqs(late=True), cfg.vocab_size, paged[1:])
    eng = engine(torch.float32, 2, admission=AdmissionController(
        AdmissionPolicy(ttft_deadline_steps=16, spec_off_queue_depth=0)))
    out, _, _ = serve_run("f32_admission", mods, eng, params,
                              reqs(late=True), cfg.vocab_size, paged[1:])
    fs = eng.fault_stats
    if fs["shed_requests"] == 0 or fs["shed_spec_chunks"] == 0:
        raise AssertionError(f"admission: {dict(fs.items())}")
    _same_tokens("f32_admission", out, base)
    log(f"serve[f32_admission]: shed {[r.rid for r in eng.scheduler.shed]}"
        f", served tokens equal the run without admission")
    del params
    torch.cuda.empty_cache()

    # 4. the chaos run at bf16, for time: CRC hashing's share of the wall
    params = init_params(api.model_specs(cfg), seed=0, dtype=torch.bfloat16,
                         device="cuda")
    serve_run("bf16_warmup", mods, engine(torch.bfloat16, 0), params,
                  reqs(), cfg.vocab_size, paged)
    _, _, free_wall = serve_run("bf16_fault_free", mods,
                                    engine(torch.bfloat16, 0), params,
                                    reqs(), cfg.vocab_size, paged)
    eng = engine(torch.bfloat16, 0, faults=FaultInjector(FaultPlan(**CHAOS)))
    spent = {"verify_s": 0.0, "boundaries": 0, "stamped": 0}
    verify, apply = eng.kv.verify_integrity, eng._apply_faults

    def timed_verify():
        t0 = time.perf_counter()
        spent["stamped"] += len(eng.kv._page_crc)
        try:
            return verify()
        finally:
            spent["verify_s"] += time.perf_counter() - t0

    def counted_apply(*args):
        spent["boundaries"] += 1
        return apply(*args)

    eng.kv.verify_integrity, eng._apply_faults = timed_verify, counted_apply
    _, _, wall = serve_run("bf16_chaos", mods, eng, params, reqs(),
                               cfg.vocab_size, paged)
    leaves = sum(1 for _ in tree_items(eng.kv.pages))
    log(f"serve[bf16_chaos]: {spent['boundaries']} boundaries, "
        f"{eng.fault_stats['fault_detections']} detections, wall "
        f"{wall:.3f}s against {free_wall:.3f}s fault-free; "
        f"verify_integrity {spent['verify_s']:.4f}s on the host "
        f"({100 * spent['verify_s'] / wall:.1f}% of the wall) for "
        f"{spent['stamped']} page checks of {leaves} pool leaves each "
        f"({spent['stamped'] * leaves} device-to-host copies)")

    # 5. fp8 weights (the tied embedding too): the gather on a float8
    # table and every cast, at bf16 compute
    q8 = quantize_weights(params)
    if q8["embed"].dtype != torch.float8_e4m3fn:
        raise AssertionError(f"fp8: embed {q8['embed'].dtype}")
    del params
    serve_run("fp8_weights", mods, engine(torch.bfloat16, 0), q8,
                  reqs(), cfg.vocab_size, paged)
    del q8
    torch.cuda.empty_cache()

    # 6. the launcher, as a user runs it on the card
    launch_serve.main(["--arch", "qwen2_0_5b", "--trace", "8", "--bist",
                       "--chaos", "7", "--ttft-deadline", "64",
                       "--spec-off-depth", "2", "--draft-k", "2",
                       "--quantize", "fp8", "--dtype", "bfloat16"])
    torch.cuda.empty_cache()
    return bist_counts, chaos_counts


# ------------------------------------------------------------ multi-device


MESH_TIMEOUT_S = 900.0  # a set of ranks on the card, start-up included
MESH_MIXTRAL_LAYERS = 2  # of 56: ~21 GB of f32 weights in the solo run


def serve_disagg(mods):
    """(a) Prefill/decode disaggregation of full-width qwen2-0.5B (bf16,
    the qwen serve's 8 requests, 2 prefill workers) on the modeled "ici"
    and "dcn" links: tokens equal to the co-located serve's, 8 transfers,
    stalls, one host drain a chunk; then the chaos plan (prefill-worker
    kills, transfer drops, page flips, stragglers) at bf16 (a reading)
    and at f32 on the resilient phase's requests, whose survivors' tokens
    equal the fault-free run's. Returns the "ici" run's launch counts."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import api
    from repro_torch.models.blocks import ModelContext
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.faults import FaultInjector, FaultPlan

    cfg = get_arch("qwen2_0_5b")
    params = init_params(api.model_specs(cfg), seed=0,
                         dtype=torch.bfloat16, device="cuda")
    paged = ("paged_decode_attention", "paged_decode_span_attention")
    reqs = lambda: serve_requests(cfg.vocab_size, seed=0)
    ctx = ModelContext(compute_dtype=torch.bfloat16, device="cuda")

    def engine(**kw):
        return ServeEngine(cfg, ctx, window=640, max_batch=4, chunk=8,
                           page_size=16, **kw)

    co, _, _ = serve_run("disagg_colocated_bf16", mods, engine(), params,
                         reqs(), cfg.vocab_size, paged)
    counts, base = None, None
    for link in ("ici", "dcn"):
        label = f"disagg_{link}_bf16"
        eng = engine(disaggregate=True, prefill_workers=2,
                     transfer_link=link)
        out, c, _ = serve_run(label, mods, eng, params, reqs(),
                              cfg.vocab_size, paged)
        _same_tokens(label, out, co)
        ts = eng.transfer_stats()
        if ts["transfers"] != 8 or ts["transfer_stall_boundaries"] < 1 \
                or eng.counters["host_syncs"] != eng.counters["chunks"]:
            raise AssertionError(f"{label}: {ts} host_syncs "
                                 f"{eng.counters['host_syncs']} chunks "
                                 f"{eng.counters['chunks']}")
        log(f"serve[{label}]: tokens equal the co-located serve's; "
            f"transfer {ts}; pool {eng.prefill_pool.stats}")
        if counts is None:
            counts, base = c, out
    # the chaos plan at bf16: a reading. A replayed request re-prefills
    # its generated tokens as a span, which rounds otherwise than the
    # decode steps that made them, so its bf16 tokens may part from the
    # fault-free run's; the f32 run below is the check
    eng = engine(disaggregate=True, prefill_workers=2, transfer_link="dcn",
                 faults=FaultInjector(FaultPlan(**CHAOS)))
    out, _, _ = serve_run("disagg_chaos_bf16", mods, eng, params, reqs(),
                          cfg.vocab_size, paged)
    same = {rid: int((toks == base[rid]).sum()) for rid, toks in out.items()}
    log(f"serve[disagg_chaos_bf16]: a reading: tokens equal to the "
        f"fault-free run's by request {same} of {len(base[0])}; faults "
        f"{dict(eng.fault_stats.items())}")
    del params
    torch.cuda.empty_cache()

    # the chaos plan at f32 (TF32 off), on the resilient phase's requests
    # over "dcn" (arrivals every chunk, and transfers that span several
    # boundaries, so a transfer is in flight when a drop is drawn):
    # survivors keep the fault-free tokens
    params = init_params(api.model_specs(cfg), seed=0, device="cuda")
    rreqs = lambda: resilient_requests(cfg.vocab_size)
    ctx = ModelContext(compute_dtype=torch.float32, device="cuda")

    def engine32(**kw):
        return ServeEngine(cfg, ctx, window=_window(rreqs()), max_batch=4,
                           chunk=8, page_size=16, disaggregate=True,
                           prefill_workers=2, transfer_link="dcn", **kw)

    base, _, _ = serve_run("disagg_fault_free_f32", mods, engine32(),
                           params, rreqs(), cfg.vocab_size, paged)
    eng = engine32(faults=FaultInjector(FaultPlan(**CHAOS)))
    out, _, _ = serve_run("disagg_chaos_f32", mods, eng, params, rreqs(),
                          cfg.vocab_size, paged)
    fs = dict(eng.fault_stats.items())
    if fs["fault_detections"] == 0 or fs["fault_worker_failures"] \
            + fs["fault_transfer_drops"] == 0:
        raise AssertionError(f"disagg_chaos_f32: no disaggregation fault "
                             f"landed {fs}")
    _same_tokens("disagg_chaos_f32", out, base)
    log(f"serve[disagg_chaos_f32]: {len(out)} survivors' tokens equal the "
        f"fault-free run's; faults {fs}; pool {eng.prefill_pool.stats}")
    del params
    torch.cuda.empty_cache()
    return counts


def compress_rank(rank, world, device, grads, steps):
    """(f), one rank: make_compressed_grad_fn of a linear least-squares
    loss on this rank's batch, on the card, ``steps`` times with the
    error state carried. Returns each step's mean gradient and error."""
    import torch
    from repro_torch.train import compress
    tp = {k: torch.from_numpy(v).to(device) for k, v in grads["params"]
          .items()}
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in grads["batches"][rank].items()}

    def loss_fn(p, b):
        loss = ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).mean()
        return loss, {"mse": loss.detach()}

    fn = compress.make_compressed_grad_fn(loss_fn)
    err = compress.init_error_state(tp)
    out = []
    for _ in range(steps):
        (loss, _), g, err = fn(tp, batch, err)
        out.append((float(loss), {k: v.cpu().numpy() for k, v in g.items()},
                    {k: v.cpu().numpy() for k, v in err.items()}))
    return out


def compress_on_one_rank(data, world, steps, device="cuda"):
    """(f)'s arithmetic on one rank of the card: every rank's gradient by
    autograd, then quantize, dequantize and average, the error carried."""
    import torch
    from repro_torch.train import compress
    tp = {k: torch.from_numpy(v).to(device).requires_grad_()
          for k, v in data["params"].items()}
    grads, losses = [], []
    for b in data["batches"]:
        b = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        loss = ((b["x"] @ tp["w"] + tp["b"] - b["y"]) ** 2).mean()
        grads.append(dict(zip(tp, torch.autograd.grad(loss, list(
            tp.values())))))
        losses.append(float(loss.detach()))
    err = [{k: torch.zeros_like(v) for k, v in g.items()} for g in grads]
    out = []
    for _ in range(steps):
        means = {}
        for name in tp:
            parts = []
            for r in range(world):
                comp = grads[r][name] + err[r][name]
                q, sc = compress.quantize_int8(comp)
                err[r][name] = comp - compress.dequantize_int8(q, sc)
                parts.append(compress.dequantize_int8(q, sc))
            means[name] = torch.stack(parts).mean(0)
        out.append((sum(losses) / world, means,
                    [{k: v.clone() for k, v in e.items()} for e in err]))
    return out


def _mesh_tokens(label, res, job, want) -> None:
    """Every rank's tokens of job ``job`` equal ``want`` (a list, one
    dict a run)."""
    for rank in res:
        for i, w in enumerate(want):
            got = rank[job]["runs"][i]["tokens"]
            for rid, toks in w.items():
                if got[rid] != toks.tolist():
                    raise AssertionError(
                        f"{label} rank {rank[job]['rank']} run {i} request "
                        f"{rid}: {got[rid]} != solo {toks.tolist()}")


def _mesh_log(label, res, job) -> None:
    for rank in res:
        r = rank[job]
        for i, run in enumerate(r["runs"]):
            toks = sum(len(v) for v in run["tokens"].values())
            log(f"mesh[{label}] rank {r['rank']} {r['coords']} run {i}: "
                f"{toks} tokens {run['wall_s']:.3f}s "
                f"{toks / run['wall_s']:.1f} tok/s host_syncs="
                f"{run['counters']['host_syncs']} chunks="
                f"{run['counters']['chunks']} prefix_hit_rate="
                f"{run['prefix_hit_rate']:.3f} launches={run['launches']}")
        log(f"mesh[{label}] rank {r['rank']}: heads {r['h_local']} KV "
            f"heads {r['kv_local']} ({r['kv_mode']}) experts "
            f"{r['expert_local']}; {r['local_param_bytes'] / 1e9:.3f} GB "
            f"of parameters, peak {r['peak_bytes'] / 1e9:.3f} GB; built "
            f"in {r['init_s']:.1f}s; report {r['report']}")


def serve_mesh(mods):
    """(b)-(d), (f): the serving mesh, its ranks sharing the one card over
    gloo on CUDA tensors (one process each, started here after the solo
    references, which are then freed; each rank builds its own parameter
    shards from the seed, leaf by leaf). (b) qwen2-0.5B at full width and
    depth on a (1, 2) mesh, 4 requests of 100-600 tokens and 16 new: f32
    with draft_k 2 run twice on one engine, tokens equal to the solo f32
    engine's, prefix hits on the second run; bf16: tok/s, the share of
    tokens equal to the solo bf16 serve's, each rank's paged-kernel
    launches; (f) in
    the same ranks, make_compressed_grad_fn over the 2 ranks against the
    same arithmetic on one rank (1e-6). Then four ranks: (d) Mixtral's
    smoke widths (h 8, kv 2) on (1, 4), the GQA fallback, f32 tokens equal
    to solo's and the kv_heads rule reported dropped; and (c)
    Mixtral-8x22B at full width, 2 of 56 layers, f32 on (2, 2): experts
    over "data", heads, KV heads and vocabulary over "model", run twice
    on one engine, every rank's tokens equal to the solo f32 engine's on
    both runs, with the grouped GEMM's launches per rank. Returns the
    launch counts of rank 0's runs by path."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch, get_smoke
    from repro_torch.models import api
    from repro_torch.models.blocks import ModelContext
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sharded import request_dicts, serve_on_mesh

    counts = {}
    paged = ("paged_decode_attention", "paged_decode_span_attention")

    def solo(cfg, dtype, reqs, runs=1, **kw):
        params = init_params(api.model_specs(cfg), seed=0, dtype=dtype,
                             device="cuda")
        ctx = ModelContext(compute_dtype=dtype, device="cuda")
        eng = ServeEngine(cfg, ctx, window=_window(reqs()), max_batch=4,
                          chunk=8, page_size=16, **kw)
        out = []
        for _ in range(runs):
            t0 = time.perf_counter()
            out.append(eng.run(params, reqs()))
            torch.cuda.synchronize()
            toks = sum(len(v) for v in out[-1].values())
            wall = time.perf_counter() - t0
            log(f"solo[{cfg.name} {str(dtype).split('.')[-1]}]: {toks} "
                f"tokens {wall:.3f}s {toks / wall:.1f} tok/s")
        del params, eng
        torch.cuda.empty_cache()
        return out

    def job(cfg_name, dtype, reqs, runs=1, **kw):
        return dict(arch=cfg_name, compute_dtype=dtype, param_dtype=dtype,
                    q_chunk=2048, seed=0, runs=runs,
                    requests=request_dicts(reqs()),
                    engine=dict(window=_window(reqs()), max_batch=4,
                                chunk=8, page_size=16, **kw))

    # (b) and (f) on (1, 2): two ranks
    qwen = get_arch("qwen2_0_5b")
    q32 = lambda: serve_requests(qwen.vocab_size, seed=2, n=4, max_new=16)
    q16 = lambda: serve_requests(qwen.vocab_size, seed=0, n=4, max_new=16)
    want32 = solo(qwen, torch.float32, q32, runs=2, draft_k=2)
    want16 = solo(qwen, torch.bfloat16, q16)[0]
    full = get_arch("mixtral_8x22b")
    mix = dataclasses.replace(full, n_layers=MESH_MIXTRAL_LAYERS)
    mreqs = lambda: serve_requests(mix.vocab_size, seed=3, n=4, max_new=8)
    want_mix = solo(mix, torch.float32, mreqs, runs=2)
    rng = np.random.default_rng(5)
    data = {"params": {"w": rng.standard_normal((64, 32)).astype(np.float32),
                       "b": rng.standard_normal(32).astype(np.float32)},
            "batches": [{"x": rng.standard_normal((16, 64)).astype(
                np.float32), "y": rng.standard_normal((16, 32)).astype(
                    np.float32)} for _ in range(2)]}
    one = compress_on_one_rank(data, 2, steps=3)
    torch.cuda.empty_cache()
    mjob = job("mixtral_8x22b", "float32", mreqs, runs=2)
    mjob.update(overrides={"n_layers": MESH_MIXTRAL_LAYERS}, mesh=(2, 2))
    t0 = time.perf_counter()
    res = serve_on_mesh([
        job("qwen2_0_5b", "float32", q32, runs=2, draft_k=2),
        job("qwen2_0_5b", "bfloat16", q16),
        {"task": "__main__:compress_rank",
         "kwargs": {"grads": data, "steps": 3}},
    ], (1, 2), "cuda", timeout_s=MESH_TIMEOUT_S)
    log(f"mesh (1, 2): 2 ranks on the card, {time.perf_counter() - t0:.1f}s "
        f"with start-up")
    _mesh_log("qwen_f32_1x2", res, 0)
    _mesh_tokens("qwen_f32_1x2", res, 0, want32)
    for rank in res:
        if not rank[0]["runs"][1]["prefix_hit_rate"] > 0:
            raise AssertionError("qwen_f32_1x2: run 2 hit no prefix")
    log("mesh[qwen_f32_1x2]: every rank's tokens equal the solo f32 "
        "engine's on both runs")
    _mesh_log("qwen_bf16_1x2", res, 1)
    same = total = 0
    for rid, toks in want16.items():
        got = res[0][1]["runs"][0]["tokens"][rid]
        same += sum(int(a == b) for a, b in zip(got, toks.tolist()))
        total += len(toks)
    for rank in res:
        c = rank[1]["runs"][0]["launches"]
        if any(c[k] == 0 for k in paged):
            raise AssertionError(f"qwen_bf16_1x2 rank {rank[1]['rank']}: "
                                 f"launches {c}")
    counts["qwen2_0_5b_mesh_1x2"] = res[0][1]["runs"][0]["launches"]
    log(f"mesh[qwen_bf16_1x2]: {same} of {total} tokens "
        f"({100 * same / total:.1f}%) equal the solo bf16 serve's")
    for rank in res:
        for step, ((loss, g, e), (wl, wg, we)) in enumerate(zip(rank[2],
                                                                one)):
            r = rank[1]["rank"]
            gap = max(max(float(np.abs(g[k] - wg[k].cpu().numpy()).max())
                          for k in g),
                      max(float(np.abs(e[k] - we[r][k].cpu().numpy()).max())
                          for k in e))
            if gap > 1e-6 or abs(loss - wl) > 1e-6 * max(1.0, abs(wl)):
                raise AssertionError(f"compress rank {r} step {step}: "
                                     f"{gap} from one rank's arithmetic")
    log("compress: make_compressed_grad_fn over 2 ranks on the card: "
        "mean, error state and loss within 1e-6 of one rank's arithmetic "
        "over 3 steps")
    del res

    # (d) and (c): four ranks, two mesh shapes
    smoke = get_smoke("mixtral_8x22b")
    sreqs = lambda: dense_requests(smoke.vocab_size, 4, (9, 17, 30, 45), 8)
    want_smoke = solo(smoke, torch.float32, sreqs)
    t0 = time.perf_counter()
    sjob = job("mixtral_8x22b", "float32", sreqs)
    sjob.update(smoke=True, mesh=(1, 4))
    res = serve_on_mesh([sjob, mjob], (1, 4), "cuda",
                        timeout_s=MESH_TIMEOUT_S)
    log(f"mesh (1, 4) and (2, 2): 4 ranks on the card, "
        f"{time.perf_counter() - t0:.1f}s with start-up")
    _mesh_log("mixtral_smoke_1x4", res, 0)
    _mesh_tokens("mixtral_smoke_1x4", res, 0, [want_smoke[0]])
    for rank in res:
        r = rank[0]
        if r["kv_mode"] != "slice" or not any(
                "kv_heads=2" in ln for ln in r["report"]["dropped_rules"]):
            raise AssertionError(f"mixtral_smoke_1x4: {r['kv_mode']} "
                                 f"{r['report']}")
    log("mesh[mixtral_smoke_1x4]: every rank's tokens equal the solo f32 "
        "engine's; the GQA fallback's dropped rule reported")
    counts["mixtral_smoke_mesh_1x4"] = res[0][0]["runs"][0]["launches"]
    _mesh_log("mixtral_f32_2x2", res, 1)
    _mesh_tokens("mixtral_f32_2x2", res, 1, want_mix)
    for rank in res:
        c = rank[1]["runs"][0]["launches"]
        if c["grouped_matmul"] == 0 or any(c[k] == 0 for k in paged):
            raise AssertionError(f"mixtral_f32_2x2 rank {rank[1]['rank']}: "
                                 f"launches {c}")
        if rank[1]["expert_local"] != mix.n_experts // 2:
            raise AssertionError(f"mixtral_f32_2x2 rank {rank[1]['rank']}: "
                                 f"{rank[1]['expert_local']} experts")
    log("mesh[mixtral_f32_2x2]: every rank's tokens equal the solo f32 "
        "engine's on both runs; grouped GEMM launches by rank "
        + str([rank[1]["runs"][0]["launches"]["grouped_matmul"]
               for rank in res]))
    counts[f"mixtral_8x22b_{MESH_MIXTRAL_LAYERS}l_mesh_2x2"] = \
        res[0][1]["runs"][0]["launches"]
    return counts


# ------------------------------------------------------------------- train


def _param_count(tree) -> int:
    return sum(p.numel() for p in _leaves(tree))


def device_classes(prof):
    """Device time (ms) of a profile, summed by kind of kernel."""
    classes = (("wkv_backward", ("wkv_bwd_",)),
               ("wkv_forward", ("wkv_",)),
               ("flash", ("flash_wgmma_kernel", "flash_merge_kernel",
                          "flash_f32_kernel")),
               ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "Kernel2")),
               ("softmax", ("oftMax", "softmax")),
               ("reduce", ("reduce_kernel",)),
               ("fill", ("FillFunctor",)),
               ("copy_cast", ("copy_kernel",)),
               ("index_sort", ("index", "sort", "Sort", "scatter",
                               "gather", "radix")))
    out = {}
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        kind = next((c for c, keys in classes
                     if any(k in e.key for k in keys)), "other_elementwise")
        out[kind] = out.get(kind, 0.0) + us / 1e3
    return {k: round(v, 3) for k, v in sorted(out.items(),
                                              key=lambda kv: -kv[1])}


def train_run(label, mods, trainer, state, steps, need):
    """ResilientTrainer.run with every launch counter set to 0 just before
    it and read just after. Returns (state, ledger, losses, counts)."""
    import math
    import torch
    reset_counts(mods)
    state, ledger, losses = trainer.run(state, steps)
    torch.cuda.synchronize()
    counts = read_counts(mods)
    for name in need:
        if counts[name] == 0:
            raise AssertionError(f"{label}: {name} never launched")
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: losses {losses}")
    return state, ledger, losses, counts


def replay_run(label, mods, cfg, ckpt_dir, *, seq, checkpoint_every, steps,
               need):
    """A run with a cube failure at step 5 against an uninterrupted one,
    each through build_trainer (f32, batch 2, checkpoints every
    ``checkpoint_every`` steps under ``ckpt_dir``): the losses must be
    bit-identical, with steps replayed. Returns (the losses, the clean
    run's ledger, the failure run's ledger, its replay summary)."""
    import torch
    from repro_torch.launch.train import build_trainer
    res = {}
    for name, failures in (("clean", None), ("failure", {5: 3})):
        trainer, state = build_trainer(
            cfg, batch=2, seq=seq, ckpt_dir=str(ckpt_dir / name),
            checkpoint_every=checkpoint_every, failures=failures,
            device="cuda")
        _, ledger, losses, _ = train_run(f"{label}_{name}", mods, trainer,
                                         state, steps, need)
        res[name] = (losses, ledger, trainer.replay_summary())
        del trainer, state
        torch.cuda.empty_cache()
    (l1, led1, _), (l2, led2, rs) = res["clean"], res["failure"]
    if l1 != l2 or rs["replayed_steps"] == 0:
        raise AssertionError(f"{label} replay: {l1} vs {l2}, {rs}")
    return l2, led1, led2, rs


def _f32_steps(mods, cfg, pipe, steps, impl, rows=None):
    """``steps`` f32 train steps (TF32 off) of ``cfg`` through the train
    step build_trainer makes, with attention route ``impl``, from the
    seed-0 parameters; ``rows`` (3, B, S) replace the pipeline's M-RoPE
    rows. Returns ([(loss, grad_norm)], the launch counts)."""
    import torch
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models.blocks import ModelContext
    from repro_torch.train.step import init_train_state, make_train_step

    opt = make_optimizer("adamw", total_steps=10_000)
    ctx = ModelContext(compute_dtype=torch.float32, q_chunk=2048,
                       attn_impl=impl, device="cuda")
    step = make_train_step(cfg, ctx, opt)
    state = init_train_state(0, cfg, opt, device="cuda")
    reset_counts(mods)
    out = []
    for i in range(steps):
        batch = pipe.batch_for_step(i)
        if rows is not None:
            batch["positions"] = rows
        state, m = step(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    counts = read_counts(mods)
    del state
    torch.cuda.empty_cache()
    return out, counts


def _f32_kernel_vs_plain(label, mods, cfg, pipe, steps, rows=None):
    """``_f32_steps`` with attn_impl "cuda" and then "ref". Losses within
    rel 1e-4 and grad norms within rel 1e-3 (the train phase's limits);
    flash launches only on the kernel route. Returns ({impl: [(loss,
    grad_norm)]}, the kernel route's counts)."""
    runs, counts = {}, {}
    for impl in ("cuda", "ref"):
        runs[impl], counts[impl] = _f32_steps(mods, cfg, pipe, steps, impl,
                                              rows)
        if (counts[impl]["flash_attention"] > 0) != (impl == "cuda"):
            raise AssertionError(f"{label} {impl}: flash launches "
                                 f"{counts[impl]}")
    for (lk, gk), (lr, gr) in zip(runs["cuda"], runs["ref"]):
        if not (math.isfinite(lk) and abs(lk - lr) <= 1e-4 * abs(lr)
                and abs(gk - gr) <= 1e-3 * gr):
            raise AssertionError(f"{label} kernel vs plain: {runs}")
    return runs, counts["cuda"]


def _rel_gaps(runs, ref):
    """The largest relative gaps of losses and of grad norms between two
    runs of ``_f32_steps``."""
    return (max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(runs, ref)),
            max(abs(a[1] - b[1]) / b[1] for a, b in zip(runs, ref)))


def train_qwen(mods):
    """This slice's path: full-width, full-depth qwen2-0.5B training through
    the flash kernel. Returns the launch counts of its bf16 run and that
    run's measured steptrace (one event per step, the first with warm-up)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.launch.train import build_trainer

    cfg = get_arch("qwen2_0_5b")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        # 1. bf16 compute, f32 parameters and optimizer state
        trainer, state = build_trainer(
            cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, ckpt_dir=str(tmp / "bf16"),
            checkpoint_every=10_000, compute_dtype=torch.bfloat16,
            device="cuda")
        n_params = _param_count(state["params"])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, ledger, losses, counts = train_run(
            "train_bf16", mods, trainer, state, TRAIN_STEPS,
            ("flash_attention",))
        wall = time.perf_counter() - t0
        want = 2 * cfg.n_layers * TRAIN_STEPS  # forward + recompute
        if counts["flash_attention"] != want:
            raise AssertionError(f"flash launches {counts} != {want}")
        hist = trainer.metrics.histogram("train_step_s")
        times = sorted(r.duration_s for r in trainer.records)
        p50, p95 = hist.quantile(0.5), hist.quantile(0.95)
        steady = times[len(times) // 2]
        tokens = TRAIN_BATCH * TRAIN_SEQ
        mfu = 6.0 * n_params * tokens / steady / PEAK_FLOPS["bfloat16"]
        log(f"train[qwen2_0_5b bf16]: {cfg.n_layers} layers, {n_params} "
            f"params, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
            f"{TRAIN_STEPS} steps in {wall:.3f}s; sorted step times "
            f"{[round(t * 1e3, 1) for t in times]} ms; hist p50="
            f"{p50 * 1e3:.1f}ms p95={p95 * 1e3:.1f}ms; median step "
            f"{steady * 1e3:.2f}ms {tokens / steady:.0f} tok/s MFU "
            f"{100 * mfu:.2f}% (6*N*tokens / step / 989 TFLOP/s); goodput "
            f"{ledger.goodput:.4f} (bootstrap ckpt "
            f"{ledger.totals().get('idle', 0.0):.2f}s); losses "
            f"{[round(x, 4) for x in losses]}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
            f"launches={counts}")
        steptrace = trainer.steptrace()
        # three windows of two more steps under the profiler: device time
        # over each window's own wall time (timed inside the profiler),
        # after one unreported step under it (the profiler's first use
        # adds host time to its window)
        with device_profiler():
            state, m = trainer.train_step(
                state, trainer.pipeline.batch_for_step(TRAIN_STEPS))
            float(m["loss"])
        busy, walls = [], []
        for w in range(3):
            batches = [trainer.pipeline.batch_for_step(TRAIN_STEPS + 1
                                                       + 2 * w + i)
                       for i in range(2)]
            torch.cuda.synchronize()
            with device_profiler() as prof:
                t0 = time.perf_counter()
                for b in batches:
                    state, m = trainer.train_step(state, b)
                    float(m["loss"])
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            busy.append(read_profile(prof, walls[-1], top=25 if w == 0
                                     else 0))
            log(f"  device time by class: {device_classes(prof)}")
        log(f"train[qwen2_0_5b bf16] device busy in 3 profiled windows of "
            f"2 steps: {[round(100 * b, 1) for b in busy]} %; window walls "
            f"{[round(x, 4) for x in walls]} s against 2 x the unprofiled "
            f"median step {2 * steady:.4f} s")
        del trainer, state
        torch.cuda.empty_cache()

        # 2. f32, TF32 off: 3 steps through the kernel vs the plain path,
        # each the train step build_trainer makes, from the same params
        pipe = DataPipeline(DataConfig(global_batch=2, seq_len=TRAIN_SEQ,
                                       vocab_size=cfg.vocab_size), cfg)
        runs, _ = _f32_kernel_vs_plain("train f32", mods, cfg, pipe, 3)
        log(f"train[f32 kernel vs plain, batch 2 x {TRAIN_SEQ}]: (loss, "
            f"grad_norm) kernel {runs['cuda']} plain {runs['ref']}")

        # 3. failure + restore + replay == uninterrupted, bit for bit
        l2, led1, led2, rs = replay_run(
            "train_f32", mods, dataclasses.replace(cfg, n_layers=2), tmp,
            seq=512, checkpoint_every=2, steps=7, need=("flash_attention",))
        log(f"train[f32 failure at step 5, ckpt every 2, 2 layers]: losses "
            f"bit-identical to the uninterrupted run {l2}; {rs}; goodput "
            f"{led2.goodput:.4f} vs {led1.goodput:.4f}; ledger "
            f"{led2.structure()}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts, steptrace


# ------------------------------------------------------------- train_state

# the WKV backward's limit, of each result's largest |value| (at least 1):
# f32 sums in another order over up to 2048 tokens, and the cumulative log
# decay's rounding, which the factors exp(cum_excl) and exp(-cum) (up to
# e^64 at chunk 16) carry
WKV_GRAD_LIMIT = 1e-4
WKV_GRAD_NAMES = ("dr", "dk", "dv", "dlogw", "du", "ds0")
# (label, B, S, H, hd, chunk, nonzero s0 and d_state): rwkv6-1.6B's
# training shape (no initial state, no final-state cotangent, as the loss
# has), and the smoke model's heads (hd 16) from a nonzero state
WKV_GRAD_CASES = (
    ("train_rwkv6", 4, 2048, 32, 64, 16, False),
    ("smoke_hd16", 4, 256, 4, 16, 16, True),
)
STATE_TRAIN_STEPS = 6
STATE_CHECK_LAYERS = 4  # of rwkv6's 24 in the f32 kernel-vs-plain runs
# the kernels of csrc/rwkv_wkv_bwd.cu as torch.profiler names them
WKV_BWD_KERNELS = ("wkv_bwd_local", "wkv_bwd_scan", "wkv_bwd_grad",
                   "wkv_bwd_du")
# the forward's group lengths the backward is swept over at the training
# shape (the plan takes 8); "onepass" is one group of every chunk
WKV_GRAD_SWEEP = (1, 2, 4, 8, 16, "onepass")


def wkv_grad_case(label: str, b: int, s: int, h: int, hd: int, chunk: int,
                  nonzero: bool, seed: int = 0):
    """The WKV backward kernel after the forward the plan picks: its six
    results against wkv_backward_plain within WKV_GRAD_LIMIT of each one's
    largest |value|, a repeat bitwise equal, the planted fault (every
    group's gradient walk started from zero) failing the limit; times
    (plain_ms: autograd's backward through chunked_wkv_plain, its graph
    kept), each of its four kernels' device time, its scratch bytes, and
    the bound. No single PyTorch call computes this gradient: library_ms is
    None."""
    import torch
    from repro_torch.kernels import rwkv_scan

    r, k, v, lw, u, s0 = _wkv_inputs(b, s, h, hd, nonzero, False, seed)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 1)
    dout = torch.randn((b, s, h, hd), generator=g, device="cuda")
    dstate = (torch.randn((b, h, hd, hd), generator=g, device="cuda") * 0.5
              if nonzero else None)
    plan = rwkv_scan.wkv_plan(b, s, h, hd, chunk)
    _, _, states, _ = rwkv_scan._forward(r, k, v, lw, u, s0, chunk=chunk,
                                         plan=plan)
    run = lambda **kw: rwkv_scan.rwkv_wkv_backward(
        r, k, v, lw, u, s0, dout, dstate, chunk=chunk, states=states,
        plan=plan, **kw)
    before = rwkv_scan.launches["rwkv_wkv_backward"]
    got = run()
    want = rwkv_scan.wkv_backward_plain(r, k, v, lw, u, s0, dout, dstate,
                                        chunk=chunk)
    torch.cuda.synchronize()
    if rwkv_scan.launches["rwkv_wkv_backward"] != before + 1:
        raise AssertionError("rwkv_wkv_backward: the wrapper did not count "
                             "its launch")

    def reading(x, y):
        return float((x - y).abs().max()) / max(1.0, float(y.abs().max()))

    errs, abs_err = {}, 0.0
    for name, x, y in zip(WKV_GRAD_NAMES, got, want):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"rwkv_wkv_backward {label}: {name} is not "
                                 f"finite")
        errs[name] = reading(x, y)
        abs_err = max(abs_err, float((x - y).abs().max()))
    if max(errs.values()) > WKV_GRAD_LIMIT:
        raise AssertionError(f"rwkv_wkv_backward {label}: {errs} > "
                             f"{WKV_GRAD_LIMIT}")
    again = run()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"rwkv_wkv_backward {label}: a repeat differs")
    bad = run(drop_carry=True)
    planted = max(reading(x, y) for x, y in zip(bad[:4], want[:4]))
    if planted <= WKV_GRAD_LIMIT:
        raise AssertionError(f"rwkv_wkv_backward {label}: the planted fault "
                             f"passes the limit ({planted})")
    # the plain version's time: autograd's backward through the plain
    # chunked WKV, its graph kept
    leaves = [x.clone().requires_grad_() for x in (r, k, v, lw, u, s0)
              if x is not None]
    out, s_final = rwkv_scan.chunked_wkv_plain(*leaves[:5], *leaves[5:],
                                               chunk=chunk)
    outs, cots = ((out, s_final), (dout, dstate)) if nonzero else (
        (out,), (dout,))
    plain = lambda: torch.autograd.grad(outs, leaves, cots,
                                        retain_graph=True)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    times = case_times(run, plain, None, flush, plain_iters=5)
    parts = _wkv_bwd_parts(run, flush)
    del out, s_final, outs, plain, leaves
    n_groups = plan.n_groups if plan.body == "split" else 1
    # least time: r, k, v, logw and dout read once, dr, dk, dv and dlogw
    # written once, the forward's group states (split), u, s0 and d_state
    # read, du and ds0 written; f32 flops ~ 2 B H S (4 hd^2 + 3 c hd)
    nbytes = 4.0 * (9 * b * s * h * hd + 2 * h * hd
                    + (b * h * n_groups * (hd + 1) * hd
                       if plan.body == "split" else 0)
                    + (3 if nonzero else 1) * b * h * hd * hd)
    flops = 2.0 * b * h * s * (4 * hd * hd + 3 * chunk * hd)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS["float32"]
    torch.cuda.empty_cache()
    return {
        "name": "rwkv_wkv_backward", "label": label, "b": b, "s": s,
        "h": h, "hd": hd, "chunk": chunk, "s0": nonzero,
        "body": plan.body, "group": plan.group, "n_groups": n_groups,
        "errs": errs, "max_abs_err": abs_err,
        "limit": WKV_GRAD_LIMIT, "planted_fault": planted,
        "kernels_device_ms": parts,
        "scratch_bytes": rwkv_scan.backward_scratch_bytes(plan, b, h, hd),
        **times,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }


def _wkv_bwd_parts(run, flush):
    """Each backward kernel's device ms a call (0 where a plan does not
    launch it), from one profile of 20 L2-flushed calls."""
    rows = _profiled(run, flush, 20)
    parts = {}
    for kernel in WKV_BWD_KERNELS:
        mine = [(us, n) for name, us, n in rows if kernel in name]
        parts[kernel] = round(sum(us / n for us, n in mine) / 1e3, 4)
    return parts


def wkv_grad_sweep(b: int, s: int, h: int, hd: int, chunk: int) -> None:
    """The backward's device ms after the forward forced to each group
    length of WKV_GRAD_SWEEP, each of its kernels' device ms, and its
    scratch bytes, each run's six results held to WKV_GRAD_LIMIT against
    one wkv_backward_plain: the measurement behind keeping the forward's
    MAX_GROUP for the training step."""
    import torch
    from repro_torch.kernels import rwkv_scan

    r, k, v, lw, u, s0 = _wkv_inputs(b, s, h, hd, False, False, seed=5)
    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    dout = torch.randn((b, s, h, hd), generator=g, device="cuda")
    want = rwkv_scan.wkv_backward_plain(r, k, v, lw, u, s0, dout, None,
                                        chunk=chunk)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    planned = rwkv_scan.wkv_plan(b, s, h, hd, chunk)
    readings = []
    for group in WKV_GRAD_SWEEP:
        plan = (rwkv_scan.make_plan("onepass", b, s, h, hd, chunk)
                if group == "onepass" else
                rwkv_scan.make_plan("split", b, s, h, hd, chunk, group=group))
        _, _, states, _ = rwkv_scan._forward(r, k, v, lw, u, s0, chunk=chunk,
                                             plan=plan)
        run = lambda: rwkv_scan.rwkv_wkv_backward(
            r, k, v, lw, u, s0, dout, None, chunk=chunk, states=states,
            plan=plan)
        err = max(float((x - y).abs().max()) / max(1.0, float(y.abs().max()))
                  for x, y in zip(run(), want))
        if err > WKV_GRAD_LIMIT:
            raise AssertionError(f"wkv backward sweep G={group}: {err} > "
                                 f"{WKV_GRAD_LIMIT}")
        parts = _wkv_bwd_parts(run, flush)
        readings.append(
            f"G={plan.group} ({plan.n_groups} groups) "
            f"{device_ms(run, flush):.4f} {parts} scratch "
            f"{rwkv_scan.backward_scratch_bytes(plan, b, h, hd)} B "
            f"err {err:.2e}")
        del states
    torch.cuda.empty_cache()
    log(f"kernel rwkv_wkv_backward sweep b={b} s={s} h={h} hd={hd} "
        f"chunk={chunk}, device ms a call by the forward's group length: "
        + "; ".join(readings) + f"; the plan takes {planned.body} "
        f"G={planned.group}")


def _f32_state_run(label, mods, cfg, impl, pipe, steps, need):
    """``steps`` f32 train steps (TF32 off) of ``cfg`` through the train
    step build_trainer makes, with ``attn_impl=impl``, from the seed-0
    parameters, after one loss's per-leaf gradients on the first batch.
    Returns ((loss, grad_norm) a step, {leaf: gradient}, launch counts)."""
    import torch
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models import api
    from repro_torch.models.blocks import ModelContext
    from repro_torch.models.params import tree_items, tree_map
    from repro_torch.train.step import init_train_state, make_train_step

    opt = make_optimizer("adamw", total_steps=10_000)
    ctx = ModelContext(compute_dtype=torch.float32, q_chunk=2048,
                       mamba_chunk=64, rwkv_chunk=16, attn_impl=impl,
                       device="cuda")
    step = make_train_step(cfg, ctx, opt)
    state = init_train_state(0, cfg, opt, device="cuda")
    reset_counts(mods)
    params = tree_map(lambda p: p.detach().clone().requires_grad_(),
                      state["params"])
    batch = {key: torch.as_tensor(val, device=ctx.device)
             for key, val in pipe.batch_for_step(0).items()}
    loss, _ = api.loss_fn(params, batch, cfg, ctx)
    loss.backward()
    grads = {path: leaf.grad for path, leaf in tree_items(params)}
    del params, loss
    out = []
    for i in range(steps):
        state, m = step(state, pipe.batch_for_step(i))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    counts = read_counts(mods)
    for name in need:
        if (counts[name] > 0) != (impl == "cuda"):
            raise AssertionError(f"{label} {impl}: {name} launches "
                                 f"{counts[name]}")
    del state
    torch.cuda.empty_cache()
    return out, grads, counts


def _kernel_vs_plain(kernel, plain):
    """What of the f32 kernel run leaves the limits of the plain run's:
    losses rel 1e-4, grad norms rel 1e-3 (the qwen phase's), and each
    leaf of the first batch's gradient within 1e-3 of its largest |value|
    (the grad norms' limit, leaf by leaf)."""
    bad = []
    for i, ((lk, gk), (lr, gr)) in enumerate(zip(kernel[0], plain[0])):
        if abs(lk - lr) > 1e-4 * abs(lr):
            bad.append(f"loss step {i}: {lk} vs {lr}")
        if abs(gk - gr) > 1e-3 * gr:
            bad.append(f"grad_norm step {i}: {gk} vs {gr}")
    for path, want in plain[1].items():
        err = float((kernel[1][path] - want).abs().max())
        if err > 1e-3 * float(want.abs().max()):
            bad.append(f"{path}: {err:.3e} of {float(want.abs().max()):.3e}")
    return bad


def train_state(mods):
    """This slice's path: rwkv6-1.6B training at full width and depth
    through the WKV forward and backward kernels; then f32 kernel vs plain
    (with the backward's planted fault failing it), failure replay at 2
    layers, Jamba's smoke config through the flash kernel and plain Mamba,
    and the WKV backward kernel's cases. Returns the launch counts of each
    run by path."""
    import functools
    import shutil
    import tempfile
    import torch
    from repro_torch.configs.registry import get_arch, get_smoke
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.kernels import rwkv_scan
    from repro_torch.launch.train import build_trainer

    t_phase = time.perf_counter()
    cfg = get_arch("rwkv6_1_6b")
    paths = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_state_ckpt_"))
    try:
        # (a) bf16 compute, f32 parameters and optimizer state
        trainer, state = build_trainer(
            cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, ckpt_dir=str(tmp / "bf16"),
            checkpoint_every=10_000, compute_dtype=torch.bfloat16,
            device="cuda")
        n_params = _param_count(state["params"])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, ledger, losses, counts = train_run(
            "train_state_bf16", mods, trainer, state, STATE_TRAIN_STEPS,
            ("rwkv_wkv", "rwkv_wkv_backward"))
        wall = time.perf_counter() - t0
        want = {"rwkv_wkv": 2 * cfg.n_layers * STATE_TRAIN_STEPS,
                "rwkv_wkv_backward": cfg.n_layers * STATE_TRAIN_STEPS}
        if any(counts[k] != n for k, n in want.items()):
            raise AssertionError(f"rwkv6 train launches {counts} != {want}")
        paths["rwkv6_1_6b_train"] = counts
        times = sorted(r.duration_s for r in trainer.records)
        steady = times[len(times) // 2]
        tokens = TRAIN_BATCH * TRAIN_SEQ
        mfu = 6.0 * n_params * tokens / steady / PEAK_FLOPS["bfloat16"]
        log(f"train_state[rwkv6_1_6b bf16]: {cfg.n_layers} layers, "
            f"{n_params} params, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
            f"{STATE_TRAIN_STEPS} steps in {wall:.3f}s; sorted step times "
            f"{[round(t * 1e3, 1) for t in times]} ms; median step "
            f"{steady * 1e3:.2f}ms {tokens / steady:.0f} tok/s MFU "
            f"{100 * mfu:.2f}% (6*N*tokens / step / 989 TFLOP/s); losses "
            f"{[round(x, 4) for x in losses]}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
            f"launches={counts}")
        # one window of two steps under the profiler, after one
        # unreported step under it
        with device_profiler():
            state, m = trainer.train_step(
                state, trainer.pipeline.batch_for_step(STATE_TRAIN_STEPS))
            float(m["loss"])
        batches = [trainer.pipeline.batch_for_step(STATE_TRAIN_STEPS + 1 + i)
                   for i in range(2)]
        torch.cuda.synchronize()
        with device_profiler() as prof:
            t0 = time.perf_counter()
            for b in batches:
                state, m = trainer.train_step(state, b)
                float(m["loss"])
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
        busy = read_profile(prof, pwall, top=20)
        log(f"train_state[rwkv6_1_6b bf16] device busy {100 * busy:.1f} % "
            f"of a profiled window of 2 steps ({pwall:.4f} s against 2 x "
            f"the unprofiled median step {2 * steady:.4f} s); device time "
            f"by class: {device_classes(prof)}")
        del trainer, state, prof
        torch.cuda.empty_cache()

        # (b) f32, TF32 off: kernel vs plain at 4 of the 24 layers, and the
        # backward's planted fault failing the same check
        cfg4 = dataclasses.replace(cfg, n_layers=STATE_CHECK_LAYERS)
        pipe = DataPipeline(DataConfig(global_batch=1, seq_len=TRAIN_SEQ,
                                       vocab_size=cfg.vocab_size), cfg4)
        need = ("rwkv_wkv", "rwkv_wkv_backward")
        runs = {impl: _f32_state_run("train_state f32", mods, cfg4, impl,
                                     pipe, 3, need)
                for impl in ("cuda", "ref")}
        bad = _kernel_vs_plain(runs["cuda"], runs["ref"])
        if bad:
            raise AssertionError(f"rwkv6 f32 kernel vs plain: {bad}")
        paths["rwkv6_1_6b_train_f32"] = runs["cuda"][2]
        orig = rwkv_scan.rwkv_wkv_backward
        rwkv_scan.rwkv_wkv_backward = functools.partial(orig,
                                                        drop_carry=True)
        try:
            faulty = _f32_state_run("train_state f32 fault", mods, cfg4,
                                    "cuda", pipe, 3, need)
        finally:
            rwkv_scan.rwkv_wkv_backward = orig
        planted = _kernel_vs_plain(faulty, runs["ref"])
        if not planted:
            raise AssertionError("rwkv6 f32: the backward's planted fault "
                                 "passes the kernel-vs-plain check")
        log(f"train_state[rwkv6 f32 kernel vs plain, {STATE_CHECK_LAYERS} "
            f"layers, batch 1 x {TRAIN_SEQ}]: (loss, grad_norm) kernel "
            f"{runs['cuda'][0]} plain {runs['ref'][0]}; every leaf of the "
            f"first batch's gradient within 1e-3 of its largest |value|; "
            f"the planted fault (drop_carry) fails it: {len(planted)} "
            f"findings, e.g. {planted[:3]}")
        del runs, faulty
        torch.cuda.empty_cache()

        # (c) failure + restore + replay == uninterrupted, bit for bit; a
        # checkpoint every 4 steps, since each writes ~4.4 GB of f32 state
        # (the 65536-row embedding and head dominate at 2 layers)
        l2, led1, led2, rs = replay_run(
            "train_state_f32", mods, dataclasses.replace(cfg, n_layers=2),
            tmp, seq=512, checkpoint_every=4, steps=6,
            need=("rwkv_wkv", "rwkv_wkv_backward"))
        log(f"train_state[rwkv6 f32 failure at step 5, ckpt every 4, 2 "
            f"layers]: losses bit-identical to the uninterrupted run {l2}; "
            f"{rs}; goodput {led2.goodput:.4f} vs {led1.goodput:.4f}")

        # (d) Jamba's smoke config: flash kernel and plain Mamba vs plain
        jcfg = get_smoke("jamba_v01_52b")
        jpipe = DataPipeline(DataConfig(global_batch=2, seq_len=512,
                                        vocab_size=jcfg.vocab_size), jcfg)
        jruns = {impl: _f32_state_run("train_state jamba", mods, jcfg, impl,
                                      jpipe, 3, ("flash_attention",))
                 for impl in ("cuda", "ref")}
        bad = _kernel_vs_plain(jruns["cuda"], jruns["ref"])
        if bad:
            raise AssertionError(f"jamba smoke f32 kernel vs plain: {bad}")
        paths["jamba_smoke_train_f32"] = jruns["cuda"][2]
        log(f"train_state[jamba smoke f32 kernel vs plain, batch 2 x 512]: "
            f"(loss, grad_norm) kernel {jruns['cuda'][0]} plain "
            f"{jruns['ref'][0]}; launches={jruns['cuda'][2]}")
        del jruns
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (e) the WKV backward kernel's cases
    grads = [wkv_grad_case(*case) for case in WKV_GRAD_CASES]
    for v in grads:
        errs = ", ".join(f"{k} {e:.3e}" for k, e in v["errs"].items())
        log(f"kernel rwkv_wkv_backward {v['label']} b={v['b']} s={v['s']} "
            f"h={v['h']} hd={v['hd']} chunk={v['chunk']} s0={v['s0']}: "
            f"forward plan {v['body']} G={v['group']} groups={v['n_groups']}"
            f": errors ({errs})"
            f" (limit {v['limit']:.0e} of each result's largest |value|) "
            f"planted_fault(drop_carry)={v['planted_fault']:.3e} "
            f"{times_text(v)} (plain: autograd's backward through "
            f"chunked_wkv_plain; no PyTorch call computes the gradient) "
            f"kernels device ms {v['kernels_device_ms']} "
            f"scratch_bytes={v['scratch_bytes']} "
            f"bound_ms={v['bound_ms']:.5f} ({v['bound_by']}) "
            f"bytes={v['bytes']:.4g} flops={v['flops']:.4g}")
    wkv_grad_sweep(*WKV_GRAD_CASES[0][1:6])
    log(f"train_state phase: {time.perf_counter() - t_phase:.1f}s")
    return paths, grads


# ------------------------------------------------------------ train_encdec

ENCDEC_BATCH, ENCDEC_SEQ, ENCDEC_STEPS = 8, 448, 6
VL_TRAIN_LAYERS = 2  # of Qwen2-VL-7B's 28 in the f32 kernel-vs-plain runs
VL_TRAIN_SEQ = 1024


def _attention_backward_ms(cfg, batch: int, seq: int) -> dict:
    """The plain attention backward (``_FlashAttention.backward``: the
    q-chunked plain path's gradient, recomputed) at Whisper's three
    training shapes in bf16, ms a call by CUDA events over 5 L2-flushed
    calls: the encoder's self attention, the decoder's causal one and its
    cross attention."""
    import torch
    from repro_torch.models.attention import _FlashAttention
    h, d = cfg.n_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for name, sq, sk, atype in (("encoder", cfg.encoder_seq,
                                 cfg.encoder_seq, "bidirectional"),
                                ("decoder", seq, seq, "causal"),
                                ("cross", seq, cfg.encoder_seq,
                                 "bidirectional")):
        q, k, v = (torch.randn((batch, s_, h, d), generator=gen,
                               device="cuda", dtype=torch.bfloat16)
                   .requires_grad_() for s_ in (sq, sk, sk))
        o = _FlashAttention.apply(q, k, v, atype, None, 2048, "cuda")
        g = torch.randn_like(o)
        out[name] = timed_ms(
            lambda: torch.autograd.grad(o, (q, k, v), g, retain_graph=True),
            flush, iters=5, warmup=1)
        del q, k, v, o, g
    torch.cuda.empty_cache()
    return out


def train_encdec(mods):
    """This slice's path: the encoder-decoder and M-RoPE families through
    the training loss. (a) full-size Whisper-small, bf16, through the
    flash kernel; (b) Whisper f32 kernel vs plain; (c) Whisper's failure
    replay at 2 + 2 layers; (d) Qwen2-VL-7B at full width, 2 of 28
    layers, f32 kernel vs plain on image-grid rows; (e) the port's
    serve_decode and failure_recovery examples on the card. Returns the
    launch counts of each run by path."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.examples import failure_recovery, serve_decode
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch.train import build_trainer

    t_phase = time.perf_counter()
    cfg = get_arch("whisper_small")
    paths = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_encdec_ckpt_"))
    try:
        # (a) bf16 compute, f32 parameters and optimizer state
        trainer, state = build_trainer(
            cfg, batch=ENCDEC_BATCH, seq=ENCDEC_SEQ,
            ckpt_dir=str(tmp / "bf16"), checkpoint_every=10_000,
            compute_dtype=torch.bfloat16, device="cuda")
        n_params = _param_count(state["params"])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, ledger, losses, counts = train_run(
            "train_encdec_bf16", mods, trainer, state, ENCDEC_STEPS,
            ("flash_attention",))
        wall = time.perf_counter() - t0
        per_step = cfg.encoder_layers + 2 * cfg.n_layers
        want = 2 * per_step * ENCDEC_STEPS  # forward + recompute
        if counts["flash_attention"] != want:
            raise AssertionError(f"whisper flash launches {counts} != "
                                 f"{want}")
        paths["whisper_small_train"] = counts
        times = sorted(r.duration_s for r in trainer.records)
        steady = times[len(times) // 2]
        tokens = ENCDEC_BATCH * ENCDEC_SEQ
        log(f"train_encdec[whisper_small bf16]: {cfg.encoder_layers} + "
            f"{cfg.n_layers} layers, {n_params} params, batch "
            f"{ENCDEC_BATCH} x {ENCDEC_SEQ} decoder tokens over "
            f"{cfg.encoder_seq} frames, {ENCDEC_STEPS} steps in "
            f"{wall:.3f}s; sorted step times "
            f"{[round(t * 1e3, 1) for t in times]} ms; median step "
            f"{steady * 1e3:.2f}ms {tokens / steady:.0f} decoder tok/s "
            f"{ENCDEC_BATCH * cfg.encoder_seq / steady:.0f} frames/s; "
            f"losses {[round(x, 4) for x in losses]}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
            f"launches={counts} ({per_step} a forward: "
            f"{cfg.encoder_layers} encoder, {cfg.n_layers} causal, "
            f"{cfg.n_layers} cross)")
        # one window of two steps under the profiler, after one
        # unreported step under it
        with device_profiler():
            state, m = trainer.train_step(
                state, trainer.pipeline.batch_for_step(ENCDEC_STEPS))
            float(m["loss"])
        batches = [trainer.pipeline.batch_for_step(ENCDEC_STEPS + 1 + i)
                   for i in range(2)]
        torch.cuda.synchronize()
        with device_profiler() as prof:
            t0 = time.perf_counter()
            for b in batches:
                state, m = trainer.train_step(state, b)
                float(m["loss"])
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
        busy = read_profile(prof, pwall, top=20)
        log(f"train_encdec[whisper_small bf16] device busy "
            f"{100 * busy:.1f} % of a profiled window of 2 steps "
            f"({pwall:.4f} s against 2 x the unprofiled median step "
            f"{2 * steady:.4f} s); device time by class: "
            f"{device_classes(prof)}")
        del trainer, state, prof
        torch.cuda.empty_cache()
        bwd = _attention_backward_ms(cfg, ENCDEC_BATCH, ENCDEC_SEQ)
        step_bwd = (bwd["encoder"] * cfg.encoder_layers
                    + (bwd["decoder"] + bwd["cross"]) * cfg.n_layers)
        log(f"train_encdec[whisper_small bf16] plain attention backward "
            f"(ms a call, CUDA events): {bwd}; x layers = "
            f"{step_bwd:.2f} ms a step, {100 * step_bwd / 1e3 / steady:.1f}"
            f" % of the median step")

        # (b) f32, TF32 off: kernel vs plain from the same parameters
        pipe = DataPipeline(DataConfig(global_batch=2, seq_len=ENCDEC_SEQ,
                                       vocab_size=cfg.vocab_size), cfg)
        runs, c = _f32_kernel_vs_plain("whisper f32", mods, cfg, pipe, 3)
        paths["whisper_small_train_f32"] = c
        log(f"train_encdec[whisper f32 kernel vs plain, batch 2 x "
            f"{ENCDEC_SEQ}]: (loss, grad_norm) kernel {runs['cuda']} plain "
            f"{runs['ref']}; launches={c}; rel gaps (loss, grad_norm) "
            f"{_rel_gaps(runs['cuda'], runs['ref'])}")
        # a reading, not a check: the same kernel route with the cross
        # attention's kernel told S_k - 1 keys, to see whether these
        # limits would catch a wrong cross-attention kernel (the kernel
        # cases hold the kernel itself to its limits)
        real = flash.flash_attention
        flash.flash_attention = lambda q, k, v, **kw: real(
            q, k, v, drop_last_key=k.shape[1] != q.shape[1], **kw)
        try:
            bad, _ = _f32_steps(mods, cfg, pipe, 3, "cuda")
        finally:
            flash.flash_attention = real
        gaps = _rel_gaps(bad, runs["ref"])
        caught = gaps[0] > 1e-4 or gaps[1] > 1e-3
        log(f"train_encdec[whisper f32, planted fault: cross attention "
            f"told S_k - 1 keys]: (loss, grad_norm) {bad}; rel gaps "
            f"(loss, grad_norm) to plain {gaps} (limits 1e-4, 1e-3): "
            f"{'caught' if caught else 'NOT caught'} by the training "
            f"comparison")

        # (c) failure + restore + replay == uninterrupted, bit for bit
        l2, led1, led2, rs = replay_run(
            "train_encdec_f32", mods,
            dataclasses.replace(cfg, n_layers=2, encoder_layers=2), tmp,
            seq=ENCDEC_SEQ, checkpoint_every=2, steps=7,
            need=("flash_attention",))
        log(f"train_encdec[whisper f32 failure at step 5, ckpt every 2, "
            f"2 + 2 layers]: losses bit-identical to the uninterrupted run "
            f"{l2}; {rs}; goodput {led2.goodput:.4f} vs "
            f"{led1.goodput:.4f}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (d) Qwen2-VL-7B at full width, 2 of its 28 layers, on image-grid rows
    # (64 text tokens, a 16 x 16 image, then text): text rows would reduce
    # M-RoPE to RoPE
    vcfg = dataclasses.replace(get_arch("qwen2_vl_7b"),
                               n_layers=VL_TRAIN_LAYERS)
    vpipe = DataPipeline(DataConfig(global_batch=1, seq_len=VL_TRAIN_SEQ,
                                    vocab_size=vcfg.vocab_size), vcfg)
    rows = vl_rows(VL_TRAIN_SEQ, 64, 16)[:, None, :]
    runs, c = _f32_kernel_vs_plain("qwen2-vl f32", mods, vcfg, vpipe, 3,
                                   rows=np.ascontiguousarray(rows))
    paths[f"qwen2_vl_7b_{VL_TRAIN_LAYERS}l_train_f32"] = c
    log(f"train_encdec[qwen2_vl_7b f32 kernel vs plain, full width cut to "
        f"{VL_TRAIN_LAYERS} of 28 layers, batch 1 x {VL_TRAIN_SEQ}, "
        f"image-grid rows (64 text, 16 x 16 image, text)]: (loss, "
        f"grad_norm) kernel {runs['cuda']} plain {runs['ref']}; "
        f"launches={c}")

    # (e) the port's two example twins on the card
    reset_counts(mods)
    lines = _captured(lambda: serve_decode.main([]), "serve_decode")
    paths["serve_decode"] = read_counts(mods)
    if len(lines) != 3:
        raise AssertionError(f"serve_decode printed {lines}")
    reset_counts(mods)
    ok = _captured(lambda: failure_recovery.main([]), "failure_recovery")
    paths["failure_recovery"] = read_counts(mods)
    if ok is not True or paths["failure_recovery"]["flash_attention"] == 0:
        raise AssertionError(f"failure_recovery: {ok}, "
                             f"{paths['failure_recovery']}")
    log(f"train_encdec[examples]: serve_decode launches="
        f"{paths['serve_decode']}; failure_recovery launches="
        f"{paths['failure_recovery']}")
    log(f"train_encdec phase: {time.perf_counter() - t_phase:.1f}s")
    return paths


# ------------------------------------------------------------------ fleet


def _port_module(args, label: str, timeout: int):
    """Run ``python -m <args>`` of the port in a process of its own, with
    src on its path. Logs its output line by line and returns it with the
    exit code."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + (os.pathsep + env["PYTHONPATH"]
                                    if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    for line in proc.stdout.splitlines():
        log(f"  {label}| {line}")
    log(f"{label}: exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f}s")
    if proc.returncode:
        log(f"  {label} stderr: {proc.stderr[-3000:]}")
    return proc.stdout, proc.returncode


def _captured(fn, label: str):
    """Call ``fn`` with its standard output captured, then log it.
    Returns what ``fn`` returned."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = fn()
    finally:
        for line in buf.getvalue().splitlines():
            if line.strip():
                log(f"  {label}| {line}")
    log(f"{label}: done in {time.perf_counter() - t0:.1f}s")
    return out


def _chunk_fit(st):
    """The decode chunks of a serve steptrace as
    ``service_model_from_trace`` fits them: (number, mean s) of the chunks
    at each recorded batch, and the least-squares slope of chunk time in
    batch before the fit clamps it at 0 (None when the batch never
    varies)."""
    from repro_torch.obs.steptrace import EFFECTIVE_KINDS
    bs = st.feature_values("batch", EFFECTIVE_KINDS, default=1.0)
    ds = st.durations(EFFECTIVE_KINDS)
    by_batch = {}
    for b, d in zip(bs, ds):
        by_batch.setdefault(b, []).append(d)
    n = len(ds)
    mean_b, mean_d = sum(bs) / n, sum(ds) / n
    var_b = sum((b - mean_b) ** 2 for b in bs) / n
    slope = (sum((b - mean_b) * (d - mean_d) for b, d in zip(bs, ds))
             / n / var_b if var_b > 1e-12 else None)
    return slope, {b: (len(v), sum(v) / len(v))
                   for b, v in sorted(by_batch.items())}


def fleet_phase(mods, train_trace):
    """The fleet simulator fed by the card: the bridge against the port's
    trainer on the card, a full-width qwen2-0.5B serve and the trace gate
    over its trace, the simulator driven by the train phase's steptrace,
    the five scenario files, fleet_week and the quickstart. Returns the
    launch counts of its two in-process training runs."""
    import shutil
    import tempfile
    import torch
    from repro_torch.examples import fleet_week, quickstart
    from repro_torch.fleet import (GRAMMAR_KINDS, FleetSimulator,
                                   StepTimeModel, grammar_ok,
                                   job_spec_from_trace, load_scenario_paths,
                                   run_bridge, run_scenario,
                                   service_model_from_trace)
    from repro_torch.launch import trace_gate
    from repro_torch.obs.steptrace import StepTrace

    counts = {}
    # (a) the bridge: the port's trainer on the card vs the simulator
    reset_counts(mods)
    t0 = time.perf_counter()
    out = run_bridge(device="cuda")
    torch.cuda.synchronize()
    counts["fleet_bridge"] = read_counts(mods)
    for side in ("real_structure", "sim_structure"):
        if not all(k in GRAMMAR_KINDS for k, _ in out[side]):
            raise AssertionError(f"bridge {side} leaves the grammar: "
                                 f"{out[side]}")
    if not out["match"] or counts["fleet_bridge"]["flash_attention"] == 0:
        raise AssertionError(f"bridge: match={out['match']} "
                             f"{out['real_structure']} vs "
                             f"{out['sim_structure']}; launches "
                             f"{counts['fleet_bridge']}")
    log(f"fleet[bridge qwen2-smoke on the card, 18 steps, ckpt every 6, "
        f"failures {{9: 0, 14: 1}}]: match={out['match']} in "
        f"{time.perf_counter() - t0:.1f}s; real goodput "
        f"{out['real_goodput']:.4f} sim goodput {out['sim_goodput']:.4f}; "
        f"{out['replay_summary']}; structure {out['real_structure']}; "
        f"launches={counts['fleet_bridge']}")

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_fleet_"))
    try:
        # (b) a full-width serve through the port's launcher, then the gate
        trace, steps = tmp / "serve_trace.json", tmp / "serve_steptrace.json"
        _, rc = _port_module(
            ["repro_torch.launch.serve", "--arch", "qwen2_0_5b", "--trace",
             "8", "--trace-out", str(trace), "--steptrace-out", str(steps)],
            "serve[qwen2_0_5b full width]", 600)
        if rc or not trace.exists() or not steps.exists():
            raise AssertionError(f"full-width serve exited {rc}")
        gate = _captured(lambda: trace_gate.run_gate(
            str(trace), str(steps), "cuda"), "trace_gate")
        # stage 2, the trainer, raises if it fails; the others are checks
        stages = dict(gate["stages"])
        cal_problems = stages.pop("serve calibration")
        if len(stages) != 3 or any(stages.values()):
            raise AssertionError(f"trace gate stages {gate['stages']}")
        cal = gate["calibration"]
        slope, by_batch = _chunk_fit(StepTrace.read(str(steps)))
        log(f"fleet[trace gate on the full-width serve]: stages 1-4 ok; "
            f"stage 5 (calibration, a reading) "
            f"{'FAILED' if cal_problems else 'ok'}: rel_err "
            f"{cal['rel_err']:.3e}, sim chunk {cal['sim_chunk_s']:.6f}s "
            f"vs measured {cal['measured_chunk_s']:.6f}s at batch "
            f"{cal['target_batch']:.0f} (exact by construction when the "
            f"fitted slope is 0: the sim then replays the trace's mean "
            f"chunk); unclamped slope "
            f"{'none (one batch)' if slope is None else f'{slope:.6e}'}"
            f" s a slot; chunks at each batch (count, mean s) "
            f"{ {b: (c, round(m, 6)) for b, (c, m) in by_batch.items()} }")

        # (c) the simulator fed by the card's full-width training
        model = StepTimeModel.from_trace(train_trace)
        first = train_trace.events[0]
        spec = job_spec_from_trace("h100_qwen2_0_5b", train_trace,
                                   chips=2048, total_steps=20_000,
                                   checkpoint_every_steps=600,
                                   scale_policy="shrink", min_cubes=8)
        # the card's job in job0's place on fleet_week's pod
        sim = FleetSimulator(fleet_week.pod_config(),
                             [spec] + fleet_week.pod_jobs()[1:])
        sim.run(2 * 86400.0)
        job = sim.jobs["h100_qwen2_0_5b"]
        if job.state != "done" or not grammar_ok(job.ledger):
            raise AssertionError(f"card-fed sim job {job.state}, grammar "
                                 f"{grammar_ok(job.ledger)}")
        log(f"fleet[sim fed by the bf16 train steptrace, qwen2-0.5B 4 x "
            f"2048]: measured step model mean {model.mean_step_s:.6f}s over "
            f"{len(model.durations)} steps {list(model.durations)} (first "
            f"event: {first.kind} {first.duration_s:.6f}s, warm-up "
            f"included); job of 20000 steps on 32 Ironwood cubes of 144 "
            f"(16 spares) beside 3 fleet_week jobs: {job.state} at "
            f"{job.completed_at:.1f}s, goodput {job.ledger.goodput:.6f}, "
            f"ledger {job.ledger.summary()}, fleet "
            f"{sim.fleet_summary()}")

        # (d) the five scenario files, in place, then serve_train_mix with
        # its service model calibrated from the card's serve steptrace
        paths = load_scenario_paths(ROOT / "benchmarks" / "scenarios")
        if len(paths) != 5:
            raise AssertionError(f"scenario files: {paths}")
        for path in paths:
            doc = json.loads(path.read_text())
            res = run_scenario(doc)
            if not res["ok"]:
                raise AssertionError(f"scenario {path.stem}: "
                                     f"{res['checks']}")
            log(f"fleet[scenario {path.stem}]: ok, "
                f"{len(res['checks'])} gates held")
        measured = service_model_from_trace(StepTrace.read(str(steps)))
        doc = json.loads((ROOT / "benchmarks" / "scenarios"
                           / "serve_train_mix.json").read_text())
        res = run_scenario(doc, service=measured)
        gates = [(c["metric"], c["op"], c["value"], c["target"], c["ok"])
                 for c in res["checks"]]
        log(f"fleet[scenario serve_train_mix, service model from the card's "
            f"serve steptrace {measured}]: ok={res['ok']} (a reading); "
            f"gates {gates}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (e) fleet_week at its defaults, then the quickstart on the card
    _captured(lambda: fleet_week.main([]), "fleet_week")
    reset_counts(mods)
    _captured(lambda: quickstart.main(["--device", "cuda"]), "quickstart")
    torch.cuda.synchronize()
    counts["quickstart"] = read_counts(mods)
    if counts["quickstart"]["flash_attention"] == 0:
        raise AssertionError(f"quickstart launches {counts['quickstart']}")
    log(f"fleet[quickstart]: launches={counts['quickstart']}")
    # the device's share of a window of two quickstart steps, after one
    # step under the profiler to warm it
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer, state = quickstart.make_trainer(ckpt_dir, device="cuda")
        batches = [trainer.pipeline.batch_for_step(i) for i in range(3)]
        with device_profiler():
            state, m = trainer.train_step(state, batches[0])
            float(m["loss"])
        torch.cuda.synchronize()
        with device_profiler() as prof:
            t0 = time.perf_counter()
            for b in batches[1:]:
                state, m = trainer.train_step(state, b)
                float(m["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = read_profile(prof, wall, top=8)
        del trainer, state
    torch.cuda.empty_cache()
    log(f"fleet[quickstart step profile]: 2 steps of 8 x 128 in {wall:.4f}s "
        f"wall, device busy {100 * busy:.2f} %")
    return counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import os
    # a fixed cuBLAS workspace, before cuBLAS starts: the train phase's
    # deterministic mode needs it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    global FLASH_ROW_C, row_steps
    from repro_torch.kernels.ref import FLASH_ROW_C, row_steps
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as kern
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import moe_gemm
    from repro_torch.kernels import rwkv_scan
    from repro_torch.kernels import sparse_gather
    mods = (kern, moe_gemm, flash, mm, rwkv_scan, sparse_gather)

    # f32 comparisons run in full f32 (matmul and cuDNN)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")
    t_start = time.perf_counter()

    # 2. build
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f}s "
        f"{[str(p.relative_to(ROOT)) for p in libs.values()]}")
    for src, lib in libs.items():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "C7519" in line:  # notes of fences ptxas inserted
                continue
            if ("registers" in line or "spill" in line
                    or (src in (kern.SPAN_SOURCE, flash.SOURCE, mm.SOURCE,
                                kern.DENSE_SOURCE, kern.PAGED_DECODE_SOURCE)
                        and ("entry function" in line
                             or "serialized" in line))):
                log(f"  ptxas: {line.strip()}")
    # the span kernel's dynamic shared memory per block at Mixtral's table
    # width (289 pages of 16)
    for d in kern.SPAN_HEAD_DIMS:
        for pdt in (torch.bfloat16, torch.int8):
            _, smem, per_sm = kern.span_plan(
                kern._DTYPE_CODE[pdt], 4, 128, 48, 8, d, 16, 289,
                torch.cuda.get_device_properties(0).multi_processor_count)
            log(f"  span kernel D={d} {str(pdt).split('.')[-1]} pages: "
                f"{smem} bytes of shared memory per block, {per_sm} "
                f"blocks per SM")
    # the bf16 flash kernel's, per tile width (one block per SM)
    for d_tile in flash.TILES:
        plan = flash.flash_plan(1, 128, 128, d_tile, causal=True,
                                window=None)
        log(f"  flash kernel tile width {d_tile}: {plan.smem} bytes of "
            f"shared memory per block, {plan.keys} keys a tile, "
            f"{plan.stages} stages")

    # the bf16 matmul's and dense decode's, from the built sources
    bm, bn, bk, stages, group, smem = mm.bf16_tile()
    log(f"  matmul bf16 body: {bm} x {bn} tiles, K tiles of {bk}, {stages} "
        f"stages, groups of {group} tile rows, {smem} bytes of shared "
        f"memory per block (one block per SM)")
    for dp in (16, 32, 64, 128, 256):
        keys, stages, splits, smem = kern.dense_bf16_ring(dp)
        log(f"  dense decode bf16 body tile width {dp}: {keys} keys a "
            f"stage, {stages} stages, {smem} bytes of shared memory per "
            f"block, at most {splits} splits (one cluster) a row")

    for pdt in (torch.bfloat16, torch.int8):
        for dp in (16, 32, 64, 128, 256):
            keys, stages, splits, smem = kern.built_paged_ring(pdt, dp)
            if (stages, smem) != kern.paged_decode_ring(
                    dp, pdt == torch.int8):
                raise AssertionError(f"paged decode body {pdt} at tile "
                                     f"width {dp}: built ({stages}, {smem})"
                                     f" differs from paged_decode_plan's")
            log(f"  paged decode bf16 body, {str(pdt).split('.')[-1]} "
                f"pages, tile width {dp}: {keys} keys a stage, {stages} "
                f"stages, {smem} bytes of shared memory per block, at most "
                f"{splits} splits (one cluster) a row")

    # 3. kernels against their plain versions at serving shapes
    variants = []
    for pages in ("bf16", "f32", "int8"):
        variants.append(kernel_case(kern, "paged_decode_attention", pages,
                                    t=1))
        for t in (3, 128):
            variants.append(kernel_case(
                kern, "paged_decode_span_attention", pages, t=t))
    variants.append(kernel_case(kern, "paged_decode_attention", "bf16",
                                t=1, d=128, window=500))
    variants.append(kernel_case(kern, "paged_decode_span_attention", "bf16",
                                t=128, d=128, window=500, fault=True))
    # Mixtral's: max_batch 4, 6 query heads per KV head, the 4096-token
    # window; one row below the window, one whose span straddles its
    # edge, two with trimmed pages
    mix_attn = dict(h=48, kv=8, d=128, window=4096,
                    ctxs=(1000, 4150, 4400, 4608))
    for pages in ("bf16", "f32", "int8"):
        variants.append(kernel_case(kern, "paged_decode_attention", pages,
                                    t=1, **mix_attn))
        variants.append(kernel_case(kern, "paged_decode_span_attention",
                                    pages, t=128, fault=pages != "f32",
                                    **mix_attn))
    # 16-token spans at Mixtral's heads: byte-bound
    for pages in ("bf16", "int8"):
        variants.append(kernel_case(kern, "paged_decode_span_attention",
                                    pages, t=16, **mix_attn))
    # phi4-mini's heads: 3 query heads per KV head, D=128, B=4
    phi4_attn = dict(b=4, h=24, kv=8, d=128, max_ctx=1024)
    for pages in ("bf16", "f32"):
        variants.append(kernel_case(kern, "paged_decode_attention", pages,
                                    t=1, **phi4_attn))
        variants.append(kernel_case(kern, "paged_decode_span_attention",
                                    pages, t=128, **phi4_attn))
    # phi4-mini's 128K context over the engine's 8-slot pages: a table row
    # of 16,385 pages, whose ids the span kernel reads stage by stage
    wide_attn = dict(h=24, kv=8, d=128, p=8, ctxs=(131072,))
    for pages in ("bf16", "int8"):
        variants.append(kernel_case(kern, "paged_decode_span_attention",
                                    pages, t=16, **wide_attn))
    # one-token decodes at Qwen2-VL-7B's heads (28/4 x 128), at the wide
    # row and at the floor: B 8 at qwen's heads, every context 16 (one
    # stage a row: the body's fixed latency)
    vl_attn = dict(b=4, h=28, kv=4, d=128, ctxs=(132, 356, 512, 632))
    for shape in (vl_attn, wide_attn):
        for pages in ("bf16", "int8"):
            variants.append(kernel_case(kern, "paged_decode_attention",
                                        pages, t=1, **shape))
    variants.append(kernel_case(kern, "paged_decode_attention", "bf16",
                                t=1, ctxs=(16,) * 8))
    # the serving mesh's per-rank shapes on model=2: qwen2-0.5B's decode
    # (7 query heads over 1 KV head, D 64) and Mixtral's 128-token span
    # (24 over 4, D 128), each also reading another rank's KV-head block
    # (a planted fault)
    for pages in ("bf16", "int8"):
        variants.append(shard_kernel_case(kern, "paged_decode_attention",
                                          pages, t=1, m=2))
    variants.append(shard_kernel_case(kern, "paged_decode_span_attention",
                                      "bf16", t=128, m=2, **mix_attn))
    for v in variants:
        body = ""
        if "splits" in v:
            sweep = " ".join(f"{s}={ms:.4f}" for s, ms
                             in v["splits_device_ms"].items())
            body = (f"splits={v['splits']} stages={v['stages']} smem="
                    f"{v['smem']} ranks_with_keys={v['ranks_with_keys']} "
                    f"wmma_device_ms={v['wmma_device_ms']:.4f} (wmma "
                    f"max_abs_err {v['wmma_max_abs_err']:.3e}) "
                    f"splits_device_ms {sweep} ")
        log(f"kernel {v['name']} pages={v['pages']} t={v['t']} b={v['b']} "
            f"h={v['h']}/{v['kv']} d={v['d']} window={v['window']} "
            f"max_ctx={v['max_ctx']} trimmed_pages={v['trimmed_pages']} "
            f"source={v['source']}: {body}"
            f"max_abs_err={v['max_abs_err']:.3e} row_steps={v['row_steps']} "
            f"planted_fault={v['planted_fault']} "
            f"{times_text(v)} (SDPA) bound_ms={v['bound_ms']:.4f}"
            f" ({v['bound_by']})")
        if "shard" in v:
            log(f"  shard: {v['shard']}: max_abs_err against the whole "
                f"pool's heads {v['full_pool_err']:.3e}; planted_fault("
                f"KV block of heads from {v['wrong_block_start']})="
                f"{v['planted_fault_block']:.3e}")
    gemms = []
    mix_d, mix_f = 6144, 16384
    for xdt, wdt in (("bf16", "bf16"), ("f32", "f32"), ("bf16", "int8")):
        for t in (4, 128):
            gemms.append(gemm_case("grouped_matmul", xdt, wdt, t=t, d=mix_d,
                                   f=mix_f))
        gemms.append(gemm_case("grouped_matmul", xdt, wdt, t=4, d=mix_f,
                               f=mix_d))  # down projection, decode
        gemms.append(gemm_case("grouped_matmul", xdt, wdt, t=10, d=64, f=96,
                               e=4))  # mixtral smoke widths
    gemms.append(gemm_case("grouped_matmul", "bf16", "bf16", t=128,
                           d=mix_f, f=mix_d))  # down projection, prefill
    gemms.append(gemm_case("grouped_matmul", "bf16", "bf16", t=4, d=mix_d,
                           f=mix_f, all_pad=True))
    # Mixtral's ring prefill: a 4500-token prompt prefilled whole
    for d, f in ((mix_d, mix_f), (mix_f, mix_d)):
        gemms.append(gemm_case("grouped_matmul", "bf16", "bf16", t=4500,
                               d=d, f=f))
    # Jamba's experts (16, top-2, 4096 x 14336) at a decode step of 4
    for d, f in ((4096, 14336), (14336, 4096)):
        gemms.append(gemm_case("grouped_matmul", "bf16", "bf16", t=4, d=d,
                               f=f, e=16))
    # Mixtral's bf16 shapes through the body the plan does not pick
    for t in (4, 128, 4500):
        for d, f in ((mix_d, mix_f), (mix_f, mix_d)):
            chosen = [v for v in gemms if v["x"] == v["w"] == "bf16"
                      and v["t"] == t and v["d"] == d and v["e"] == 8][0]
            gemms.append(gemm_case(
                "grouped_matmul", "bf16", "bf16", t=t, d=d, f=f,
                body="wgmma" if chosen["body"] == "stream" else "stream"))
    # expert parallelism over data=2 (Mixtral's 8 experts, rank 0 holds
    # 4): about half the tiles are -1; a decode step and a 128-token chunk,
    # up and down, bf16 and f32
    for xdt in ("bf16", "f32"):
        for t, d, f in ((4, mix_d, mix_f), (128, mix_d, mix_f),
                        (4, mix_f, mix_d)):
            gemms.append(gemm_case("grouped_matmul", xdt, xdt, t=t, d=d,
                                   f=f, ep=(2, 0)))
    for v in gemms:
        log(f"kernel grouped_matmul x={v['x']} w={v['w']} t={v['t']} "
            f"M={v['m']} D={v['d']} F={v['f']} E={v['e']} "
            f"experts={v['experts']} body={v['body']} splits={v['splits']} "
            f"grid={v['grid']}"
            f"{' (forced)' if v['forced'] else ''}: "
            f"max_abs_err={v['max_abs_err']:.3e} (tol {v['tol']:.3e}, max "
            f"|out| {v['max_abs_out']:.3e}) planted_fault(ids rotated)="
            f"{v['planted_fault']} {times_text(v)} "
            f"bound_ms={v['bound_ms']:.4f} ({v['bound_by']}) "
            f"bytes={v['bytes']:.4g} design_weight_bytes="
            f"{v['design_weight_bytes']:.4g}")
        if "ep" in v:
            log(f"  expert parallel: {v['ep']}: {v['tiles_minus_one']} of "
                f"{v['tiles']} tiles -1; the ranks' sum "
                f"{v['ep_sum_err']:.3e} from the one-device product; "
                f"planted_fault(non-local tile with a real id)="
                f"{v['planted_fault_nonlocal']:.3e}")
    # the readings behind the plan: the stream body's splits at decode and
    # chunk shapes, and both bodies from 8 to 1024 tokens
    stream = lambda s, wd=torch.bfloat16: moe_gemm.stream_plan(wd, s)
    wgmma = moe_gemm.wgmma_plan()
    for d, f in ((mix_d, mix_f), (mix_f, mix_d)):
        gemm_sweep("splits", t=4, d=d, f=f,
                   plans=[stream(s) for s in (1, 2, 4, 8)])
        for t in (4, 128):
            gemm_sweep("splits", t=t, d=d, f=f, wdt="int8",
                       plans=[stream(s, torch.int8) for s in (1, 2, 4, 8)])
    for t in (8, 16, 32, 64, 256, 1024):
        gemm_sweep("bodies", t=t, d=mix_d, f=mix_f,
                   plans=[stream(1), stream(2), wgmma])
    flashes = [flash_case(dt, **kw)
               for dt in ("bf16", "f32")
               for kw in ({}, {"window": 512}, {"causal": False},
                          {"bh": 12, "s": 128, "d": 8})]
    # Mixtral's ring prefill: 48 heads x 128, a 4500-token prompt past the
    # 4096-token window
    flashes += [flash_case(dt, bh=48, s=4500, d=128, window=4096)
                for dt in ("bf16", "f32")]
    # Whisper's cross-attention: S_k = 1500 encoder frames
    flashes += [flash_cross_case(dt, sq) for dt in ("bf16", "f32")
                for sq in (64, 448)]
    # Whisper-small training's three attentions at its batch (BH 8 x 12
    # heads, no key-range split): the encoder's 1500 frames
    # (bidirectional), the decoder's 448 tokens (causal) and the cross
    # attention (448 queries over 1500 frames); each must fail the limits
    # when the kernel is told S_k - 1 keys
    wcfg = get_arch("whisper_small")
    wbh, frames = ENCDEC_BATCH * wcfg.n_heads, wcfg.encoder_seq
    for dt in ("bf16", "f32"):
        flashes += [flash_case(dt, bh=wbh, s=frames, causal=False,
                               drop_key_fault=True),
                    flash_case(dt, bh=wbh, s=ENCDEC_SEQ, drop_key_fault=True),
                    flash_cross_case(dt, ENCDEC_SEQ, sk=frames, bh=wbh)]
    for v in flashes:
        log(f"kernel flash_attention {v['dtype']} bh={v['bh']} s={v['s']} "
            f"sk={v.get('sk', v['s'])} "
            f"d={v['d']} causal={v['causal']} window={v['window']}: "
            f"max_abs_err={v['max_abs_err']:.3e} row_steps={v['row_steps']} "
            f"planted_fault({v['fault']})="
            f"{v['planted_fault']} {times_text(v)} "
            f"({v.get('library', 'SDPA')}) "
            f"bound_ms={v['bound_ms']:.4f} ({v['bound_by']}) "
            f"splits={v['splits']}")
    # the matmul: the self-test's 128^3 (f32, as BIST runs it), the JAX
    # test shapes, a ragged shape, qwen2-0.5B's MLP up projection of a
    # 4096-token prefill
    mms = [matmul_case(i, o, *shape)
           for shape in ((128, 128, 128), (256, 512, 256), (512, 1024, 128))
           for i, o in (("f32", "f32"), ("bf16", "f32"))]
    mms += [matmul_case(i, i, 200, 300, 136) for i in ("f32", "bf16")]
    mms += [matmul_case("bf16", o, 4096, 896, 4864) for o in ("f32", "bf16")]
    for v in mms:
        log(f"kernel matmul {v['in']}->{v['out']} M={v['m']} K={v['k']} "
            f"N={v['n']}: max_abs_err={v['max_abs_err']:.3e} (tol "
            f"{v['tol']:.3e}, max |out| {v['max_abs_out']:.3e}) "
            f"planted_fault(last K tile skipped)={v['planted_fault']:.3e} "
            f"{times_text(v)} (torch.matmul) "
            f"bound_ms={v['bound_ms']:.5f} ({v['bound_by']})")
    denses = [dense_case(label, dt, h, kv, d, w, pos, window)
              for label, h, kv, d, w, pos, window in DENSE_CASES
              for dt in ("bf16", "f32")]
    for v in denses:
        log(f"kernel decode_attention {v['label']} {v['dtype']} b={v['b']} "
            f"h={v['h']}/{v['kv']} d={v['d']} W={v['w']} pos={v['pos']} "
            f"window={v['window']}: max_abs_err={v['max_abs_err']:.3e} "
            f"reading={v['reading']:.3e} (limit {v['limit']}) "
            f"planted_fault(pos-1)={v['planted_fault']:.3e} splits="
            f"{v['splits']} {times_text(v)} (SDPA) "
            f"bound_ms={v['bound_ms']:.5f} ({v['bound_by']})")
    wkvs = [wkv_case(*case) for case in WKV_CASES]
    for v in wkvs:
        log(f"kernel rwkv_wkv {v['label']} b={v['b']} s={v['s']} h={v['h']} "
            f"hd={v['hd']} chunk={v['chunk']} s0={v['s0']} "
            f"in_place={v['in_place']}: plan {v['body']} G={v['group']} "
            f"groups={v['n_groups']} "
            f"blocks={v['blocks']}: "
            f"max_abs_err={v['max_abs_err']:.3e} (limit {v['limit']:.3e}) "
            f"planted_fault(no bonus)={v['planted_fault']:.3e} "
            f"planted_fault(one group behind)={v['stale_fault']:.3e} "
            f"{times_text(v)} (no PyTorch call computes the recurrence) "
            f"bound_ms={v['bound_ms']:.5f} ({v['bound_by']})")
    for sweep in WKV_SWEEPS:
        wkv_sweep(*sweep)
    gathers = [gather_case(label, dt, v_, d_, n_, bag, kind)
               for label, v_, d_, n_, bag, kind in GATHER_CASES
               for dt in ("f32", "bf16")]
    for v in gathers:
        log(f"kernel sparse_gather_sum {v['label']} {v['dtype']} V={v['v']} "
            f"D={v['d']} N={v['n']} bag={v['bag']} unique_rows="
            f"{v['unique_rows']}: max_abs_err={v['max_abs_err']:.3e} "
            f"reading={v['reading']:.3e} (limit {v['limit']}) "
            f"planted_fault(last position dropped)={v['planted_fault']:.3e} "
            f"{times_text(v)} (F.embedding_bag, max_abs_err"
            f" {v['library_max_abs_err']:.3e}) bound_ms={v['bound_ms']:.5f} "
            f"({v['bound_by']})")
    log(f"kernels phase done at {time.perf_counter() - t_start:.1f}s")

    # 4-5. the serving paths, each with the counts read around its runs
    counts = {"qwen2_0_5b": serve_qwen(mods)}
    log(f"qwen phase done at {time.perf_counter() - t_start:.1f}s")
    (counts[f"mixtral_8x22b_{MIXTRAL_LAYERS}l"],
     counts[f"mixtral_8x22b_{MIXTRAL_LAYERS}l_ring"]) = serve_mixtral(mods)
    log(f"mixtral phase done at {time.perf_counter() - t_start:.1f}s")
    counts["phi4_mini_3_8b_dense"] = serve_dense(mods)
    log(f"dense phase done at {time.perf_counter() - t_start:.1f}s")
    counts["rwkv6_1_6b"], counts[f"jamba_v01_52b_{JAMBA_LAYERS}l"] = \
        serve_state(mods)
    log(f"state phase done at {time.perf_counter() - t_start:.1f}s")
    counts["dlrm"] = train_dlrm(mods)
    log(f"dlrm phase done at {time.perf_counter() - t_start:.1f}s")
    counts["whisper_small"], counts["qwen2_vl_7b"] = serve_encdec(mods)
    log(f"enc-dec and M-RoPE phase done at "
        f"{time.perf_counter() - t_start:.1f}s")
    counts["qwen2_0_5b_bist"], counts["qwen2_0_5b_chaos"] = \
        serve_resilient(mods)
    log(f"resilient serve phase done at {time.perf_counter() - t_start:.1f}s")
    counts["qwen2_0_5b_disagg"] = serve_disagg(mods)
    counts.update(serve_mesh(mods))
    log(f"multi-device phase done at {time.perf_counter() - t_start:.1f}s")
    counts["qwen2_0_5b_train"], train_trace = train_qwen(mods)
    log(f"train phase done at {time.perf_counter() - t_start:.1f}s")
    state_paths, wkv_grads = train_state(mods)
    counts.update(state_paths)
    log(f"train_state phase done at {time.perf_counter() - t_start:.1f}s")
    counts.update(train_encdec(mods))
    log(f"train_encdec phase done at {time.perf_counter() - t_start:.1f}s")
    counts.update(fleet_phase(mods, train_trace))
    log(f"fleet phase done at {time.perf_counter() - t_start:.1f}s")
    serve_path = counts[f"mixtral_8x22b_{MIXTRAL_LAYERS}l"]

    # one line for every kernel: launches on the path that runs it (matmul:
    # the startup self-test; flash: the bf16 training run; paged and
    # grouped: the Mixtral bf16 serve; dense decode: the phi4 dense serve;
    # the WKV: the rwkv6 bf16 serve; its backward: the rwkv6 bf16 train),
    # a representative at that path's shapes (matmul: f32 128^3; flash:
    # bf16 causal at the training shape; paged: bf16 pages at Mixtral's
    # shapes, decode and the span at T=128; grouped: bf16, a 4-token decode
    # step's up projection; dense decode: bf16 at phi4's serving shape;
    # the WKV: rwkv6's 1024-token bucketed prefill; its backward: rwkv6's
    # training shape),
    # and every variant measured
    kernels = []
    for kname, replaces in KERNELS.items():
        main_path = serve_path
        if kname == "matmul":
            main_path = counts["qwen2_0_5b_bist"]
            mine = mms
            rep = mms[0]
            keys = ("in", "out", "m", "k", "n", "max_abs_err", "tol",
                    "planted_fault", "ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by")
        elif kname == "flash_attention":
            main_path = counts["qwen2_0_5b_train"]
            mine = flashes
            rep = flashes[0]
            keys = ("dtype", "bh", "s", "d", "causal", "window",
                    "max_abs_err", "row_steps", "planted_fault", "ms",
                    "plain_ms", "library_ms", "bound_ms", "bound_by")
        elif kname == "decode_attention":
            main_path = counts["phi4_mini_3_8b_dense"]
            mine = denses
            rep = [v for v in mine if v["label"] == "phi4_serve"
                   and v["dtype"] == "bf16"][0]
            keys = ("label", "dtype", "b", "h", "kv", "d", "w", "pos",
                    "window", "max_abs_err", "reading", "limit",
                    "planted_fault", "ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by")
        elif kname == "rwkv_wkv":
            main_path = counts["rwkv6_1_6b"]
            mine = wkvs
            rep = wkvs[0]
            keys = ("label", "b", "s", "h", "hd", "chunk", "s0",
                    "front_pad", "in_place", "body", "group", "n_groups",
                    "blocks", "max_abs_err", "limit",
                    "planted_fault", "stale_fault", "ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by")
        elif kname == "rwkv_wkv_backward":
            main_path = counts["rwkv6_1_6b_train"]
            mine = wkv_grads
            rep = wkv_grads[0]
            keys = ("label", "b", "s", "h", "hd", "chunk", "s0", "body",
                    "group", "n_groups", "errs", "max_abs_err", "limit",
                    "planted_fault", "kernels_device_ms", "scratch_bytes",
                    "ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by")
        elif kname == "sparse_gather_sum":
            main_path = counts["dlrm"]
            mine = gathers
            rep = [v for v in mine if v["label"] == "dlrm_item"
                   and v["dtype"] == "f32"][0]
            keys = ("label", "dtype", "v", "d", "n", "bag", "kind",
                    "unique_rows", "max_abs_err", "reading", "limit",
                    "planted_fault", "ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by")
        elif kname == "grouped_matmul":
            mine = gemms
            rep = [v for v in mine if v["x"] == "bf16" and v["w"] == "bf16"
                   and v["t"] == 4 and v["d"] == mix_d][0]
            keys = ("x", "w", "t", "m", "d", "f", "e", "experts", "body",
                    "splits", "forced", "max_abs_err", "tol",
                    "planted_fault", "ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by", "design_weight_bytes")
        else:
            mine = [v for v in variants if v["name"] == kname]
            rep = [v for v in mine if v["pages"] == "bf16" and v["h"] == 48
                   and v["t"] in (1, 128)][0]
            keys = ("pages", "t", "b", "h", "kv", "d", "window", "max_ctx",
                    "trimmed_pages", "source", "max_abs_err", "row_steps",
                    "planted_fault", "ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by", "stages", "bf16_steps",
                    "wmma_device_ms")
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": replaces, "launches": main_path[kname],
            "launches_by_path": {p: c.get(kname, 0)
                                 for p, c in counts.items()},
            "max_abs_err": max(v["max_abs_err"] for v in mine),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"],
            "device_ms": rep["device_ms"],
            "library_device_ms": rep["library_device_ms"],
            "variants": [{k: v.get(k) for k in keys + (
                "sk", "splits", "device_ms", "library_device_ms", "shard",
                "full_pool_err", "planted_fault_block", "ep",
                "tiles_minus_one", "ep_sum_err", "planted_fault_nonlocal")
                if k in v} for v in mine],
        })
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
