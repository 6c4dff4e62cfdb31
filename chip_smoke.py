#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

  1. device  - needs CUDA; prints the card's name and power limit;
  2. build   - compiles every CUDA source of the port with nvcc, in parallel;
  3. kernels - each kernel x {f32, bf16, int8} pages against its plain
               torch version on the card at the shapes of the serving path
               (H=14, KV=2, D=64, P=16, B=8, contexts up to 2048, spans of
               3 and 128 tokens, and a D=128 windowed case), with its time,
               the plain version's, SDPA's on the gathered view (a
               yardstick the port never calls) and the least time the card
               could take;
  4. serve   - full-width qwen2-0.5B from seeded random weights through
               ServeEngine.run: bf16 pages, then draft_k=2, then an int8
               pool, each with its launch counters read just before and
               after; then a short f32 run (TF32 off) whose greedy tokens
               through the kernels must equal the gather path's.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, no sparsity
TOL = {"f32": 1e-4, "bf16": 2e-2, "int8": 2e-2}
KERNELS = {
    "paged_decode_attention": "src/repro/kernels/decode_attention.py:330",
    "paged_decode_span_attention":
        "src/repro/kernels/decode_attention.py:276",
}
SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


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


# ----------------------------------------------------------------- kernels


def kernel_case(kern, name: str, pages: str, *, t: int, d: int = 64,
                window=None, b: int = 8, h: int = 14, kv: int = 2,
                p: int = 16, max_ctx: int = 2048, seed: int = 0):
    """One kernel variant at serving shapes: returns its report dict."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.models.blocks import paged_quantize

    dev = torch.device("cuda")
    dtype = torch.float32 if pages == "f32" else torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    m = max_ctx // p + 1
    n = 1 + b * m
    ctx = torch.linspace(max_ctx // 8, max_ctx, b, device=dev).round().int()
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
    table[torch.arange(m, device=dev)[None, :] >= used[:, None]] = 0
    pos = pos.int().contiguous()
    if name == "paged_decode_attention":
        qk = q[:, 0]
        run = lambda: kern.paged_decode_attention(
            qk, k, v, table, pos, k_scale=ks, v_scale=vs, window=window)
        plain = lambda: kern.paged_decode_attention_plain(
            qk, k, v, table, pos, k_scale=ks, v_scale=vs, window=window)
        qpos = pos[:, None].long() - 1  # (B, 1) the query's position
    else:
        run = lambda: kern.paged_decode_span_attention(
            q, k, v, table, pos, k_scale=ks, v_scale=vs, window=window)
        plain = lambda: kern.paged_decode_span_attention_plain(
            q, k, v, table, pos, k_scale=ks, v_scale=vs, window=window)
        qpos = pos[:, None].long() + torch.arange(t, device=dev)[None, :]
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not bool(torch.isfinite(got.float()).all()) or err > TOL[pages]:
        raise AssertionError(f"{name} {pages} t={t} d={d} window={window}:"
                             f" max_abs_err {err} > {TOL[pages]}")

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

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    ms = timed_ms(run, flush)
    plain_ms = timed_ms(plain, flush)
    library_ms = timed_ms(library, flush)

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
        "name": name, "pages": pages, "t": t, "d": d, "window": window,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }


# ------------------------------------------------------------------- serve


def serve_requests(vocab: int, seed: int, n: int = 8):
    """8 prompts of 100-600 tokens; the first half share a 256-token
    prefix (a system prompt), so the prefix cache has work."""
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
        reqs.append(Request(rid=rid, prompt=prompt, max_new=32))
    return reqs


def serve_run(label, kern, engine, params, reqs, vocab, need):
    """One run of the main path with the launch counters read around it."""
    import torch
    kern.reset_launches()
    t0 = time.perf_counter()
    out = engine.run(params, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kern.launches)
    toks = sum(len(v) for v in out.values())
    for r in reqs:
        got = out[r.rid]
        if len(got) != r.max_new or got.min() < 0 or got.max() >= vocab:
            raise AssertionError(f"{label}: request {r.rid} gave {got}")
    for name in need:
        if counts[name] == 0:
            raise AssertionError(f"{label}: {name} never launched")
    log(f"serve[{label}]: {len(reqs)} requests {toks} tokens "
        f"{wall:.3f}s {toks / wall:.1f} tok/s "
        f"host_syncs={engine.counters['host_syncs']} "
        f"chunks={engine.counters['chunks']} "
        f"prefix_hit_rate={engine.prefix_hit_rate:.3f} "
        f"acceptance_length={engine.acceptance_length:.2f} "
        f"launches={counts}")
    return out, counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as kern
    from repro_torch.models import api
    from repro_torch.models.blocks import ModelContext
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import ServeEngine

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

    # 2. build
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f}s "
        f"{[str(p.relative_to(ROOT)) for p in libs.values()]}")
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

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
                                t=128, d=128, window=500))
    for v in variants:
        log(f"kernel {v['name']} pages={v['pages']} t={v['t']} d={v['d']} "
            f"window={v['window']}: max_abs_err={v['max_abs_err']:.3e} "
            f"ms={v['ms']:.4f} plain_ms={v['plain_ms']:.4f} "
            f"library_ms={v['library_ms']:.4f} bound_ms={v['bound_ms']:.4f}"
            f" ({v['bound_by']})")

    # 4. serve full-width qwen2-0.5B through both kernels
    cfg = get_arch("qwen2_0_5b")
    params = init_params(api.model_specs(cfg), seed=0,
                         dtype=torch.bfloat16, device="cuda")
    reqs = lambda: serve_requests(cfg.vocab_size, seed=0)
    window = 640  # longest prompt (600) + max_new (32), page-aligned
    both = tuple(KERNELS)
    runs = {}
    for label, cache, draft_k, need in (
            ("bf16", None, 0, both),
            # greedy speculation verifies every step through the span
            # kernel; the one-token decode kernel is not on that path
            ("bf16_draft_k2", None, 2, ("paged_decode_span_attention",)),
            ("int8", torch.int8, 0, both)):
        ctx = ModelContext(compute_dtype=torch.bfloat16,
                           decode_cache_dtype=cache, device="cuda")
        engine = ServeEngine(cfg, ctx, window=window, max_batch=4, chunk=8,
                             page_size=16, draft_k=draft_k)
        runs[label] = serve_run(label, kern, engine, params, reqs(),
                                cfg.vocab_size, need)
    main_launches = runs["bf16"][1]
    del params
    torch.cuda.empty_cache()

    # f32 (TF32 off): greedy tokens through the kernels == gather path
    params = init_params(api.model_specs(cfg), seed=1, device="cuda")
    short = serve_requests(cfg.vocab_size, seed=1, n=4)
    for r in short:
        r.prompt = r.prompt[:160]
        r.max_new = 16
    outs = {}
    for impl in ("cuda", "ref"):
        ctx = ModelContext(compute_dtype=torch.float32, attn_impl=impl,
                           device="cuda")
        engine = ServeEngine(cfg, ctx, window=176, max_batch=4, chunk=8,
                             page_size=16)
        outs[impl], _ = serve_run(
            f"f32_{impl}", kern, engine, params, [
                type(r)(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
                for r in short], cfg.vocab_size,
            both if impl == "cuda" else ())
    for rid in outs["cuda"]:
        if not (outs["cuda"][rid] == outs["ref"][rid]).all():
            raise AssertionError(f"f32 request {rid}: cuda tokens "
                                 f"{outs['cuda'][rid]} != ref "
                                 f"{outs['ref'][rid]}")
    log("serve[f32]: greedy tokens through the kernels equal the gather "
        "path's")

    # 5. one line for every kernel: main-path representative (bf16 pages;
    #    decode at B=8, the span at T=128) plus every variant measured
    kernels = []
    for kname, replaces in KERNELS.items():
        mine = [v for v in variants if v["name"] == kname]
        rep = [v for v in mine if v["pages"] == "bf16" and v["d"] == 64
               and v["t"] in (1, 128)][0]
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": main_launches[kname],
            "max_abs_err": max(v["max_abs_err"] for v in mine),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"],
            "variants": [{k: v[k] for k in (
                "pages", "t", "d", "window", "max_abs_err", "ms",
                "plain_ms", "library_ms", "bound_ms", "bound_by")}
                for v in mine],
        })
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
