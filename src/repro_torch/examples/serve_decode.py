"""Batched serving over three model families (the port of
``examples/serve_decode.py``): dense GQA on the paged KV engine, the
sliding-window MoE on the paged engine with fp8 weights, and the
attention-free RWKV-6 on the dense-slot engine, each at smoke size
through the continuous-batching engine's chunked decode loop.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode
    PYTHONPATH=src python -m repro_torch.examples.serve_decode --device cpu

The reference's engine settings (window 48, 4 slots, chunks of 8), four
16-token prompts from ``numpy.random.default_rng(0)`` and 24 new tokens a
prompt at temperature 0.8. The reference samples with a JAX key; the port
samples with a ``torch.Generator`` seeded 7, a new one for each family, as
the reference makes its key anew. Weights are random, made from seed 0 on
the device. On the card the engines run the hand-written kernels: the
paged decode and span attention for qwen2.5-3B and Mixtral, the grouped
MoE GEMM for Mixtral, the WKV for rwkv6.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.registry import get_smoke
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import api
from repro_torch.models.blocks import ModelContext
from repro_torch.models.params import init_params
from repro_torch.serve.engine import ServeEngine, quantize_weights

# (arch, weight storage dtype or None)
FAMILIES = (("qwen2_5_3b", None),
            ("mixtral_8x22b", torch.float8_e4m3fn),
            ("rwkv6_1_6b", None))
WINDOW, MAX_BATCH, CHUNK = 48, 4, 8
PROMPTS, PROMPT_LEN, MAX_NEW = 4, 16, 24
TEMPERATURE = 0.8
SAMPLE_SEED = 7


def make_engine(arch: str, device: DeviceLike = None) -> ServeEngine:
    """The reference example's engine for ``arch`` (its f32 context)."""
    ctx = ModelContext(compute_dtype=torch.float32, q_chunk=512,
                       mamba_chunk=16, rwkv_chunk=8, device=device)
    return ServeEngine(get_smoke(arch), ctx, window=WINDOW,
                       max_batch=MAX_BATCH, chunk=CHUNK)


def serve(engine: ServeEngine, params: Any, quant: Optional[torch.dtype],
          prompts: np.ndarray, temperature: float
          ) -> Tuple[torch.Tensor, float]:
    """Generate ``MAX_NEW`` tokens for each prompt row from ``params``,
    cast to ``quant`` first when it is given, sampling with a generator
    seeded ``SAMPLE_SEED``. Returns (tokens (B, MAX_NEW) on the CPU,
    seconds)."""
    if quant is not None:
        params = quantize_weights(params, quant)
    gen = torch.Generator(device=engine.device)
    gen.manual_seed(SAMPLE_SEED)
    t0 = time.perf_counter()
    out = engine.generate(params, {"tokens": prompts}, max_new=MAX_NEW,
                          temperature=temperature, generator=gen)
    return out, time.perf_counter() - t0


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' on request)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    lines = []
    for arch, quant in FAMILIES:
        engine = make_engine(arch, dev)
        prompts = rng.integers(0, engine.cfg.vocab_size,
                               (PROMPTS, PROMPT_LEN)).astype(np.int32)
        params = init_params(api.model_specs(engine.cfg), 0, device=dev)
        out, dt = serve(engine, params, quant, prompts, TEMPERATURE)
        q = "fp8 weights" if quant is not None else "fp32 weights"
        mode = "paged" if engine.paged else "dense"
        n = PROMPTS * MAX_NEW
        lines.append(
            f"{arch:18s} [{q:12s}|{mode:5s}] {PROMPTS}x{MAX_NEW} tokens in "
            f"{dt:5.1f}s ({n / dt:6.1f} tok/s, "
            f"{engine.counters['host_syncs']} host syncs) "
            f"sample={out[0].numpy()[:6]}")
        print(lines[-1])
    return lines


if __name__ == "__main__":
    main()
