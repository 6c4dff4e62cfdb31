"""Decoder-only LM: specs and paged serving (``repro.models.lm``).

A Python loop over the stacked layer axis replaces the reference's
``lax.scan``; each iteration takes views of one layer's parameters and
page pools.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.blocks import (ModelContext, TensorSpec,
                                       block_decode_paged,
                                       block_decode_span_paged, block_specs,
                                       paged_block_cache_spec, stack_specs)
from repro_torch.models.config import ModelConfig
from repro_torch.models.ops import embed_lookup, rms_norm
from repro_torch.models.params import ParamSpec, ones_init, tree_index

Tensor = torch.Tensor


def lm_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.vocab_size
    specs: Dict[str, Any] = {
        "embed": ParamSpec((v, d), ("vocab", "embed")),
        "blocks": stack_specs(block_specs(cfg), cfg.n_blocks),
        "final_norm": ParamSpec((d,), ("embed",), init=ones_init()),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, v), ("embed", "vocab"))
    return specs


def _logits(params: Dict[str, Any], x: Tensor, cfg: ModelConfig,
            ctx: ModelContext) -> Tensor:
    if cfg.tie_embeddings:
        head = params["embed"].to(ctx.compute_dtype).T
    else:
        head = params["lm_head"].to(ctx.compute_dtype)
    return x @ head


def _span_logits_slice(x: Tensor, logits_at: Optional[Tensor]) -> Tensor:
    """Prefill chunks need ONE position's logits: gather it before the lm
    head so the vocab projection is (B,1,V), not (B,T,V)."""
    if logits_at is None:
        return x
    bidx = torch.arange(x.shape[0], device=x.device)
    return x[bidx, logits_at.long()][:, None]


def lm_paged_state_spec(cfg: ModelConfig, num_pages: int, page_size: int,
                        max_batch: int, max_pages_per_seq: int,
                        ctx: ModelContext) -> Dict[str, Any]:
    per_block = paged_block_cache_spec(cfg, num_pages, page_size, ctx)
    stacked = {sl: {name: TensorSpec((cfg.n_blocks, *s.shape), s.dtype)
                    for name, s in sub.items()}
               for sl, sub in per_block.items()}
    return {
        "pages": stacked,
        "page_table": TensorSpec((max_batch, max_pages_per_seq),
                                 torch.int32),
        "pos": TensorSpec((max_batch,), torch.int32),
    }


def lm_decode_step_paged(params: Dict[str, Any], token: Tensor,
                         state: Dict[str, Any], cfg: ModelConfig,
                         ctx: ModelContext) -> Tuple[Tensor, Dict[str, Any]]:
    """token: (B, 1) against the paged pool. Returns (logits (B,1,V),
    state with pos advanced); the pool is updated in place."""
    pos, table = state["pos"], state["page_table"]
    x = embed_lookup(params["embed"], token, ctx.compute_dtype)
    for layer in range(cfg.n_blocks):
        x, _ = block_decode_paged(
            tree_index(params["blocks"], layer), x,
            tree_index(state["pages"], layer), table, pos, cfg, ctx)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, x, cfg, ctx)
    return logits, {"pages": state["pages"], "page_table": table,
                    "pos": pos + 1}


def lm_decode_span_paged(params: Dict[str, Any], tokens: Tensor,
                         state: Dict[str, Any], cfg: ModelConfig,
                         ctx: ModelContext, valid: Optional[Tensor] = None,
                         logits_at: Optional[Tensor] = None
                         ) -> Tuple[Tensor, Dict[str, Any]]:
    """T-token span decode (speculative verify / suffix prefill / chunked
    cold prefill). tokens (B,T) at positions ``pos .. pos+T-1``; ``valid``
    (B,) real tokens per row (default T), padded tail slots write to the
    trash page; ``logits_at`` (B,) returns only that position's logits.
    ``pos`` in the returned state is unchanged: acceptance and rollback
    are the caller's."""
    pos, table = state["pos"], state["page_table"]
    b, t = tokens.shape
    if valid is None:
        valid = torch.full((b,), t, dtype=torch.int32, device=tokens.device)
    live = torch.arange(t, device=tokens.device)[None, :] < valid[:, None]
    x = embed_lookup(params["embed"], tokens, ctx.compute_dtype)
    for layer in range(cfg.n_blocks):
        x, _ = block_decode_span_paged(
            tree_index(params["blocks"], layer), x,
            tree_index(state["pages"], layer), table, pos, live, cfg, ctx)
    x = _span_logits_slice(x, logits_at)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, x, cfg, ctx)
    return logits, {"pages": state["pages"], "page_table": table,
                    "pos": pos}
