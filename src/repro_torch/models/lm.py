"""Decoder-only LM: specs, train loss, and serving on dense caches (every
family: attention, Mamba, RWKV) and on the paged pool
(``repro.models.lm``).

A Python loop over the stacked layer axis replaces the reference's
``lax.scan``; each iteration takes views of one layer's parameters and
caches (or page pools), which the serving paths update in place. The training loss wraps each block in
``torch.utils.checkpoint`` where the reference wraps the scan body in
``jax.checkpoint``: a block's activations are recomputed in the backward
pass instead of kept.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.blocks import (ModelContext, TensorSpec,
                                       block_cache_spec, block_decode,
                                       block_decode_paged,
                                       block_decode_span,
                                       block_decode_span_paged,
                                       block_forward, block_prefill,
                                       block_specs, init_cache,
                                       paged_block_cache_spec, stack_specs)
from repro_torch.models.config import ModelConfig
from repro_torch.models.ops import (embed_lookup, rms_norm,
                                    softmax_cross_entropy)
from repro_torch.models.params import (ParamSpec, ones_init, tree_index,
                                       unstack)

Tensor = torch.Tensor

AUX_WEIGHTS = {"load_balance": 0.01, "router_z": 0.001}


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


def _embed(params: Dict[str, Any], tokens: Tensor, cfg: ModelConfig,
           ctx: ModelContext) -> Tensor:
    """Token embeddings. With the vocab split over "model" (``ctx.plan``)
    each rank looks up the ids in its block of rows, zeroes the others
    and the rows are summed over "model": every row comes from exactly
    one rank, so the sum is exact. Negative ids wrap and out-of-range ids
    give NaN rows, as ``embed_lookup``."""
    plan = ctx.plan
    if plan is None or not plan.vocab:
        return embed_lookup(params["embed"], tokens, ctx.compute_dtype)
    v = cfg.vocab_size
    idx = torch.where(tokens < 0, tokens + v, tokens)
    ok = (idx >= 0) & (idx < v)
    local = idx - plan.vocab_start
    mine = (local >= 0) & (local < plan.vocab_local)
    rows = params["embed"][local.clamp(0, plan.vocab_local - 1)].to(
        ctx.compute_dtype)
    rows = plan.reduce(torch.where(mine[..., None], rows, 0.0),
                       ctx.model_axis)
    return torch.where(ok[..., None], rows,
                       torch.full((), float("nan"), dtype=rows.dtype,
                                  device=rows.device))


def _logits(params: Dict[str, Any], x: Tensor, cfg: ModelConfig,
            ctx: ModelContext) -> Tensor:
    """The lm head (tied or separate). With the vocab split over "model"
    each rank computes its block of the logits, gathered in vocab order
    before the pick."""
    if cfg.tie_embeddings:
        head = params["embed"].to(ctx.compute_dtype).T
    else:
        head = params["lm_head"].to(ctx.compute_dtype)
    logits = x @ head
    if ctx.plan is not None and ctx.plan.vocab:
        logits = ctx.plan.gather(logits, ctx.model_axis, dim=-1)
    return logits


def _block_body(bp: Dict[str, Any], x: Tensor, cfg: ModelConfig,
                ctx: ModelContext, mrope_positions: Optional[Tensor]
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
    x, aux = block_forward(bp, x, cfg, ctx, mrope_positions)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, {k: aux[k].float() if k in aux else zero for k in AUX_WEIGHTS}


def lm_loss(params: Dict[str, Any], batch: Dict[str, Tensor],
            cfg: ModelConfig, ctx: ModelContext
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Token-mean next-token cross entropy plus the weighted MoE aux
    losses (each the mean over layers; 0 for dense layers). Returns
    (loss, metrics) with metrics xent, tokens, load_balance, router_z,
    loss. ``batch["positions"]`` (3,B,S), when present, are explicit
    M-RoPE rows (None: text rows)."""
    mrope = batch.get("positions")
    x = embed_lookup(params["embed"], batch["tokens"], ctx.compute_dtype)
    auxs: Dict[str, List[Tensor]] = {k: [] for k in AUX_WEIGHTS}
    for bp in unstack(params["blocks"], cfg.n_blocks):
        x, aux = checkpoint(_block_body, bp, x, cfg, ctx, mrope,
                            use_reentrant=False, preserve_rng_state=False)
        for k in AUX_WEIGHTS:
            auxs[k].append(aux[k])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, x, cfg, ctx)
    loss, count = softmax_cross_entropy(logits, batch["labels"],
                                        batch.get("loss_mask"))
    metrics = {"xent": loss, "tokens": count}
    total = loss
    for key, w in AUX_WEIGHTS.items():
        val = torch.stack(auxs[key]).mean()
        metrics[key] = val
        total = total + w * val
    metrics["loss"] = total
    return total, metrics


def _span_logits_slice(x: Tensor, logits_at: Optional[Tensor]) -> Tensor:
    """Prefill chunks need ONE position's logits: gather it before the lm
    head so the vocab projection is (B,1,V), not (B,T,V)."""
    if logits_at is None:
        return x
    bidx = torch.arange(x.shape[0], device=x.device)
    return x[bidx, logits_at.long()][:, None]


def _stack_spec(per_block: Dict[str, Any], n: int) -> Dict[str, Any]:
    return {sl: {name: TensorSpec((n, *s.shape), s.dtype)
                 for name, s in sub.items()}
            for sl, sub in per_block.items()}


def lm_cache_spec(cfg: ModelConfig, batch: int, window: int,
                  ctx: ModelContext) -> Dict[str, Any]:
    """Dense per-slot caches, stacked over layers, and positions."""
    blocks = block_cache_spec(cfg, batch, window, ctx)
    return {"blocks": _stack_spec(blocks, cfg.n_blocks),
            "pos": TensorSpec((batch,), torch.int32)}


def lm_prefill(params: Dict[str, Any], tokens: Tensor, cfg: ModelConfig,
               ctx: ModelContext, window: int,
               logits_at: Optional[Tensor] = None,
               pad_left: Optional[Tensor] = None,
               mrope_positions: Optional[Tensor] = None
               ) -> Tuple[Tensor, Dict[str, Any]]:
    """Full-sequence prefill into fresh dense caches. Returns (logits
    (B,1,V) of the last position, or of ``logits_at`` (B,), and the cache
    with ``pos`` = that position + 1).

    ``pad_left`` (B,) declares the first N positions of each row padding,
    for state-family (Mamba/RWKV) stacks: their embeddings are zeroed and
    the recurrent state stays exactly at zero through the pad prefix, so a
    server can pad prompts from the front to a bucketed length. Attention
    sublayers refuse it (front padding would shift their positions).
    ``mrope_positions`` (3,B,S): explicit multimodal rope rows (None:
    text rows, broadcast from the absolute positions)."""
    b, s = tokens.shape
    x = _embed(params, tokens, cfg, ctx)
    live = None
    if pad_left is not None:
        live = (torch.arange(s, device=x.device)[None, :]
                >= pad_left.to(x.device)[:, None])  # (B, S)
        x = x * live[..., None].to(x.dtype)
    spec = lm_cache_spec(cfg, b, window, ctx)
    caches = init_cache(spec["blocks"], x.device)
    for layer in range(cfg.n_blocks):
        x, _ = block_prefill(tree_index(params["blocks"], layer), x,
                             tree_index(caches, layer), cfg, ctx,
                             seq_mask=live, mrope_positions=mrope_positions)
    if logits_at is None:
        x = x[:, -1:]
        pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    else:
        x = _span_logits_slice(x, logits_at)
        pos = logits_at.to(torch.int32) + 1
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg, ctx), {"blocks": caches, "pos": pos}


def lm_decode_step(params: Dict[str, Any], token: Tensor,
                   cache: Dict[str, Any], cfg: ModelConfig,
                   ctx: ModelContext) -> Tuple[Tensor, Dict[str, Any]]:
    """token: (B, 1) against dense caches. Returns (logits (B,1,V), cache
    with pos advanced); the caches are updated in place."""
    pos = cache["pos"]
    x = _embed(params, token, cfg, ctx)
    for layer in range(cfg.n_blocks):
        x, _ = block_decode(tree_index(params["blocks"], layer), x,
                            tree_index(cache["blocks"], layer), pos, cfg,
                            ctx)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg, ctx), {"blocks": cache["blocks"],
                                          "pos": pos + 1}


def lm_decode_span(params: Dict[str, Any], tokens: Tensor,
                   cache: Dict[str, Any], cfg: ModelConfig,
                   ctx: ModelContext, logits_at: Optional[Tensor] = None,
                   mrope_positions: Optional[Tensor] = None
                   ) -> Tuple[Tensor, Dict[str, Any]]:
    """T-token span decode against dense caches that hold absolute slots
    (the chunked-prefill datapath of the dense backend). tokens (B,T) at
    positions ``pos .. pos+T-1``; ``pos`` may be negative: positions < 0
    are the dead front padding of a right-aligned first chunk (embeddings
    zeroed, writes dropped, residual stream exactly 0 there).
    ``logits_at`` (B,) returns only that position's logits;
    ``mrope_positions`` (3,B,T) are explicit multimodal rope rows for the
    span. ``pos`` in the returned cache is unchanged."""
    pos = cache["pos"]
    b, t = tokens.shape
    posn = pos[:, None] + torch.arange(t, device=tokens.device,
                                       dtype=pos.dtype)[None, :]
    live = posn >= 0
    x = _embed(params, tokens, cfg, ctx)
    x = x * live[..., None].to(x.dtype)
    for layer in range(cfg.n_blocks):
        x, _ = block_decode_span(tree_index(params["blocks"], layer), x,
                                 tree_index(cache["blocks"], layer), pos,
                                 live, cfg, ctx, mrope_positions)
    x = _span_logits_slice(x, logits_at)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg, ctx), {"blocks": cache["blocks"],
                                          "pos": pos}


def lm_paged_state_spec(cfg: ModelConfig, num_pages: int, page_size: int,
                        max_batch: int, max_pages_per_seq: int,
                        ctx: ModelContext) -> Dict[str, Any]:
    per_block = paged_block_cache_spec(cfg, num_pages, page_size, ctx)
    return {
        "pages": _stack_spec(per_block, cfg.n_blocks),
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
    x = _embed(params, token, cfg, ctx)
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
                         logits_at: Optional[Tensor] = None,
                         mrope_positions: Optional[Tensor] = None
                         ) -> Tuple[Tensor, Dict[str, Any]]:
    """T-token span decode (speculative verify / suffix prefill / chunked
    cold prefill). tokens (B,T) at positions ``pos .. pos+T-1``; ``valid``
    (B,) real tokens per row (default T), padded tail slots write to the
    trash page; ``logits_at`` (B,) returns only that position's logits;
    ``mrope_positions`` (3,B,T) are explicit multimodal rope rows for the
    span. ``pos`` in the returned state is unchanged: acceptance and
    rollback are the caller's."""
    pos, table = state["pos"], state["page_table"]
    b, t = tokens.shape
    if valid is None:
        valid = torch.full((b,), t, dtype=torch.int32, device=tokens.device)
    live = torch.arange(t, device=tokens.device)[None, :] < valid[:, None]
    x = _embed(params, tokens, cfg, ctx)
    for layer in range(cfg.n_blocks):
        x, _ = block_decode_span_paged(
            tree_index(params["blocks"], layer), x,
            tree_index(state["pages"], layer), table, pos, live, cfg, ctx,
            mrope_positions)
    x = _span_logits_slice(x, logits_at)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, x, cfg, ctx)
    return logits, {"pages": state["pages"], "page_table": table,
                    "pos": pos}
