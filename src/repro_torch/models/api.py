"""Family-agnostic model API of the port (``repro.models.api``): specs,
the training loss (decoder-only stacks, M-RoPE rows included, and the
encoder-decoder family), and serving on dense caches (prefill,
front-padded for state-family stacks, decode, span decode; the
encoder-decoder family's prefill and decode) and on the paged pool.
Encoder-decoder vs decoder-only dispatch happens here."""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.models import encdec, lm
from repro_torch.models.blocks import ModelContext
from repro_torch.models.config import ModelConfig


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.is_encoder_decoder:
        return encdec.encdec_specs(cfg)
    return lm.lm_specs(cfg)


def loss_fn(params, batch, cfg: ModelConfig, ctx: ModelContext):
    if cfg.is_encoder_decoder:
        return encdec.encdec_loss(params, batch, cfg, ctx)
    return lm.lm_loss(params, batch, cfg, ctx)


def cache_spec(cfg: ModelConfig, batch: int, window: int,
               ctx: ModelContext) -> Dict[str, Any]:
    if cfg.is_encoder_decoder:
        return encdec.encdec_cache_spec(cfg, batch, window, ctx)
    return lm.lm_cache_spec(cfg, batch, window, ctx)


def prefill_fn(params, batch, cfg: ModelConfig, ctx: ModelContext,
               window: int, logits_at=None, pad_left=None):
    """Full-prompt prefill into fresh dense caches. ``logits_at`` (B,):
    the position whose logits to return (default: the last; decoder-only).
    ``pad_left`` (B,): leading pad count of front-padded state-family
    prompts (see lm.lm_prefill). ``batch["positions"]`` (3,B,S): explicit
    mrope rows; ``batch["enc_feats"]``: an encoder-decoder's frames."""
    if cfg.is_encoder_decoder:
        if logits_at is not None or pad_left is not None:
            raise NotImplementedError(
                "logits_at/pad_left require a decoder-only model")
        return encdec.encdec_prefill(params, batch, cfg, ctx, window)
    return lm.lm_prefill(params, batch["tokens"], cfg, ctx, window,
                         logits_at=logits_at, pad_left=pad_left,
                         mrope_positions=batch.get("positions"))


def decode_fn(params, token, cache, cfg: ModelConfig, ctx: ModelContext):
    """One decode step against dense caches (updated in place)."""
    if cfg.is_encoder_decoder:
        return encdec.encdec_decode_step(params, token, cache, cfg, ctx)
    return lm.lm_decode_step(params, token, cache, cfg, ctx)


def decode_span_fn(params, tokens, cache, cfg: ModelConfig,
                   ctx: ModelContext, logits_at=None, mrope_positions=None):
    """T-token span decode against dense caches holding absolute slots;
    ``cache["pos"]`` may be negative (dead front padding, see
    lm.lm_decode_span). ``logits_at`` (B,) gathers one position's logits
    before the lm head; ``mrope_positions`` (3,B,T) are explicit mrope
    rows for the span (None: the text default)."""
    if cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name}: span decode requires decoder-only")
    return lm.lm_decode_span(params, tokens, cache, cfg, ctx,
                             logits_at=logits_at,
                             mrope_positions=mrope_positions)


def supports_paged_decode(cfg: ModelConfig) -> bool:
    """Paged KV applies to pure-attention decoder-only stacks."""
    return (not cfg.is_encoder_decoder
            and set(cfg.sublayer_kinds()) == {"attn"})


def _require_paged(cfg: ModelConfig) -> None:
    if not supports_paged_decode(cfg):
        raise ValueError(f"{cfg.name}: no paged decode for this family")


def paged_state_spec(cfg: ModelConfig, num_pages: int, page_size: int,
                     max_batch: int, max_pages_per_seq: int,
                     ctx: ModelContext) -> Dict[str, Any]:
    _require_paged(cfg)
    return lm.lm_paged_state_spec(cfg, num_pages, page_size, max_batch,
                                  max_pages_per_seq, ctx)


def decode_paged_fn(params, token, state, cfg: ModelConfig,
                    ctx: ModelContext):
    """One decode step against the paged KV pool (see blocks.py)."""
    _require_paged(cfg)
    return lm.lm_decode_step_paged(params, token, state, cfg, ctx)


def decode_span_paged_fn(params, tokens, state, cfg: ModelConfig,
                         ctx: ModelContext, valid=None, logits_at=None,
                         mrope_positions=None):
    """T-token span decode against the paged pool; ``mrope_positions``
    (3,B,T) are explicit mrope rows (None: the text default); ``pos`` in
    the returned state is unchanged (see lm.lm_decode_span_paged)."""
    _require_paged(cfg)
    return lm.lm_decode_span_paged(params, tokens, state, cfg, ctx,
                                   valid=valid, logits_at=logits_at,
                                   mrope_positions=mrope_positions)
