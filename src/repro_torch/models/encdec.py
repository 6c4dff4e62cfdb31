"""Encoder-decoder transformer (the Whisper backbone;
``repro.models.encdec``): the training loss and serving.

The audio frontend is a stub, as in the reference: requests bring
precomputed frame embeddings (B, encoder_seq, d_model), what Whisper's two
conv layers would produce. Encoder: bidirectional self-attention, GELU
MLP, LayerNorm, learned positions. Decoder: causal self-attention, cross
attention over the encoder states, GELU MLP.

A Python loop over the stacked layer axis replaces the reference's
``lax.scan``. The training loss wraps each encoder and decoder layer in
``torch.utils.checkpoint`` where the reference wraps the scan body in
``jax.checkpoint``; the encoder is one function for the loss and for
serving, checkpointed only for the loss. The decode cache holds the
self-attention ring (B, W, KV, D) and the cross-attention k/v (B,
encoder_seq, KV, D), fixed after prefill; decode updates the ring in
place. Under ``attn_impl="cuda"`` every
attention goes through a kernel: the flash kernel in the loss's forward
and in prefill (the encoder's bidirectional layers, the decoder's causal
ones and the cross attention, whose keys are the encoder's 1500 frames;
the loss's backward is the plain path's gradient, see
attention._FlashAttention), the dense decode kernel twice per layer and
step (the ring, then the cross k/v).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.models.attention import decode_attention, full_attention
from repro_torch.models.blocks import (ModelContext, TensorSpec,
                                       _project_qkv, attn_param_specs,
                                       init_cache, stack_specs)
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import dense_ffn, dense_ffn_specs
from repro_torch.models.ops import (embed_lookup, layer_norm,
                                    softmax_cross_entropy)
from repro_torch.models.params import (ParamSpec, normal_init, ones_init,
                                       tree_index, unstack, zeros_init)

Tensor = torch.Tensor

MAX_DEC_POSITIONS = 32768  # mechanical ceiling for the assigned shapes


def _ln_specs(d: int) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((d,), ("embed",), init=ones_init()),
            "bias": ParamSpec((d,), ("embed",), init=zeros_init())}


def _ln(p, x: Tensor, eps: float) -> Tensor:
    return layer_norm(x, p["scale"], p["bias"], eps)


def enc_layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln1": _ln_specs(cfg.d_model), "attn": attn_param_specs(cfg),
            "ln2": _ln_specs(cfg.d_model), "mlp": dense_ffn_specs(cfg)}


def dec_layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln1": _ln_specs(cfg.d_model), "attn": attn_param_specs(cfg),
            "lnx": _ln_specs(cfg.d_model), "xattn": attn_param_specs(cfg),
            "ln2": _ln_specs(cfg.d_model), "mlp": dense_ffn_specs(cfg)}


def encdec_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.vocab_size
    return {
        "embed": ParamSpec((v, d), ("vocab", "embed")),
        "enc_pos": ParamSpec((cfg.encoder_seq, d), (None, "embed"),
                             init=normal_init(0.01)),
        "dec_pos": ParamSpec((MAX_DEC_POSITIONS, d), (None, "embed"),
                             init=normal_init(0.01)),
        "enc_blocks": stack_specs(enc_layer_specs(cfg), cfg.encoder_layers),
        "dec_blocks": stack_specs(dec_layer_specs(cfg), cfg.n_layers),
        "enc_norm": _ln_specs(d),
        "final_norm": _ln_specs(d),
        "lm_head": ParamSpec((d, v), ("embed", "vocab")),
    }


def _out_proj(p, out: Tensor, dtype: torch.dtype) -> Tensor:
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dtype))


def _self_attn(p, x: Tensor, cfg: ModelConfig, ctx: ModelContext,
               attn_type: str) -> Tuple[Tensor, Tensor, Tensor]:
    """Self-attention of a layer: returns (output, k, v)."""
    dtype = ctx.compute_dtype
    q, k, v = _project_qkv(p, x, cfg, dtype)
    out = full_attention(q, k, v, cfg, q_chunk=ctx.q_chunk,
                         attn_type=attn_type, impl=ctx.attn_impl)
    return _out_proj(p, out, dtype), k, v


def _cross_q(p, x: Tensor, cfg: ModelConfig, dtype: torch.dtype) -> Tensor:
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dtype)
    return q


def _enc_kv(p, enc_out: Tensor, cfg: ModelConfig, ctx: ModelContext
            ) -> Tuple[Tensor, Tensor]:
    dtype = ctx.compute_dtype
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"].to(dtype))
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"].to(dtype))
    if cfg.qkv_bias:
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    return k, v


def _cross_attn(p, x: Tensor, enc_kv: Tuple[Tensor, Tensor],
                cfg: ModelConfig, ctx: ModelContext) -> Tensor:
    """Cross attention of the decoder states x over the encoder's k/v:
    bidirectional, S_k (the encoder's frames) != S_q."""
    dtype = ctx.compute_dtype
    k, v = enc_kv
    out = full_attention(_cross_q(p, x, cfg, dtype), k, v, cfg,
                         q_chunk=ctx.q_chunk, attn_type="bidirectional",
                         impl=ctx.attn_impl)
    return _out_proj(p, out, dtype)


def _remat(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward pass
    (the reference's ``jax.checkpoint`` around a scan body)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _enc_layer(lp, x: Tensor, cfg: ModelConfig, ctx: ModelContext
               ) -> Tensor:
    h = _ln(lp["ln1"], x, cfg.norm_eps)
    x = x + _self_attn(lp["attn"], h, cfg, ctx, "bidirectional")[0]
    h = _ln(lp["ln2"], x, cfg.norm_eps)
    return x + dense_ffn(lp["mlp"], h, cfg, ctx.compute_dtype)


def encode(params, enc_feats: Tensor, cfg: ModelConfig,
           ctx: ModelContext, remat: bool = False) -> Tensor:
    """enc_feats (B, encoder_seq, d_model) -> encoder states, normed.
    ``remat`` checkpoints each layer (the training loss)."""
    dtype = ctx.compute_dtype
    x = enc_feats.to(dtype) + params["enc_pos"].to(dtype)
    for lp in unstack(params["enc_blocks"], cfg.encoder_layers):
        x = (_remat(_enc_layer, lp, x, cfg, ctx) if remat
             else _enc_layer(lp, x, cfg, ctx))
    return _ln(params["enc_norm"], x, cfg.norm_eps)


def _dec_layer(lp, x: Tensor, enc_out: Tensor, cfg: ModelConfig,
               ctx: ModelContext) -> Tensor:
    """A decoder layer of the training loss: causal self attention, cross
    attention over the encoder states, the GELU MLP."""
    h = _ln(lp["ln1"], x, cfg.norm_eps)
    x = x + _self_attn(lp["attn"], h, cfg, ctx, "causal")[0]
    h = _ln(lp["lnx"], x, cfg.norm_eps)
    x = x + _cross_attn(lp["xattn"], h,
                        _enc_kv(lp["xattn"], enc_out, cfg, ctx), cfg, ctx)
    h = _ln(lp["ln2"], x, cfg.norm_eps)
    return x + dense_ffn(lp["mlp"], h, cfg, ctx.compute_dtype)


def encdec_loss(params, batch: Dict[str, Tensor], cfg: ModelConfig,
                ctx: ModelContext) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Token-mean next-token cross entropy of the decoder over
    ``batch["tokens"]`` (B, S), given the frames ``batch["enc_feats"]``.
    Returns (loss, metrics) with metrics xent, loss and tokens, as the
    reference."""
    tokens = batch["tokens"]
    dtype = ctx.compute_dtype
    enc_out = encode(params, batch["enc_feats"], cfg, ctx, remat=True)
    x = embed_lookup(params["embed"], tokens, dtype)
    x = x + params["dec_pos"][:tokens.shape[1]].to(dtype)
    for lp in unstack(params["dec_blocks"], cfg.n_layers):
        x = _remat(_dec_layer, lp, x, enc_out, cfg, ctx)
    x = _ln(params["final_norm"], x, cfg.norm_eps)
    logits = x @ params["lm_head"].to(dtype)
    loss, count = softmax_cross_entropy(logits, batch["labels"],
                                        batch.get("loss_mask"))
    return loss, {"xent": loss, "loss": loss, "tokens": count}


def encdec_cache_spec(cfg: ModelConfig, batch: int, window: int,
                      ctx: ModelContext) -> Dict[str, Any]:
    hd, kv, cdt = cfg.resolved_head_dim, cfg.n_kv_heads, ctx.cache_dtype
    ring = TensorSpec((cfg.n_layers, batch, window, kv, hd), cdt)
    cross = TensorSpec((cfg.n_layers, batch, cfg.encoder_seq, kv, hd), cdt)
    return {"blocks": {"k": ring, "v": ring, "xk": cross, "xv": cross},
            "pos": TensorSpec((batch,), torch.int32)}


def encdec_prefill(params, batch: Dict[str, Tensor], cfg: ModelConfig,
                   ctx: ModelContext, window: int
                   ) -> Tuple[Tensor, Dict[str, Any]]:
    """Encode ``batch["enc_feats"]``, prefill ``batch["tokens"]`` (B, S).
    Returns (logits (B,1,V) of the last position, the cache with pos S).
    The ring keeps the last min(W, S) positions in slots 0.., as the
    reference writes them."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    dtype, cdt = ctx.compute_dtype, ctx.cache_dtype
    enc_out = encode(params, batch["enc_feats"], cfg, ctx)
    x = embed_lookup(params["embed"], tokens, dtype)
    x = x + params["dec_pos"][:s].to(dtype)
    spec = encdec_cache_spec(cfg, b, window, ctx)
    cache = init_cache(spec["blocks"], x.device)
    take = min(window, s)
    for layer in range(cfg.n_layers):
        lp = tree_index(params["dec_blocks"], layer)
        lc = tree_index(cache, layer)
        h = _ln(lp["ln1"], x, cfg.norm_eps)
        out, k, v = _self_attn(lp["attn"], h, cfg, ctx, "causal")
        x = x + out
        h = _ln(lp["lnx"], x, cfg.norm_eps)
        xk, xv = _enc_kv(lp["xattn"], enc_out, cfg, ctx)
        x = x + _cross_attn(lp["xattn"], h, (xk, xv), cfg, ctx)
        h = _ln(lp["ln2"], x, cfg.norm_eps)
        x = x + dense_ffn(lp["mlp"], h, cfg, dtype)
        lc["k"][:, :take] = k[:, s - take:].to(cdt)
        lc["v"][:, :take] = v[:, s - take:].to(cdt)
        lc["xk"].copy_(xk)
        lc["xv"].copy_(xv)
    x = _ln(params["final_norm"], x[:, -1:], cfg.norm_eps)
    logits = x @ params["lm_head"].to(dtype)
    pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return logits, {"blocks": cache, "pos": pos}


def _decode_attn(q: Tensor, kc: Tensor, vc: Tensor, pos: Tensor,
                 cfg: ModelConfig, ctx: ModelContext, window) -> Tensor:
    """One-token attention of q (B,1,H,D) over a (B,W,KV,D) cache with
    ``pos`` valid positions: the dense kernel under ``attn_impl="cuda"``,
    the plain ring oracle otherwise."""
    if ctx.attn_impl == "cuda":
        return kops.decode_attention(q[:, 0].contiguous(), kc, vc, pos,
                                     impl="cuda", window=window)[:, None]
    return decode_attention(q, kc, vc, pos, cfg, window=window)


def encdec_decode_step(params, token: Tensor, cache: Dict[str, Any],
                       cfg: ModelConfig, ctx: ModelContext
                       ) -> Tuple[Tensor, Dict[str, Any]]:
    """token (B, 1) at the per-request positions ``cache["pos"]``. Each
    row writes its ring slot pos % W in place, attends over its ring, then
    over all encoder positions. Returns (logits (B,1,V), the cache with
    pos advanced)."""
    pos = cache["pos"]
    b = token.shape[0]
    dtype, cdt = ctx.compute_dtype, ctx.cache_dtype
    x = embed_lookup(params["embed"], token, dtype)
    x = x + params["dec_pos"][pos.long()][:, None].to(dtype)
    bidx = torch.arange(b, device=x.device)
    for layer in range(cfg.n_layers):
        lp = tree_index(params["dec_blocks"], layer)
        bc = tree_index(cache["blocks"], layer)
        h = _ln(lp["ln1"], x, cfg.norm_eps)
        q, k, v = _project_qkv(lp["attn"], h, cfg, dtype)
        slot = (pos % bc["k"].shape[1]).long()
        bc["k"][bidx, slot] = k[:, 0].to(cdt)
        bc["v"][bidx, slot] = v[:, 0].to(cdt)
        out = _decode_attn(q, bc["k"].to(dtype), bc["v"].to(dtype), pos + 1,
                           cfg, ctx, cfg.sliding_window)
        x = x + _out_proj(lp["attn"], out, dtype)
        h = _ln(lp["lnx"], x, cfg.norm_eps)
        qx = _cross_q(lp["xattn"], h, cfg, dtype)
        enc_len = bc["xk"].shape[1]
        full = torch.full((b,), enc_len, dtype=torch.int32, device=x.device)
        # cross-attention attends to all encoder positions
        xout = _decode_attn(qx, bc["xk"].to(dtype), bc["xv"].to(dtype),
                            full, cfg, ctx, None)
        x = x + _out_proj(lp["xattn"], xout, dtype)
        h = _ln(lp["ln2"], x, cfg.norm_eps)
        x = x + dense_ffn(lp["mlp"], h, cfg, dtype)
    x = _ln(params["final_norm"], x, cfg.norm_eps)
    logits = x @ params["lm_head"].to(dtype)
    return logits, {"blocks": cache["blocks"], "pos": pos + 1}
