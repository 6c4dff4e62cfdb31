"""Decode attention against gathered caches (``repro.models.attention``).

This is the gather path the reference engine runs by default
(``attn_impl="xla"``): the paged pool is first materialized into a
contiguous per-request view, then attended in plain torch. It is the
``attn_impl="ref"`` route of the port and the parity contract of the
CUDA route (kernels/ops.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.ops import apply_rope

NEG_INF = -1e30


def apply_positional(q: torch.Tensor, k: torch.Tensor, cfg: ModelConfig,
                     positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.pos_emb == "rope":
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta))
    if cfg.pos_emb == "mrope":
        raise NotImplementedError("mrope is not ported yet")
    return q, k  # learned / none: no rotary positions


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,S,KV,D) -> (B,S,H,D): head h reads KV head h // (H // KV)."""
    kv = k.shape[2]
    if kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // kv, dim=2)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          bias: torch.Tensor) -> torch.Tensor:
    """q: (B,Q,H,D), k/v: (B,K,KV,D), bias: (B,Q,K) fp32 additive.
    fp32 scores and softmax; probabilities cast to v's dtype for the PV
    product, as the reference does."""
    d = q.shape[-1]
    h = q.shape[2]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float())
    scores = scores * (d ** -0.5) + bias[:, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def decode_span_attention(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, cache_pos: torch.Tensor,
                          cfg: ModelConfig, *,
                          window: Optional[int] = None) -> torch.Tensor:
    """T-token span attention against an append-only cache.

    q: (B,T,H,D); caches (B,S,KV,D) at absolute slots; cache_pos (B,):
    valid count BEFORE the span. Query t (position cache_pos + t) sees
    slots up to its own position."""
    s = k_cache.shape[1]
    t = q.shape[1]
    win = window if window is not None else cfg.sliding_window
    dev = q.device
    qpos = cache_pos[:, None].long() + torch.arange(t, device=dev)[None, :]
    spos = torch.arange(s, device=dev)[None, None, :]
    valid = spos <= qpos[..., None]
    if win is not None:
        valid &= spos > qpos[..., None] - win
    bias = torch.where(valid, 0.0, NEG_INF).float()
    return _sdpa(q, k_cache, v_cache, bias)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_pos: torch.Tensor,
                     cfg: ModelConfig, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token attention. q: (B,1,H,D); caches (B,W,KV,D), ring-
    addressed: slot i holds absolute position i + W*wraps. cache_pos
    (B,): number of valid tokens (the new token's k/v already written)."""
    w = k_cache.shape[1]
    win = window if window is not None else cfg.sliding_window
    dev = q.device
    pos = cache_pos[:, None].long()
    slot = torch.arange(w, device=dev)[None, :]
    wraps = torch.clamp(pos - 1 - slot, min=0) // w
    abs_pos = slot + wraps * w
    valid = abs_pos < pos
    if win is not None:
        valid &= abs_pos >= pos - win
    bias = torch.where(valid, 0.0, NEG_INF).float()  # (B, W)
    return _sdpa(q, k_cache, v_cache, bias[:, None, :])
