"""GQA attention (``repro.models.attention``): training/prefill over the
full sequence, and decode against gathered caches.

``full_attention`` has two routes: the flash kernel (``impl="cuda"``,
at any sequence length; the reference's Pallas kernel needed
``S % 128 == 0``, the CUDA kernel does not) or the q-chunked plain path
(``impl="ref"``), whose score matrix never exceeds (chunk x S_k) per head.
Both take keys of another length than the queries when the attention is
bidirectional (an encoder-decoder's cross-attention).
The kernel route is ``_FlashAttention``: its forward is
``kernels.ops.flash_attention``, its backward the gradient of the
q-chunked plain path at the same q, k, v, which is the gradient the
reference trainer takes (the TPU kernel has no backward; the reference
trains through the plain path).

Decode is the gather path the reference engine runs by default
(``attn_impl="xla"``): the paged pool is first materialized into a
contiguous per-request view, then attended in plain torch. It is the
``attn_impl="ref"`` route of the port and the parity contract of the
CUDA route (kernels/ops.py).

Masks are computed from positions: causal, sliding-window, bidirectional
and decode (cache validity).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.ops import apply_mrope, apply_rope

NEG_INF = -1e30


def _positions(batch_shape: Tuple[int, ...], seq: int,
               device: torch.device) -> torch.Tensor:
    return torch.arange(seq, device=device).expand(*batch_shape, seq)


def fit_chunk(seq: int, chunk: int) -> int:
    """Largest divisor of ``seq`` that is <= ``chunk``."""
    c = max(1, min(chunk, seq))
    while seq % c:
        c -= 1
    return c


def apply_positional(q: torch.Tensor, k: torch.Tensor, cfg: ModelConfig,
                     positions: torch.Tensor,
                     mrope_positions: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE at ``positions`` (..., S); M-RoPE at the explicit (3, ..., S)
    rows ``mrope_positions``, or, for text-only rows (None), at the three
    streams broadcast from ``positions``, where M-RoPE reduces to RoPE."""
    if cfg.pos_emb == "rope":
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta))
    if cfg.pos_emb == "mrope":
        mp = (mrope_positions if mrope_positions is not None
              else positions[None].expand(3, *positions.shape))
        return (apply_mrope(q, mp, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, mp, cfg.rope_theta, cfg.mrope_sections))
    return q, k  # learned / none: no rotary positions


def _mask_bias(qpos: torch.Tensor, kpos: torch.Tensor, attn_type: str,
               window: Optional[int]) -> torch.Tensor:
    """(..., Q, K) additive bias in fp32. qpos: (..., Q), kpos: (..., K)."""
    diff = qpos[..., :, None] - kpos[..., None, :]
    if attn_type == "bidirectional":
        allowed = torch.ones_like(diff, dtype=torch.bool)
    else:
        allowed = diff >= 0
    if window is not None:
        allowed &= diff < window
    return torch.where(allowed, 0.0, NEG_INF).float()


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,S,KV,D) -> (B,S,H,D): head h reads KV head h // (H // KV)."""
    b, s, kv, d = k.shape
    if kv == n_heads:
        return k
    return k[:, :, :, None].expand(b, s, kv, n_heads // kv, d).reshape(
        b, s, n_heads, d)


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


def _chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       attn_type: str, window: Optional[int],
                       q_chunk: int) -> torch.Tensor:
    """The plain route: query chunks of ``q_chunk`` rows (the largest
    divisor of S_q that fits) each attend over every key; the S_k keys
    sit at positions 0 .. S_k - 1 (another length than the queries' only
    under a bidirectional mask)."""
    b, s = q.shape[:2]
    dev = q.device
    kpos = _positions((b,), k.shape[1], dev)
    if s % q_chunk:
        q_chunk = fit_chunk(s, q_chunk)
    if s <= q_chunk:
        bias = _mask_bias(_positions((b,), s, dev), kpos, attn_type, window)
        return _sdpa(q, k, v, bias)
    outs = []
    for start in range(0, s, q_chunk):
        qpos = start + _positions((b,), q_chunk, dev)
        bias = _mask_bias(qpos, kpos, attn_type, window)
        outs.append(_sdpa(q[:, start:start + q_chunk], k, v, bias))
    return torch.cat(outs, dim=1)


class _FlashAttention(torch.autograd.Function):
    """Forward through ``kops.flash_attention`` (the kernel for
    ``impl="cuda"``); backward = the gradient of ``_chunked_attention`` at
    the saved q, k, v (recomputed in plain torch), since the TPU kernel has
    no backward of its own. The CPU tests drive it with ``impl="ref"``,
    the oracle standing in for the kernel."""

    @staticmethod
    def forward(ctx, q, k, v, attn_type, window, q_chunk, impl):
        b, s, h, d = q.shape

        def fold(x):  # (B,S,H,D) -> (B*H,S,D), contiguous; S_q or S_k
            return _expand_kv(x, h).transpose(1, 2).contiguous().view(
                b * h, x.shape[1], d)

        out = kops.flash_attention(
            fold(q), fold(k), fold(v), impl=impl,
            causal=attn_type != "bidirectional", window=window)
        ctx.save_for_backward(q, k, v)
        ctx.attn = (attn_type, window, q_chunk)
        return out.reshape(b, h, s, d).transpose(1, 2)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            out = _chunked_attention(*leaves, *ctx.attn)
        dq, dk, dv = torch.autograd.grad(out, leaves, grad)
        return dq, dk, dv, None, None, None, None


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cfg: ModelConfig, *, q_chunk: int = 2048,
                   attn_type: Optional[str] = None,
                   window: Optional[int] = None,
                   impl: str = "ref") -> torch.Tensor:
    """Training/prefill attention. q: (B,S_q,H,D); k,v: (B,S_k,KV,D),
    S_k == S_q unless the attention is bidirectional (cross-attention).

    impl="cuda" routes through the flash kernel (CUDA tensors only): KV
    heads expand to full heads, heads fold into the batch dimension.
    impl="ref" runs the q-chunked plain path."""
    atype = attn_type or cfg.attn_type
    win = window if window is not None else cfg.sliding_window
    if impl == "ref":
        return _chunked_attention(q, k, v, atype, win, q_chunk)
    # kops.flash_attention rejects an unknown impl and CPU tensors
    return _FlashAttention.apply(q, k, v, atype, win, q_chunk, impl)


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
