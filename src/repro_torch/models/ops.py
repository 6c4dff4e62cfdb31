"""Elementary model ops (``repro.models.ops``): norms, activations,
embeddings, RoPE, M-RoPE and the training loss. Norms compute in fp32 and
return the caller's dtype, as the reference does."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.float()).to(gate.dtype) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """Row gather with ``jnp.take`` semantics: negative ids wrap (the
    engine embeds draft misses, id -1, as row V-1) and ids outside
    [-V, V) give NaN rows. ``F.embedding`` refuses both."""
    v = table.shape[0]
    idx = torch.where(tokens < 0, tokens + v, tokens)
    ok = (idx >= 0) & (idx < v)
    rows = table[idx.clamp(0, v - 1)].to(compute_dtype)
    return torch.where(ok[..., None], rows,
                       torch.full((), float("nan"), dtype=compute_dtype,
                                  device=rows.device))


def rope_freqs(head_dim: int, theta: float,
               device: torch.device = None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): the rotary half-dim splits into
    sections (temporal, height, width), each rotated by its own position
    stream. x: (..., S, H, D); positions: (3, ..., S). Where the three
    streams coincide (text) it is RoPE."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} != half dim {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    sel = torch.tensor([i for i, s in enumerate(sections) for _ in range(s)],
                       device=x.device)
    pos = torch.movedim(positions, 0, -1).float()  # (..., S, 3)
    angles = pos[..., sel][..., None, :] * freqs  # (..., S, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable token-mean cross entropy in fp32. Returns (mean_loss,
    token_count). One fp32 copy of the logits, as the reference makes."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        mf = mask.float()
        nll = nll * mf
        count = torch.clamp(mf.sum(), min=1.0)
    else:
        count = torch.full((), float(nll.numel()), dtype=torch.float32,
                           device=nll.device)
    return nll.sum() / count, count
