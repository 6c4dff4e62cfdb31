"""RWKV-6 "Finch" layer (``repro.models.rwkv6``): linear attention with
data-dependent decay.

Recurrence per head (k-dim x v-dim state S):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    out_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with w_t = exp(-exp(ww(x_t))) a per-channel, per-token decay and u a
learned current-token bonus. The WKV runs through ``kernels.ops.rwkv_wkv``
(the chunked CUDA kernel under ``attn_impl="cuda"``, its plain version
under "ref") in f32, with the per-step log decay clamped at DECAY_CLAMP so
that the chunk's exponents stay in f32 range. Training differentiates it
through the backward kernel on the card ("cuda") and through autograd of
the plain version under "ref", as the reference differentiates
``_chunked_wkv``; the clamp's gradient is autograd's. Decode carries
(token shift, state): constant memory per sequence.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels.rwkv_scan import DECAY_CLAMP
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba import fit_chunk
from repro_torch.models.params import ParamSpec, normal_init

Tensor = torch.Tensor

LORA_DECAY = 64
LORA_MIX = 32


def rwkv_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    return {
        "r_proj": ParamSpec((d, d), ("embed", "heads")),
        "k_proj": ParamSpec((d, d), ("embed", "heads")),
        "v_proj": ParamSpec((d, d), ("embed", "heads")),
        "g_proj": ParamSpec((d, d), ("embed", "heads")),
        "o_proj": ParamSpec((d, d), ("heads", "embed")),
        # data-dependent decay: low-rank adapter on x
        "w_lora_a": ParamSpec((d, LORA_DECAY), ("embed", None)),
        "w_lora_b": ParamSpec((LORA_DECAY, d), (None, "heads")),
        "w_base": ParamSpec((d,), ("heads",), init=normal_init(0.5)),
        # current-token bonus
        "u_bonus": ParamSpec((h, hd), ("heads", None),
                             init=normal_init(0.5)),
        # token-shift mixing coefficients (r, k, v, g, w)
        "mix": ParamSpec((5, d), (None, "heads"), init=normal_init(0.2)),
    }


def rwkv_channel_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """Channel-mix (RWKV's MLP replacement)."""
    d = cfg.d_model
    return {
        "cm_k": ParamSpec((d, cfg.d_ff), ("embed", "mlp")),
        "cm_v": ParamSpec((cfg.d_ff, d), ("mlp", "embed")),
        "cm_mix": ParamSpec((d,), ("heads",), init=normal_init(0.2)),
    }


def _token_shift(x: Tensor, prev: Optional[Tensor]) -> Tensor:
    """The x_{t-1} stream; prev: (B,1,D) carry for decode and chunks."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def rwkv_time_mix(params: Dict[str, Tensor], x: Tensor, cfg: ModelConfig,
                  ctx, *, init_state: Optional[Tuple[Tensor, Tensor]] = None,
                  return_state: bool = False,
                  state_out: Optional[Tensor] = None):
    """x: (B,S,D) -> (B,S,D). State = (last token (B,1,D), S
    (B,H,hd,hd) f32). ``ctx`` (blocks.ModelContext) gives the compute
    dtype, the WKV impl and its chunk: fit_chunk(S, ctx.rwkv_chunk).
    ``state_out`` takes the final WKV state in place (the serving cache
    row; it may be init_state's own)."""
    b, s, d = x.shape
    dt = ctx.compute_dtype
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    xs = _token_shift(x, init_state[0] if init_state is not None else None)
    mix = params["mix"].to(dt)  # (5, D)

    def mixed(i):
        return x + mix[i] * (xs - x)

    r = (mixed(0) @ params["r_proj"].to(dt)).reshape(b, s, h, hd)
    k = (mixed(1) @ params["k_proj"].to(dt)).reshape(b, s, h, hd)
    v = (mixed(2) @ params["v_proj"].to(dt)).reshape(b, s, h, hd)
    g = mixed(3) @ params["g_proj"].to(dt)
    ww = (mixed(4) @ params["w_lora_a"].to(dt)) @ params["w_lora_b"].to(dt)
    logw = -torch.exp((ww + params["w_base"].to(dt)).float())
    logw = torch.clamp(logw, DECAY_CLAMP, 0.0).reshape(b, s, h, hd)
    s0 = init_state[1].float() if init_state is not None else None
    out, last = kops.rwkv_wkv(
        r.float().contiguous(), k.float().contiguous(),
        v.float().contiguous(), logw.contiguous(),
        params["u_bonus"].float().contiguous(), s0,
        chunk=fit_chunk(s, ctx.rwkv_chunk), impl=ctx.attn_impl,
        state_out=state_out)
    out = out.reshape(b, s, d).to(dt)
    out = out * F.silu(g.float()).to(dt)
    out = out @ params["o_proj"].to(dt)
    if return_state:
        return out, (x[:, -1:], last)
    return out


def rwkv_channel_mix(params: Dict[str, Tensor], x: Tensor, cfg: ModelConfig,
                     compute_dtype: torch.dtype,
                     prev: Optional[Tensor] = None,
                     return_state: bool = False):
    xs = _token_shift(x, prev)
    mix = params["cm_mix"].to(compute_dtype)
    xm = x + mix * (xs - x)
    hidden = torch.square(torch.relu(
        (xm @ params["cm_k"].to(compute_dtype)).float()))
    out = hidden.to(compute_dtype) @ params["cm_v"].to(compute_dtype)
    if return_state:
        return out, x[:, -1:]
    return out
