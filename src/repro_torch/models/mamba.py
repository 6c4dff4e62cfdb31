"""Mamba (selective SSM) layer, the attention-free sublayer of Jamba
(``repro.models.mamba``), in plain PyTorch: the reference has no Pallas
kernel for it.

Prefill runs a chunked selective scan: a Python loop carries the
(B, d_inner, N) state across chunks where the reference runs ``lax.scan``;
within a chunk the linear recurrence h_t = dA_t * h_{t-1} + dBx_t is a
log-step (Hillis-Steele) inclusive scan with the reference's combine
((a_l, b_l), (a_r, b_r)) -> (a_l a_r, b_l a_r + b_r), where the reference
runs ``associative_scan``, and its running product of dA decays the
incoming state where the reference runs ``cumprod``. The trees add and
multiply the same terms in another order, so they differ by fp32
rounding only. Training differentiates it with autograd, as the
reference does with ``jax.grad``: no op is in place. Decode is the single-step
recurrence against the cached (conv window, ssm state).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (ParamSpec, normal_init, ones_init,
                                       uniform_init, zeros_init)

Tensor = torch.Tensor


def fit_chunk(seq: int, chunk: int) -> int:
    """Largest divisor of ``seq`` that is <= ``chunk``."""
    c = max(1, min(chunk, seq))
    while seq % c:
        c -= 1
    return c


def mamba_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, di, n, dr, w = (cfg.d_model, cfg.d_inner, cfg.ssm_state_dim,
                       cfg.dt_rank, cfg.ssm_conv_width)

    def a_log_init(gen, shape, dtype, device):
        # S4D-real initialization: A = -(1..N) per channel
        a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
        return torch.log(a).expand(shape).to(dtype).contiguous()

    return {
        "in_proj": ParamSpec((d, 2 * di), ("embed", "mlp")),
        "conv_w": ParamSpec((w, di), ("conv", "mlp"),
                            init=normal_init(0.1)),
        "conv_b": ParamSpec((di,), ("mlp",), init=zeros_init()),
        "x_proj": ParamSpec((di, dr + 2 * n), ("mlp", None)),
        "dt_proj": ParamSpec((dr, di), (None, "mlp"),
                             init=normal_init(dr ** -0.5)),
        "dt_bias": ParamSpec((di,), ("mlp",),
                             init=uniform_init(-4.6, -2.3)),  # softplus→dt
        "a_log": ParamSpec((di, n), ("mlp", "state"), init=a_log_init),
        "d_skip": ParamSpec((di,), ("mlp",), init=ones_init()),
        "out_proj": ParamSpec((di, d), ("mlp", "embed")),
    }


def _inclusive_scan(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 over axis 1, in
    ceil(log2 T) steps of the reference's combine. Returns (the inclusive
    running product of a, h), each (B,T,C,N)."""
    t = a.shape[1]
    off = 1
    while off < t:
        b = torch.cat([b[:, :off], b[:, :-off] * a[:, off:] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return a, b


def _ssm_scan_chunked(dA: Tensor, dBx: Tensor, h0: Tensor,
                      chunk: int) -> Tuple[Tensor, Tensor]:
    """Linear recurrence h_t = dA_t*h_{t-1} + dBx_t over time axis 1.

    dA, dBx: (B, S, C, N). h0: (B, C, N). Returns (h_all (B,S,C,N),
    h_last)."""
    s = dA.shape[1]
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    h = h0
    outs = []
    for c0 in range(0, s, chunk):
        a_ch, bx_ch = dA[:, c0:c0 + chunk], dBx[:, c0:c0 + chunk]
        # the chunk's own recurrence from zero, plus the incoming state
        # decayed through the chunk by the scan's running product of dA
        # (the reference's cumprod, in the tree's order: torch.cumprod's
        # gradient is a float cumsum, which the trainer's deterministic
        # mode refuses on the card)
        a_cum, h_intra = _inclusive_scan(a_ch, bx_ch)
        h_all = h_intra + a_cum * h[:, None]
        h = h_all[:, -1]
        outs.append(h_all)
    return torch.cat(outs, dim=1), h


def mamba_forward(params: Dict[str, Tensor], x: Tensor, cfg: ModelConfig,
                  compute_dtype: torch.dtype, *, chunk: int = 256,
                  init_state: Optional[Tuple[Tensor, Tensor]] = None,
                  return_state: bool = False,
                  seq_mask: Optional[Tensor] = None):
    """x: (B, S, D). Returns out (B,S,D) [, (conv_cache, ssm_state)].

    ``seq_mask`` (B,S) zeroes the post-conv activation at padded
    positions: with zero inputs the only nonzero intermediate is the conv
    bias, and masking it keeps dBx = 0 there, so a zero state passes
    through a pad *prefix* exactly unchanged (front-padded prefill)."""
    b, s, _ = x.shape
    dt = compute_dtype
    di, n, dr, w = (cfg.d_inner, cfg.ssm_state_dim, cfg.dt_rank,
                    cfg.ssm_conv_width)

    xz = x @ params["in_proj"].to(dt)  # (B,S,2di)
    xin, z = xz[..., :di], xz[..., di:]

    # depthwise causal conv over time
    conv_in = (init_state[0] if init_state is not None else
               torch.zeros((b, w - 1, di), dtype=dt, device=x.device))
    xpad = torch.cat([conv_in.to(dt), xin], dim=1)  # (B, S+w-1, di)
    conv_w = params["conv_w"].to(dt)  # (w, di)
    xc = sum(xpad[:, i:i + s] * conv_w[i] for i in range(w))
    xc = F.silu((xc + params["conv_b"].to(dt)).float()).to(dt)
    if seq_mask is not None:
        xc = xc * seq_mask[..., None].to(xc.dtype)
    new_conv = xpad[:, s:]  # the last w-1 inputs

    # input-dependent dt, B, C
    dbc = xc @ params["x_proj"].to(dt)  # (B,S,dr+2N)
    dt_low, b_in, c_in = torch.split(dbc, [dr, n, n], dim=-1)
    delta = F.softplus((dt_low @ params["dt_proj"].to(dt)).float()
                       + params["dt_bias"].float())  # (B,S,di) fp32
    a = -torch.exp(params["a_log"].float())  # (di, N)
    dA = torch.exp(delta[..., None] * a)  # (B,S,di,N) fp32
    dBx = (delta * xc.float())[..., None] * b_in.float()[..., None, :]

    h0 = (init_state[1].float() if init_state is not None else
          torch.zeros((b, di, n), dtype=torch.float32, device=x.device))
    h_all, h_last = _ssm_scan_chunked(dA, dBx, h0, fit_chunk(s, chunk))

    y = torch.einsum("bscn,bsn->bsc", h_all, c_in.float())  # (B,S,di)
    y = y + params["d_skip"].float() * xc.float()
    y = y.to(dt) * F.silu(z.float()).to(dt)
    out = y @ params["out_proj"].to(dt)
    if return_state:
        return out, (new_conv, h_last)
    return out


def mamba_decode_step(params: Dict[str, Tensor], x: Tensor,
                      state: Tuple[Tensor, Tensor], cfg: ModelConfig,
                      compute_dtype: torch.dtype
                      ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Single-token step. x: (B,1,D); state: (conv (B,w-1,di), h
    (B,di,N))."""
    return mamba_forward(params, x, cfg, compute_dtype, chunk=1,
                         init_state=state, return_state=True)
