"""Sublayer specs, the training forward and the serving datapaths
(``repro.models.blocks``).

A *block* is ``block_len`` sublayers; parameters of all blocks are
stacked on a leading ``n_blocks`` axis, and lm.py runs a Python loop over
that axis where the reference runs ``lax.scan``. A sublayer's core is
attention, Mamba or the RWKV-6 time mix (``cfg.sublayer_kinds()``), its
MLP a dense FFN, an MoE or, after an RWKV core, the RWKV channel mix.
The full-sequence forward of the training loss takes every kind. Serving
has two layouts:

  * dense per-slot caches: attention k/v of shape (B, W, KV, D), a ring
    when a sliding window makes W smaller than the serve window (slot =
    position % W); Mamba's (conv window, ssm state) and RWKV's (token
    shift, WKV state, channel-mix token shift), constant in size;
    full-prompt prefill (front-padded for state-family stacks), one-token
    decode and T-token span decode against them, all updating the caches
    in place;
  * the paged pool (pure-attention stacks): int8 page quantization, and
    one-token / T-token decode against the pool.

Pages are a shared pool per layer: k/v of shape (num_pages, page_size, KV,
D), plus (num_pages, page_size, KV) bf16 scale pages when the cache dtype
is int8. A request owns a row of the (B, M) page table, padded with the
reserved trash page 0; token ``p`` lives in page ``table[p // page_size]``
at slot ``p % page_size``. Page writes update the pool in place (the
reference returns a new pool; here the returned dict is the same one).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models.attention import (apply_positional, decode_attention,
                                          decode_span_attention,
                                          full_attention)
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba import mamba_forward, mamba_param_specs
from repro_torch.models.moe import (dense_ffn, dense_ffn_specs, moe_ffn,
                                    moe_param_specs)
from repro_torch.models.ops import rms_norm
from repro_torch.models.params import ParamSpec, ones_init, zeros_init
from repro_torch.models.rwkv6 import (rwkv_channel_mix, rwkv_channel_specs,
                                      rwkv_param_specs, rwkv_time_mix)

Tensor = torch.Tensor


class TensorSpec(NamedTuple):
    """Shape and dtype of a state tensor (the port's ShapeDtypeStruct)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


class ModelContext:
    """Runtime knobs threaded through forwards.

    ``device`` defaults to the card (raising when there is none);
    ``attn_impl`` defaults to "cuda" on a CUDA device and "ref" (the
    gather / q-chunked paths of models/attention.py) on the CPU;
    ``q_chunk`` bounds the plain path's query chunk; ``mamba_chunk`` and
    ``rwkv_chunk`` are the chunk lengths of the Mamba scan and the RWKV
    WKV (each fit to a divisor of the sequence).
    ``full_cache_window`` keeps absolute (non-ring) dense KV slots even
    for sliding-window archs. ``moe_dispatch`` is
    the serving MoE dispatch: "grouped" (sort-based dropless through the
    grouped GEMM; the default) or "capacity" (the dropless capacity
    buffer); ``moe_impl=None`` derives the GEMM impl from attn_impl."""

    def __init__(self, *, compute_dtype: torch.dtype = torch.bfloat16,
                 q_chunk: int = 2048, mamba_chunk: int = 256,
                 rwkv_chunk: int = 16,
                 attn_impl: Optional[str] = None,
                 decode_cache_dtype: Optional[torch.dtype] = None,
                 full_cache_window: bool = False,
                 device: DeviceLike = None,
                 moe_dispatch: str = "grouped",
                 moe_impl: Optional[str] = None):
        self.device = resolve_device(device)
        if attn_impl is None:
            attn_impl = "cuda" if self.device.type == "cuda" else "ref"
        if attn_impl not in kops.IMPLS:
            raise ValueError(f"attn_impl must be one of {kops.IMPLS}, "
                             f"got {attn_impl!r}")
        if attn_impl == "cuda" and self.device.type != "cuda":
            raise ValueError("attn_impl='cuda' needs a CUDA device")
        self.compute_dtype = compute_dtype
        self.q_chunk = q_chunk
        self.mamba_chunk = mamba_chunk
        self.rwkv_chunk = rwkv_chunk
        self.attn_impl = attn_impl
        self.decode_cache_dtype = decode_cache_dtype  # None -> compute
        self.full_cache_window = full_cache_window
        if moe_dispatch not in ("grouped", "capacity"):
            raise ValueError(f"moe_dispatch must be 'grouped' or "
                             f"'capacity', got {moe_dispatch!r}")
        if moe_impl is not None and moe_impl not in kops.IMPLS:
            raise ValueError(f"moe_impl must be one of {kops.IMPLS}, "
                             f"got {moe_impl!r}")
        self.moe_dispatch = moe_dispatch
        self.moe_impl = moe_impl

    @property
    def cache_dtype(self) -> torch.dtype:
        return self.decode_cache_dtype or self.compute_dtype

    def moe_kwargs(self) -> Dict[str, Any]:
        """Serving-path moe_ffn kwargs for this context (dropless)."""
        if self.moe_dispatch != "grouped":
            return {"dropless": True}
        return {"dispatch": "grouped",
                "impl": self.moe_impl or self.attn_impl}


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def attn_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h, kv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    specs = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((h, hd), ("heads", "head_dim"),
                                init=zeros_init())
        specs["bk"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"),
                                init=zeros_init())
        specs["bv"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"),
                                init=zeros_init())
    return specs


def sublayer_specs(cfg: ModelConfig, idx: int) -> Dict[str, Any]:
    kind = cfg.sublayer_kinds()[idx]
    d = cfg.d_model
    core = {"attn": attn_param_specs, "mamba": mamba_param_specs,
            "rwkv": rwkv_param_specs}
    if kind not in core:
        raise ValueError(kind)
    if kind == "rwkv":
        mlp = rwkv_channel_specs(cfg)
    elif cfg.sublayer_has_moe(idx):
        mlp = moe_param_specs(cfg)
    else:
        mlp = dense_ffn_specs(cfg)
    return {
        "ln1": ParamSpec((d,), ("embed",), init=ones_init()),
        "ln2": ParamSpec((d,), ("embed",), init=ones_init()),
        "core": core[kind](cfg),
        "mlp": mlp,
    }


def block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {f"sl{i}": sublayer_specs(cfg, i) for i in range(cfg.block_len)}


def stack_specs(specs: Any, n: int) -> Any:
    """Add a leading stacking dim (logical axis None) to every leaf."""
    if isinstance(specs, ParamSpec):
        return ParamSpec((n, *specs.shape), (None, *specs.logical),
                         specs.init, specs.dtype)
    return {k: stack_specs(v, n) for k, v in specs.items()}


def _project_qkv(p: Dict[str, Tensor], x: Tensor, cfg: ModelConfig,
                 dtype: torch.dtype) -> Tuple[Tensor, Tensor, Tensor]:
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    return q, k, v


# ---------------------------------------------------------------------------
# Forward (training / no cache)
# ---------------------------------------------------------------------------


def attn_forward(p: Dict[str, Tensor], x: Tensor, cfg: ModelConfig,
                 ctx: ModelContext, attn_type: Optional[str] = None,
                 mrope_positions: Optional[Tensor] = None) -> Tensor:
    """``mrope_positions`` (3,B,S): explicit M-RoPE rows (None: text
    rows at the absolute positions)."""
    b, s, _ = x.shape
    dtype = ctx.compute_dtype
    q, k, v = _project_qkv(p, x, cfg, dtype)
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k = apply_positional(q, k, cfg, positions, mrope_positions)
    out = full_attention(q, k, v, cfg, q_chunk=ctx.q_chunk,
                         attn_type=attn_type, impl=ctx.attn_impl)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dtype))


def sublayer_forward(p: Dict[str, Any], x: Tensor, cfg: ModelConfig,
                     ctx: ModelContext, idx: int,
                     mrope_positions: Optional[Tensor] = None
                     ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """norm -> attention, Mamba or the RWKV time mix -> residual, norm ->
    the RWKV channel mix, MoE or dense MLP -> residual. MoE sublayers run
    the capacity dispatch with its aux losses, as the reference's training
    forward does."""
    kind = cfg.sublayer_kinds()[idx]
    dtype = ctx.compute_dtype
    aux: Dict[str, Tensor] = {}
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "attn":
        core = attn_forward(p["core"], h, cfg, ctx,
                            mrope_positions=mrope_positions)
    elif kind == "mamba":
        core = mamba_forward(p["core"], h, cfg, dtype, chunk=ctx.mamba_chunk)
    else:  # rwkv
        core = rwkv_time_mix(p["core"], h, cfg, ctx)
    x = x + core
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if kind == "rwkv":
        mlp = rwkv_channel_mix(p["mlp"], h, cfg, dtype)
    elif cfg.sublayer_has_moe(idx):
        mlp, aux = moe_ffn(p["mlp"], h, cfg, dtype)
    else:
        mlp = dense_ffn(p["mlp"], h, cfg, dtype)
    return x + mlp, aux


def block_forward(block_params: Dict[str, Any], x: Tensor, cfg: ModelConfig,
                  ctx: ModelContext, mrope_positions: Optional[Tensor] = None
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
    aux_total: Dict[str, Tensor] = {}
    for i in range(cfg.block_len):
        x, aux = sublayer_forward(block_params[f"sl{i}"], x, cfg, ctx, i,
                                  mrope_positions)
        for key, val in aux.items():
            aux_total[key] = aux_total.get(key, 0.0) + val
    return x, aux_total


# ---------------------------------------------------------------------------
# Paged KV pool
# ---------------------------------------------------------------------------


def paged_quantize(x: Tensor, dtype: torch.dtype
                   ) -> Tuple[Tensor, Optional[Tensor]]:
    """Per-(token, kv-head) symmetric int8 quantization.

    x: (..., KV, D). Returns (stored, scale or None); the scale (..., KV)
    is bf16, the storage dtype of the scale pages, and the values are
    quantized against that rounded scale (round half to even) so that
    dequantization inverts exactly."""
    if dtype != torch.int8:
        return x.to(dtype), None
    scale = torch.clamp(x.abs().amax(dim=-1), min=1e-8) / 127.0
    scale = scale.to(torch.bfloat16)
    q = torch.clamp(torch.round(x / scale[..., None].float()), -127, 127)
    return q.to(torch.int8), scale


def paged_dequantize(x: Tensor, scale: Optional[Tensor],
                     dtype: torch.dtype) -> Tensor:
    if scale is None:
        return x.to(dtype)
    return (x.float() * scale[..., None]).to(dtype)


def paged_sublayer_cache_spec(cfg: ModelConfig, num_pages: int,
                              page_size: int, ctx: ModelContext
                              ) -> Dict[str, TensorSpec]:
    hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
    cdt = ctx.cache_dtype
    spec = {
        "k": TensorSpec((num_pages, page_size, kv, hd), cdt),
        "v": TensorSpec((num_pages, page_size, kv, hd), cdt),
    }
    if cdt == torch.int8:
        spec["k_scale"] = TensorSpec((num_pages, page_size, kv),
                                     torch.bfloat16)
        spec["v_scale"] = TensorSpec((num_pages, page_size, kv),
                                     torch.bfloat16)
    return spec


def paged_block_cache_spec(cfg: ModelConfig, num_pages: int, page_size: int,
                           ctx: ModelContext) -> Dict[str, Any]:
    kinds = set(cfg.sublayer_kinds())
    if kinds != {"attn"}:
        raise ValueError(
            f"paged KV serving requires a pure-attention stack, got {kinds}")
    return {f"sl{i}": paged_sublayer_cache_spec(cfg, num_pages, page_size,
                                                ctx)
            for i in range(cfg.block_len)}


def _paged_gather(pages: Dict[str, Tensor], page_table: Tensor,
                  dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
    """Materialize each request's KV view: (B, M*P, KV, D) in ``dtype``."""
    _, p, kv, hd = pages["k"].shape
    b, m = page_table.shape
    tab = page_table.long()
    ks, vs = pages.get("k_scale"), pages.get("v_scale")
    kg = paged_dequantize(pages["k"][tab],
                          None if ks is None else ks[tab], dtype)
    vg = paged_dequantize(pages["v"][tab],
                          None if vs is None else vs[tab], dtype)
    shape = (b, m * p, kv, hd)
    return kg.reshape(shape), vg.reshape(shape)


def _write_pages(pages: Dict[str, Tensor], pid: Tensor, slot: Tensor,
                 k: Tensor, v: Tensor, cache_dtype: torch.dtype) -> None:
    """Quantize and scatter k/v (pid/slot-shaped leading dims) in place.
    Duplicate targets only ever hit the trash page 0, never read as
    valid, so their nondeterministic order is harmless."""
    kq, ks = paged_quantize(k, cache_dtype)
    vq, vs = paged_quantize(v, cache_dtype)
    pages["k"][pid, slot] = kq
    pages["v"][pid, slot] = vq
    if ks is not None:
        pages["k_scale"][pid, slot] = ks
        pages["v_scale"][pid, slot] = vs


def _table_lookup(page_table: Tensor, bidx: Tensor, posn: Tensor,
                  page_size: int) -> Tensor:
    """Owning page of each position; page indices past the row clamp to
    its last entry, as the reference's gather does."""
    col = torch.clamp(posn // page_size, 0, page_table.shape[1] - 1)
    return page_table[bidx, col.long()].long()


def _residual_mlp(p, x, core, cfg: ModelConfig, ctx: ModelContext,
                  idx: int, live: Optional[Tensor] = None,
                  cache: Optional[Dict[str, Tensor]] = None,
                  cm_prev: Optional[Tensor] = None) -> Tensor:
    """Residual of the core output, norm, MLP/MoE (or, after an RWKV core,
    the channel mix from the token ``cm_prev``, its new token written to
    ``cache["cm_tok"]``), residual. ``live`` (B,T) zeroes both sublayer
    outputs at dead positions, so the residual stream stays exactly 0
    there."""
    dtype = ctx.compute_dtype
    if live is not None:
        core = torch.where(live[..., None], core, 0.0)
    x = x + core
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.sublayer_kinds()[idx] == "rwkv":
        mlp, cm_tok = rwkv_channel_mix(p["mlp"], h, cfg, dtype,
                                       prev=cm_prev, return_state=True)
        cache["cm_tok"].copy_(cm_tok)
    elif cfg.sublayer_has_moe(idx):
        mlp, _ = moe_ffn(p["mlp"], h, cfg, dtype, with_aux=False,
                         **ctx.moe_kwargs())
    else:
        mlp = dense_ffn(p["mlp"], h, cfg, dtype)
    if live is not None:
        mlp = torch.where(live[..., None], mlp, 0.0)
    return x + mlp


def _attn_out_mlp(p, x, out, cfg: ModelConfig, ctx: ModelContext,
                  idx: int, live: Optional[Tensor] = None) -> Tensor:
    """o-projection, then ``_residual_mlp``."""
    core = torch.einsum("bshk,hkd->bsd", out,
                        p["core"]["wo"].to(ctx.compute_dtype))
    return _residual_mlp(p, x, core, cfg, ctx, idx, live)


def sublayer_decode_paged(p, x: Tensor, pages: Dict[str, Tensor],
                          page_table: Tensor, pos: Tensor, cfg: ModelConfig,
                          ctx: ModelContext, idx: int
                          ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token decode against the paged pool. x: (B,1,D); pos: (B,)."""
    dtype = ctx.compute_dtype
    b = x.shape[0]
    page_size = pages["k"].shape[1]
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(p["core"], h, cfg, dtype)
    q, k = apply_positional(q, k, cfg, pos[:, None])
    bidx = torch.arange(b, device=x.device)
    pid = _table_lookup(page_table, bidx, pos, page_size)
    slot = (pos % page_size).long()
    _write_pages(pages, pid, slot, k[:, 0], v[:, 0], ctx.cache_dtype)
    if ctx.attn_impl == "cuda":
        # stream pages through the kernel: no contiguous per-request view
        out = kops.paged_decode_attention(
            q[:, 0], pages["k"], pages["v"], page_table, pos + 1,
            k_scale=pages.get("k_scale"), v_scale=pages.get("v_scale"),
            impl="cuda", window=cfg.sliding_window)[:, None]
    else:
        kg, vg = _paged_gather(pages, page_table, dtype)
        out = decode_attention(q, kg, vg, pos + 1, cfg)
    return _attn_out_mlp(p, x, out, cfg, ctx, idx), pages


def block_decode_paged(block_params, x, pages, page_table, pos, cfg, ctx):
    for i in range(cfg.block_len):
        x, _ = sublayer_decode_paged(
            block_params[f"sl{i}"], x, pages[f"sl{i}"], page_table, pos,
            cfg, ctx, i)
    return x, pages


def sublayer_decode_span_paged(p, x: Tensor, pages: Dict[str, Tensor],
                               page_table: Tensor, pos: Tensor, live: Tensor,
                               cfg: ModelConfig, ctx: ModelContext, idx: int,
                               mrope_positions: Optional[Tensor] = None
                               ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """T-token span decode against the paged pool.

    x: (B,T,D) at absolute positions ``pos .. pos+T-1``; live: (B,T)
    bool, False for padded span slots, whose writes go to trash page 0.
    The span's k/v are written first, then query t attends causally
    through position pos + t. ``mrope_positions`` (3,B,T): explicit
    multimodal rope rows (None: broadcast from the absolute positions)."""
    dtype = ctx.compute_dtype
    b, t, _ = x.shape
    page_size = pages["k"].shape[1]
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(p["core"], h, cfg, dtype)
    posn = pos[:, None] + torch.arange(t, device=x.device,
                                       dtype=pos.dtype)[None, :]
    q, k = apply_positional(q, k, cfg, posn, mrope_positions)
    bidx = torch.arange(b, device=x.device)[:, None]
    pid = torch.where(live, _table_lookup(page_table, bidx, posn, page_size),
                      0)
    slot = (posn % page_size).long()
    _write_pages(pages, pid, slot, k, v, ctx.cache_dtype)
    if ctx.attn_impl == "cuda":
        out = kops.paged_decode_span_attention(
            q, pages["k"], pages["v"], page_table, pos,
            k_scale=pages.get("k_scale"), v_scale=pages.get("v_scale"),
            impl="cuda", window=cfg.sliding_window)
    else:
        kg, vg = _paged_gather(pages, page_table, dtype)
        out = decode_span_attention(q, kg, vg, pos, cfg)
    return _attn_out_mlp(p, x, out, cfg, ctx, idx), pages


def block_decode_span_paged(block_params, x, pages, page_table, pos, live,
                            cfg, ctx, mrope_positions=None):
    for i in range(cfg.block_len):
        x, _ = sublayer_decode_span_paged(
            block_params[f"sl{i}"], x, pages[f"sl{i}"], page_table, pos,
            live, cfg, ctx, i, mrope_positions)
    return x, pages


# ---------------------------------------------------------------------------
# Dense per-slot caches (prefill / decode / span decode)
# ---------------------------------------------------------------------------


def sublayer_cache_spec(cfg: ModelConfig, idx: int, batch: int, window: int,
                        ctx: ModelContext) -> Dict[str, TensorSpec]:
    """Ring-buffered k/v of an attention sublayer: (batch, W, KV, D) with
    W = min(window, sliding window) unless ``ctx.full_cache_window``.
    Mamba: the conv window (batch, w-1, d_inner) in the compute dtype and
    the ssm state (batch, d_inner, N) in f32. RWKV: the time mix's token
    shift (batch, 1, D) and the channel mix's, in the compute dtype, and
    the WKV state (batch, H, hd, hd) in f32."""
    kind = cfg.sublayer_kinds()[idx]
    cdt = ctx.compute_dtype
    if kind == "mamba":
        return {
            "conv": TensorSpec((batch, cfg.ssm_conv_width - 1, cfg.d_inner),
                               cdt),
            "ssm": TensorSpec((batch, cfg.d_inner, cfg.ssm_state_dim),
                              torch.float32),
        }
    if kind == "rwkv":
        hd = cfg.rwkv_head_dim
        return {
            "tok": TensorSpec((batch, 1, cfg.d_model), cdt),
            "wkv": TensorSpec((batch, cfg.rwkv_heads, hd, hd),
                              torch.float32),
            "cm_tok": TensorSpec((batch, 1, cfg.d_model), cdt),
        }
    w = window
    if cfg.sliding_window is not None and not ctx.full_cache_window:
        w = min(window, cfg.sliding_window)
    shape = (batch, w, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": TensorSpec(shape, ctx.cache_dtype),
            "v": TensorSpec(shape, ctx.cache_dtype)}


def block_cache_spec(cfg: ModelConfig, batch: int, window: int,
                     ctx: ModelContext) -> Dict[str, Any]:
    return {f"sl{i}": sublayer_cache_spec(cfg, i, batch, window, ctx)
            for i in range(cfg.block_len)}


def init_cache(spec: Any, device: torch.device) -> Any:
    """Zero tensors for a tree of TensorSpecs."""
    if isinstance(spec, TensorSpec):
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    return {k: init_cache(v, device) for k, v in spec.items()}


def _state_core(p, h: Tensor, cache: Dict[str, Tensor], cfg: ModelConfig,
                ctx: ModelContext, idx: int, *, fresh: bool = False,
                live: Optional[Tensor] = None) -> Tensor:
    """The Mamba or RWKV core of a sublayer on the normed input ``h``,
    from the cached state (``fresh``: from zeros, as a prefill starts),
    its new state written into ``cache`` in place. ``live`` (B,S) is
    Mamba's ``seq_mask``: a zero state passes a masked pad prefix
    exactly."""
    if cfg.sublayer_kinds()[idx] == "mamba":
        core, (conv, ssm) = mamba_forward(
            p["core"], h, cfg, ctx.compute_dtype, chunk=ctx.mamba_chunk,
            init_state=None if fresh else (cache["conv"], cache["ssm"]),
            return_state=True, seq_mask=live)
        cache["conv"].copy_(conv)
        cache["ssm"].copy_(ssm)
        return core
    core, (tok, _) = rwkv_time_mix(
        p["core"], h, cfg, ctx,
        init_state=None if fresh else (cache["tok"], cache["wkv"]),
        return_state=True, state_out=cache["wkv"])
    cache["tok"].copy_(tok)
    return core


def sublayer_prefill(p, x: Tensor, cache: Dict[str, Tensor],
                     cfg: ModelConfig, ctx: ModelContext, idx: int,
                     seq_mask: Optional[Tensor] = None,
                     mrope_positions: Optional[Tensor] = None
                     ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Full-sequence forward that fills the cache. x: (B,S,D); ``cache``
    holds zeros of the spec's shape and is filled in place. With S past
    the cache width W only the last W positions are kept, rolled so that
    position p sits in slot p % W.

    ``seq_mask`` (B,S) marks live positions when the server front-pads a
    prompt to a bucketed length (state families only): with zeroed
    embeddings the residual stream is exactly 0 through the pad prefix
    (every projection is bias-free and every core output is gated by a
    zero), so masking the one biased intermediate, Mamba's conv, keeps
    the recurrent state untouched until the first live token.
    ``mrope_positions`` (3,B,S): explicit multimodal rope rows."""
    kind = cfg.sublayer_kinds()[idx]
    if kind != "attn":
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        core = _state_core(p, h, cache, cfg, ctx, idx, fresh=True,
                           live=seq_mask)
        return _residual_mlp(p, x, core, cfg, ctx, idx, cache=cache), cache
    if seq_mask is not None:
        raise ValueError(
            "seq_mask (front padding) requires a state-family stack; "
            "attention positions would shift")
    dtype = ctx.compute_dtype
    b, s, _ = x.shape
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(p["core"], h, cfg, dtype)
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k = apply_positional(q, k, cfg, positions, mrope_positions)
    out = full_attention(q, k, v, cfg, q_chunk=ctx.q_chunk,
                         impl=ctx.attn_impl)
    w = cache["k"].shape[1]
    for name, val in (("k", k), ("v", v)):
        if w >= s:
            cache[name][:, :s] = val.to(ctx.cache_dtype)
        else:
            start = s - w
            cache[name].copy_(torch.roll(val[:, start:], start % w, dims=1))
    return _attn_out_mlp(p, x, out, cfg, ctx, idx), cache


def sublayer_decode(p, x: Tensor, cache: Dict[str, Tensor], pos: Tensor,
                    cfg: ModelConfig, ctx: ModelContext, idx: int
                    ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token decode. x: (B,1,D); pos: (B,) int32 valid-token count
    BEFORE this token. Each row writes its own ring slot pos % W in place,
    then attends over its valid slots; a Mamba or RWKV sublayer steps its
    state in place."""
    dtype = ctx.compute_dtype
    if cfg.sublayer_kinds()[idx] != "attn":
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        core = _state_core(p, h, cache, cfg, ctx, idx)
        return _residual_mlp(p, x, core, cfg, ctx, idx, cache=cache,
                             cm_prev=cache.get("cm_tok")), cache
    b = x.shape[0]
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(p["core"], h, cfg, dtype)
    q, k = apply_positional(q, k, cfg, pos[:, None])
    w = cache["k"].shape[1]
    bidx = torch.arange(b, device=x.device)
    slot = (pos % w).long()
    cache["k"][bidx, slot] = k[:, 0].to(ctx.cache_dtype)
    cache["v"][bidx, slot] = v[:, 0].to(ctx.cache_dtype)
    kc, vc = cache["k"].to(dtype), cache["v"].to(dtype)  # no copy if equal
    if ctx.attn_impl == "cuda":
        # the kernel reads the ring as it is stored
        out = kops.decode_attention(
            q[:, 0].contiguous(), kc, vc, pos + 1, impl="cuda",
            window=cfg.sliding_window)[:, None]
    else:
        out = decode_attention(q, kc, vc, pos + 1, cfg)
    return _attn_out_mlp(p, x, out, cfg, ctx, idx), cache


def sublayer_decode_span(p, x: Tensor, cache: Dict[str, Tensor],
                         pos: Tensor, live: Tensor, cfg: ModelConfig,
                         ctx: ModelContext, idx: int,
                         mrope_positions: Optional[Tensor] = None
                         ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """T-token span decode against dense per-slot caches.

    x: (B,T,D) at absolute positions ``pos .. pos+T-1``, already zeroed
    at dead positions; live: (B,T) bool. The caches hold absolute slots
    (W >= total length, no ring wrap): k/v land at their position, writes
    of dead (or out-of-range) positions are dropped. Every sublayer output
    is re-masked, so the residual stream stays exactly 0 at dead
    positions: a Mamba or RWKV state threads through the span from the
    cache, untouched by a dead prefix. ``mrope_positions`` (3,B,T):
    explicit multimodal rope rows for the span."""
    dtype = ctx.compute_dtype
    if cfg.sublayer_kinds()[idx] != "attn":
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        core = _state_core(p, h, cache, cfg, ctx, idx, live=live)
        return _residual_mlp(p, x, core, cfg, ctx, idx, live, cache=cache,
                             cm_prev=cache.get("cm_tok")), cache
    b, t, _ = x.shape
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(p["core"], h, cfg, dtype)
    posn = pos[:, None] + torch.arange(t, device=x.device,
                                       dtype=pos.dtype)[None, :]
    q, k = apply_positional(q, k, cfg, posn, mrope_positions)
    w = cache["k"].shape[1]
    bi, ti = torch.nonzero(live & (posn >= 0) & (posn < w), as_tuple=True)
    slot = posn[bi, ti].long()
    cache["k"][bi, slot] = k[bi, ti].to(ctx.cache_dtype)
    cache["v"][bi, slot] = v[bi, ti].to(ctx.cache_dtype)
    out = decode_span_attention(q, cache["k"].to(dtype),
                                cache["v"].to(dtype), pos, cfg)
    return _attn_out_mlp(p, x, out, cfg, ctx, idx, live), cache


def block_prefill(block_params, x, cache, cfg, ctx, seq_mask=None,
                  mrope_positions=None):
    for i in range(cfg.block_len):
        x, _ = sublayer_prefill(block_params[f"sl{i}"], x, cache[f"sl{i}"],
                                cfg, ctx, i, seq_mask, mrope_positions)
    return x, cache


def block_decode(block_params, x, cache, pos, cfg, ctx):
    for i in range(cfg.block_len):
        x, _ = sublayer_decode(block_params[f"sl{i}"], x, cache[f"sl{i}"],
                               pos, cfg, ctx, i)
    return x, cache


def block_decode_span(block_params, x, cache, pos, live, cfg, ctx,
                      mrope_positions=None):
    for i in range(cfg.block_len):
        x, _ = sublayer_decode_span(block_params[f"sl{i}"], x,
                                    cache[f"sl{i}"], pos, live, cfg, ctx, i,
                                    mrope_positions)
    return x, cache
