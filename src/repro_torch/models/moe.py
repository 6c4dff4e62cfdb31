"""Mixture-of-Experts FFN and the dense FFN (``repro.models.moe``).

Two dispatch modes share one router, as in the reference:

* ``dispatch="grouped"`` (the serving default): sort-based dropless
  dispatch. Stable-argsort the (T*k) assignments by expert, pad each
  expert's group to a ``block_m`` boundary, run the m-grouped GEMM
  (kernels/ops.py: the CUDA kernel, or its plain version) over the sorted
  rows with a tile -> expert table, then unpermute and combine with the
  renormalized gate weights. The plan, permute and combine are torch ops,
  as they are jnp ops outside Pallas in the reference. int8 expert
  weights (``quantize_moe_params``) dequantize inside the GEMM through
  per-expert scales.
* ``dispatch="capacity"``: the GShard-style buffer of (E, capacity, D);
  serving uses it with ``dropless=True`` (capacity = token count).

Aux losses (Switch load balance, router z-loss) are identical across the
modes; serving asks for none (``with_aux=False``), so its forward does not
compute them.

Expert parallelism (a serving mesh whose rules split the experts over
"data"), as the reference's ``shard_map`` runs it: the tokens and the plan
are replicated, each rank holds a contiguous block of experts, the up and
gate products run on the tile ids remapped into it (every other tile -1,
which the GEMM zeroes), and the down product is ``grouped_matmul`` over
the mesh, which remaps the same way and sums the rows over "data" before
the combine: each row comes from exactly one rank, pad rows are zero. The
plan must be the same on every rank, so every row of ``x`` must be too,
dead rows included (models/blocks.py keeps the trash page they read
zero).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.ops import gelu, swiglu
from repro_torch.models.params import ParamSpec

Tensor = torch.Tensor

# Bound on the dispatch working set: token counts above this run in
# sequence chunks (the reference's lax.scan becomes a Python loop).
MOE_CHUNK_TOKENS = 65536

# Default m-tile of the grouped GEMM (the reference's GROUPED_BLOCK_M).
GROUPED_BLOCK_M = 8

_EXPERT_WEIGHTS = ("w_up", "w_gate", "w_down")


def moe_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    specs = {
        "router": ParamSpec((d, e), ("embed", None)),
        "w_up": ParamSpec((e, d, f), ("expert", "embed", "expert_mlp")),
        "w_down": ParamSpec((e, f, d), ("expert", "expert_mlp", "embed")),
    }
    if cfg.mlp_act == "swiglu":
        specs["w_gate"] = ParamSpec((e, d, f),
                                    ("expert", "embed", "expert_mlp"))
    return specs


def capacity(tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(tokens * cfg.experts_per_token / cfg.n_experts
                  * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8


def quantize_moe_params(params: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Symmetric per-expert int8 quantization of the expert weights: each
    of w_up/w_gate/w_down becomes int8 with an f32 per-expert scale under
    ``<name>_scale``. The router stays full precision. The scale reduces
    over the trailing (D, F) axes, so a layer-stacked leaf
    (n_blocks, E, D, F) gets an (n_blocks, E) scale."""
    out = dict(params)
    for name in _EXPERT_WEIGHTS:
        if name not in params:
            continue
        w = params[name].float()
        scale = torch.clamp(w.abs().amax(dim=(-2, -1)) / 127.0, min=1e-12)
        q = torch.clamp(torch.round(w / scale[..., None, None]), -127, 127)
        out[name] = q.to(torch.int8)
        out[name + "_scale"] = scale
    return out


def _weight(params: Dict[str, Tensor], name: str,
            compute_dtype: torch.dtype) -> Tensor:
    """Expert weight in compute dtype, dequantizing int8 if scaled."""
    w = params[name]
    scale = params.get(name + "_scale")
    if scale is None:
        return w.to(compute_dtype)
    return (w.float() * scale[:, None, None]).to(compute_dtype)


def _route(params: Dict[str, Tensor], xt: Tensor,
           compute_dtype: torch.dtype, k: int):
    """Shared router: f32 logits/probs, renormalized top-k gates. Ties go
    to the lower expert index, as ``lax.top_k`` does (a stable descending
    sort; ``torch.topk`` promises no order among equal values)."""
    logits = (xt @ params["router"].to(compute_dtype)).float()
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    gate_w, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    gate_w, gate_idx = gate_w[:, :k], gate_idx[:, :k].to(torch.int32)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gate_w, gate_idx


def _aux_losses(logits: Tensor, probs: Tensor, gate_idx: Tensor, t: int,
                k: int, e: int) -> Dict[str, Tensor]:
    me = probs.mean(dim=0)  # mean router prob per expert
    ce = torch.zeros((e,), dtype=torch.float32, device=probs.device)
    ce = ce.index_add(0, gate_idx.reshape(-1).long(),
                      torch.full((t * k,), 1.0 / (t * k),
                                 device=probs.device))
    load_balance = e * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return {"load_balance": load_balance, "router_z": z_loss}


# ---------------------------------------------------------------------------
# Sort-based dropless dispatch (grouped)
# ---------------------------------------------------------------------------


class GroupedDispatch(NamedTuple):
    """Static-shape plan of the sort-based dropless dispatch (int32).

    ``row_src`` (M_pad,): source token row per sorted slot (-1 = pad row).
    ``dest`` (T*k,): sorted slot of each token-major assignment.
    ``block_experts`` (M_pad // block_m,): expert id per m-tile (-1 =
    pad-only tile). ``counts`` (E,): assignments per expert; ``offsets``
    (E+1,): their cumsum; ``padded_starts`` (E,): each expert's
    block-aligned group start in the sorted buffer."""
    row_src: Tensor
    dest: Tensor
    block_experts: Tensor
    counts: Tensor
    offsets: Tensor
    padded_starts: Tensor

    @property
    def padded_rows(self) -> int:
        return self.row_src.shape[0]


def grouped_dispatch_plan(gate_idx: Tensor, *, n_experts: int,
                          block_m: int = GROUPED_BLOCK_M
                          ) -> GroupedDispatch:
    """The sorted, block-aligned dispatch plan of (T, k) routing. The
    buffer is sized at the worst case round_up(T*k + E*(block_m-1),
    block_m), so each m-tile maps to exactly one expert; no host sync
    (the counts come from ``index_add``: ``bincount`` on CUDA reads its
    input's min and max back to the host)."""
    t, k = gate_idx.shape
    tk = t * k
    e, bm = n_experts, block_m
    m_pad = -(-(tk + e * (bm - 1)) // bm) * bm
    nb = m_pad // bm
    dev = gate_idx.device
    i32 = torch.int32

    flat_e = gate_idx.reshape(-1).long()  # token-major (T*k,)
    order = torch.argsort(flat_e, stable=True)  # ties keep token order
    sorted_e = flat_e[order]
    counts = torch.zeros((e,), dtype=i32, device=dev).index_add_(
        0, flat_e, torch.ones((tk,), dtype=i32, device=dev))
    offsets = torch.cat([torch.zeros((1,), dtype=i32, device=dev),
                         torch.cumsum(counts, 0, dtype=i32)])
    padded = -(-counts // bm) * bm
    pad_ends = torch.cumsum(padded, 0, dtype=i32)
    padded_starts = pad_ends - padded

    # rank of each sorted assignment within its expert group, then its
    # destination slot in the block-aligned buffer
    rank = torch.arange(tk, dtype=i32, device=dev) - offsets[sorted_e]
    dest_sorted = (padded_starts[sorted_e] + rank).long()
    dest = torch.zeros((tk,), dtype=i32, device=dev)
    dest[order] = dest_sorted.to(i32)
    row_src = torch.full((m_pad,), -1, dtype=i32, device=dev)
    row_src[dest_sorted] = (order // k).to(i32)

    tile_starts = torch.arange(nb, dtype=i32, device=dev) * bm
    block_experts = torch.searchsorted(pad_ends, tile_starts,
                                       right=True).to(i32)
    block_experts = torch.where(tile_starts < pad_ends[-1], block_experts,
                                -1)
    return GroupedDispatch(row_src, dest, block_experts, counts, offsets,
                           padded_starts)


def grouped_permute(xt: Tensor, plan: GroupedDispatch,
                    dtype: torch.dtype) -> Tensor:
    """Gather token rows (T, D) into sorted order (M_pad, D); pad rows
    are zero."""
    src = torch.clamp(plan.row_src, min=0).long()
    xs = xt[src].to(dtype)
    return torch.where(plan.row_src[:, None] >= 0, xs,
                       torch.zeros((), dtype=dtype, device=xs.device))


def grouped_combine(y: Tensor, plan: GroupedDispatch, gate_w: Tensor,
                    t: int, k: int) -> Tensor:
    """Unpermute (M_pad, D) expert outputs back to token order and
    combine the k assignments with their gate weights -> (T, D)."""
    gathered = y[plan.dest.long()]  # (T*k, D) token-major
    weights = gate_w.reshape(-1).to(y.dtype)
    d = y.shape[-1]
    return (gathered * weights[:, None]).reshape(t, k, d).sum(dim=1)


def _moe_ffn_grouped(params: Dict[str, Tensor], x: Tensor, cfg: ModelConfig,
                     compute_dtype: torch.dtype, impl: str, block_m: int,
                     with_aux: bool, mesh=None
                     ) -> Tuple[Tensor, Dict[str, Tensor]]:
    b, s, d = x.shape
    t = b * s
    k, e = cfg.experts_per_token, cfg.n_experts
    xt = x.reshape(t, d)
    logits, probs, gate_w, gate_idx = _route(params, xt, compute_dtype, k)
    aux = _aux_losses(logits, probs, gate_idx, t, k, e) if with_aux else {}

    dispatch = grouped_dispatch_plan(gate_idx, n_experts=e, block_m=block_m)
    xs = grouped_permute(xt, dispatch, compute_dtype)
    gids = dispatch.block_experts
    local = gids if mesh is None else kops.expert_parallel_ids(
        gids, mesh, params["w_up"].shape[-3])

    def gm(rows: Tensor, name: str, ids: Tensor, **kw) -> Tensor:
        sc = params.get(name + "_scale")
        w = params[name] if sc is not None else \
            params[name].to(compute_dtype)
        return kops.grouped_matmul(rows, w, ids, w_scale=sc, impl=impl,
                                   **kw)

    up = gm(xs, "w_up", local)
    h = swiglu(gm(xs, "w_gate", local), up) if cfg.mlp_act == "swiglu" \
        else gelu(up)
    down = gm(h.to(compute_dtype), "w_down", gids, mesh=mesh, n_experts=e)
    return (grouped_combine(down, dispatch, gate_w, t, k).reshape(b, s, d),
            aux)


# ---------------------------------------------------------------------------
# Capacity dispatch (GShard) + the public entry point
# ---------------------------------------------------------------------------


def moe_ffn(params: Dict[str, Tensor], x: Tensor, cfg: ModelConfig,
            compute_dtype: torch.dtype,
            chunk_tokens: int = MOE_CHUNK_TOKENS,
            dropless: bool = False,
            dispatch: str = "capacity",
            impl: str = "ref",
            block_m: int = GROUPED_BLOCK_M,
            with_aux: bool = True,
            mesh=None
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x: (B, S, D) -> (out, aux_losses); aux_losses is empty with
    ``with_aux=False``.

    ``dispatch="grouped"``: the sort-based dropless serving path through
    the grouped GEMM (``impl`` "cuda" or "ref"). ``dispatch="capacity"``:
    the GShard buffer, un-droppable with ``dropless=True``. Token counts
    above ``chunk_tokens`` run in sequence chunks, as the reference's
    scan. ``mesh`` (a serving mesh whose "data" axis splits the experts)
    turns on expert parallelism in the grouped dispatch."""
    b, s, d = x.shape
    if dispatch == "grouped":
        def flat(xi):
            return _moe_ffn_grouped(params, xi, cfg, compute_dtype, impl,
                                    block_m, with_aux, mesh)
    elif dispatch == "capacity":
        def flat(xi):
            return _moe_ffn_flat(params, xi, cfg, compute_dtype, dropless,
                                 with_aux)
    else:
        raise ValueError(f"unknown MoE dispatch {dispatch!r}")
    if b * s > chunk_tokens and (b * s) % chunk_tokens == 0 and \
            s % (b * s // chunk_tokens) == 0:
        n_chunks = b * s // chunk_tokens
        sc = s // n_chunks
        outs, auxs = [], []
        for c in range(n_chunks):
            out, aux = flat(x[:, c * sc:(c + 1) * sc])
            outs.append(out)
            auxs.append(aux)
        aux = {name: torch.stack([a[name] for a in auxs]).mean(0)
               for name in auxs[0]}
        return torch.cat(outs, dim=1), aux
    return flat(x)


def _moe_ffn_flat(params: Dict[str, Tensor], x: Tensor, cfg: ModelConfig,
                  compute_dtype: torch.dtype, dropless: bool = False,
                  with_aux: bool = True) -> Tuple[Tensor, Dict[str, Tensor]]:
    b, s, d = x.shape
    t = b * s
    k, e = cfg.experts_per_token, cfg.n_experts
    xt = x.reshape(t, d)
    dev = x.device
    logits, probs, gate_w, gate_idx = _route(params, xt, compute_dtype, k)

    # an expert receives at most one assignment per token, so capacity = t
    # can never drop
    cap = t if dropless else capacity(t, cfg)
    # priority order: all top-1 assignments, then top-2, ... (GShard)
    flat_idx = gate_idx.T.reshape(-1).long()  # (k*T,)
    onehot = F.one_hot(flat_idx, e).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) - 1
    pos_in_e = pos.gather(1, flat_idx[:, None])[:, 0]
    keep = pos_in_e < cap
    slot = torch.clamp(pos_in_e, max=cap - 1)  # dropped rows add zeros

    zero = torch.zeros((), dtype=compute_dtype, device=dev)
    xk = xt[None].expand(k, t, d).reshape(k * t, d).to(compute_dtype)
    xk = torch.where(keep[:, None], xk, zero)
    dispatched = torch.zeros((e, cap, d), dtype=compute_dtype, device=dev)
    dispatched.index_put_((flat_idx, slot), xk, accumulate=True)

    up = torch.einsum("ecd,edf->ecf", dispatched,
                      _weight(params, "w_up", compute_dtype))
    if cfg.mlp_act == "swiglu":
        gate = torch.einsum("ecd,edf->ecf", dispatched,
                            _weight(params, "w_gate", compute_dtype))
        h = swiglu(gate, up)
    else:
        h = gelu(up)
    down = torch.einsum("ecf,efd->ecd", h,
                        _weight(params, "w_down", compute_dtype))

    gathered = torch.where(keep[:, None], down[flat_idx, slot], zero)
    weights = (gate_w.T.reshape(-1) * keep).to(compute_dtype)  # (kT,)
    out = (gathered * weights[:, None]).reshape(k, t, d).sum(dim=0)
    aux = _aux_losses(logits, probs, gate_idx, t, k, e) if with_aux else {}
    return out.reshape(b, s, d), aux


def dense_ffn(params: Dict[str, Tensor], x: Tensor, cfg: ModelConfig,
              compute_dtype: torch.dtype) -> Tensor:
    up = x @ params["w_up"].to(compute_dtype)
    if cfg.mlp_act == "swiglu":
        h = swiglu(x @ params["w_gate"].to(compute_dtype), up)
    else:
        h = gelu(up)
    return h @ params["w_down"].to(compute_dtype)


def dense_ffn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    specs = {
        "w_up": ParamSpec((d, f), ("embed", "mlp")),
        "w_down": ParamSpec((f, d), ("mlp", "embed")),
    }
    if cfg.mlp_act == "swiglu":
        specs["w_gate"] = ParamSpec((d, f), ("embed", "mlp"))
    return specs
