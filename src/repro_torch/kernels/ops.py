"""Public kernel entry points with an implementation switch
(``repro/kernels/ops.py``): the tiled matmul, flash attention, dense ring
decode attention, paged attention, the m-grouped MoE GEMM, the chunked
RWKV-6 WKV and the embedding bag.

``impl="cuda"`` launches the hand-written Hopper kernel and needs CUDA
tensors; ``impl="ref"`` runs the plain-torch oracle (an f32 dot; the full
softmax; the ring-masked softmax; gather the pages, then attend; one f32
product per expert; the chunked WKV; gather the bags' rows, then an f32
weighted sum) on any device.
Model code picks the impl through ``ModelContext.attn_impl`` (and
``moe_impl``).

On a serving (data, model) mesh the kernels stay per rank and unchanged.
``paged_partition`` is the reference's static plan of the paged
attention's split: query heads over "model", the KV pool sharded with
them when the KV heads divide the axis, else (the GQA fallback) each rank
keeps the group-aligned block of KV heads its query heads read
(``local_kv_block``), and an irregular split replicates the heads. The
caller hands the kernel the rank's heads and its contiguous pool, never a
strided view of the full one. ``grouped_matmul(mesh=...)`` is the
expert-parallel GEMM over the "data" axis: each rank holds a contiguous
block of experts, remaps the tile ids into it (-1 elsewhere, whose rows
the kernel zeroes) and a sum over the axis restores the full output.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import decode_attention as _kernels
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import matmul as _matmul
from repro_torch.kernels import moe_gemm as _moe_gemm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rwkv_scan as _rwkv
from repro_torch.kernels import sparse_gather as _gather

IMPLS = ("cuda", "ref")


def paged_partition(mesh, data_axis: str, model_axis: str, b: int, h: int,
                    kv: int):
    """The reference's ``_paged_partition``: a static plan for splitting
    paged attention over a (data, model) mesh (anything
    ``sharding.axes.axis_sizes`` reads). Returns (data_spec_axis,
    head_spec_axis, kv_spec_axis, slice_kv, model_size); ``slice_kv``
    marks the GQA fallback where each rank keeps the KV-head block its
    query heads map to."""
    from repro_torch.sharding.axes import axis_sizes
    sizes = axis_sizes(mesh)
    d = sizes.get(data_axis, 1)
    m = sizes.get(model_axis, 1)
    db = data_axis if (d > 1 and b % d == 0) else None
    hm = model_axis if (m > 1 and h % m == 0) else None
    kvm = None
    slice_kv = False
    if hm is not None:
        if kv % m == 0:
            kvm = model_axis  # KV pool shards with the Q heads (true TP)
        else:
            h_local, g = h // m, h // kv
            if h_local % g == 0 or g % h_local == 0:
                slice_kv = True  # group-aligned block of the KV heads
            else:
                hm = None  # irregular group split: replicate heads too
    return db, hm, kvm, slice_kv, m


def local_kv_block(h: int, kv: int, m: int, idx: int) -> Tuple[int, int]:
    """(first KV head, KV heads) that rank ``idx`` of ``m`` along the
    model axis reads, as the reference's ``_local_kv_slice`` slices them:
    local query head j then reads local KV head j // (h_local // kv_local),
    the global GQA grouping, because the head block is group-aligned."""
    h_local, g = h // m, h // kv
    return (idx * h_local) // g, max(1, h_local // g)


def local_group_ids(group_ids: torch.Tensor, lo: int,
                    e_local: int) -> torch.Tensor:
    """Global expert id per m-tile -> the id within the block of experts
    ``lo .. lo + e_local - 1``, and -1 (a zero tile) outside it."""
    g = group_ids - lo
    return torch.where((g >= 0) & (g < e_local), g, -1).to(group_ids.dtype)


def expert_parallel_ids(group_ids: torch.Tensor, mesh, e_local: int,
                        expert_axis: str = "data") -> torch.Tensor:
    """``local_group_ids`` for this rank of ``mesh``: its block of
    ``e_local`` experts is the one at its place along ``expert_axis``."""
    lo = mesh.get_local_rank(expert_axis) * e_local
    return local_group_ids(group_ids, lo, e_local)


def _cuda_only(q: torch.Tensor, impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "cuda" and not q.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; use impl='ref' "
                         "on the CPU")


def matmul(a: torch.Tensor, b: torch.Tensor, *, impl: str = "cuda",
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M, K) @ (K, N) with fp32 products and sums, cast to ``out_dtype``
    (default a's dtype)."""
    _cuda_only(a, impl)
    if impl == "ref":
        return _ref.matmul_ref(a, b, out_dtype)
    return _matmul.matmul(a, b, out_dtype=out_dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    impl: str = "cuda", causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (BH, S_q, D), k, v (BH, S_k, D): causal, windowed or
    bidirectional attention; S_k != S_q only when bidirectional."""
    _cuda_only(q, impl)
    if impl == "ref":
        return _ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window)
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     impl: str = "cuda",
                     window: Optional[int] = None) -> torch.Tensor:
    """q: (B,H,D); ring caches (B,W,KV,D); pos (B,) int32 valid count.
    Returns (B,H,D)."""
    _cuda_only(q, impl)
    if impl == "ref":
        return _kernels.decode_attention_plain(q, k_cache, v_cache, pos,
                                               window=window)
    return _kernels.decode_attention(q, k_cache, v_cache, pos,
                                     window=window)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           pos: torch.Tensor, *,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           impl: str = "cuda",
                           window: Optional[int] = None) -> torch.Tensor:
    """q: (B,H,D); pages (N,P,KV,D); page_table (B,M); pos (B,) valid
    count. int8 pages come with (N,P,KV) bf16 ``k_scale``/``v_scale``.
    "ref" gathers (and dequantizes) the pages and reuses the dense ring
    oracle: no wraps, since every position is < M*P. Returns (B,H,D)."""
    _cuda_only(q, impl)
    if impl == "ref":
        return _kernels.paged_decode_attention_plain(
            q, k_pages, v_pages, page_table, pos, k_scale=k_scale,
            v_scale=v_scale, window=window)
    return _kernels.paged_decode_attention(
        q, k_pages, v_pages, page_table, pos, k_scale=k_scale,
        v_scale=v_scale, window=window)


def paged_decode_span_attention(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                page_table: torch.Tensor, pos: torch.Tensor,
                                *, k_scale: Optional[torch.Tensor] = None,
                                v_scale: Optional[torch.Tensor] = None,
                                impl: str = "cuda",
                                window: Optional[int] = None
                                ) -> torch.Tensor:
    """q: (B,T,H,D) at positions pos .. pos+T-1; pos (B,) valid count
    BEFORE the span. Other args as ``paged_decode_attention``.
    Returns (B,T,H,D)."""
    _cuda_only(q, impl)
    if impl == "ref":
        return _kernels.paged_decode_span_attention_plain(
            q, k_pages, v_pages, page_table, pos, k_scale=k_scale,
            v_scale=v_scale, window=window)
    return _kernels.paged_decode_span_attention(
        q, k_pages, v_pages, page_table, pos, k_scale=k_scale,
        v_scale=v_scale, window=window)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, group_ids: torch.Tensor,
                   *, w_scale: Optional[torch.Tensor] = None,
                   impl: str = "cuda", mesh=None, expert_axis: str = "data",
                   n_experts: Optional[int] = None) -> torch.Tensor:
    """m-grouped contiguous GEMM over expert-sorted token rows.

    x: (M, D) sorted+padded rows; w: (E, D, F); group_ids (M // block_m,)
    int32 expert id per m-tile (-1 = pad tile -> zero rows). ``w_scale``
    (E,) dequantizes int8 expert weights after the f32 product.

    ``mesh`` (a DeviceMesh, or a {axis: size} mapping whose
    ``expert_axis`` has size 1): expert parallelism over ``expert_axis``.
    ``w`` (and ``w_scale``) then hold this rank's contiguous block of the
    ``n_experts`` experts, or all of them where they do not divide the
    axis (replicated, as the rules leave them); ``group_ids`` are global.
    Each rank remaps the ids into its block (``expert_parallel_ids``),
    the kernel zeroes every other tile, and one sum over the axis gives
    every rank the full (M, F). The MoE layer runs its up and gate
    products on the remapped ids alone and this sum once, on the down
    product (models/moe.py)."""
    _cuda_only(x, impl)

    def local(ids: torch.Tensor) -> torch.Tensor:
        if impl == "ref":
            return _ref.grouped_matmul_ref(x, w, ids, w_scale=w_scale)
        return _moe_gemm.grouped_matmul(x, w, ids, w_scale=w_scale)

    if mesh is None:
        return local(group_ids)
    from repro_torch.sharding.axes import axis_sizes
    from repro_torch.sharding.comm import all_reduce_sum
    ep = axis_sizes(mesh).get(expert_axis, 1)
    e_total = w.shape[0] * ep if n_experts is None else n_experts
    if e_total == w.shape[0] or ep == 1:
        return local(group_ids)  # experts replicated over the axis
    if e_total != w.shape[0] * ep:
        raise ValueError(f"{w.shape[0]} experts a rank do not split "
                         f"{e_total} over {expert_axis}={ep}")
    out = local(expert_parallel_ids(group_ids, mesh, w.shape[0],
                                    expert_axis))
    return all_reduce_sum(out, mesh.get_group(expert_axis))


def rwkv_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor,
             s0: Optional[torch.Tensor] = None, *, chunk: int,
             impl: str = "cuda", state_out: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked RWKV-6 WKV. r, k, v, logw: (B,S,H,hd) f32, logw clamped to
    [-4, 0]; u: (H, hd); s0: (B,H,hd,hd) initial state (None: zeros);
    1 <= chunk <= 16 dividing S. ``state_out`` takes the final state and
    may be s0 itself. Returns (out (B,S,H,hd), final state).

    "ref" is differentiated by autograd through the plain version, as the
    reference differentiates ``_chunked_wkv``. "cuda" on inputs that need
    a gradient runs ``rwkv_scan.WkvFunction``: the forward kernel, then
    the backward kernel; it refuses ``state_out``, an in-place write that
    autograd cannot follow."""
    _cuda_only(r, impl)
    if impl == "ref":
        return _rwkv.rwkv_wkv_plain(r, k, v, logw, u, s0, chunk=chunk,
                                    state_out=state_out)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, logw, u,
                                                        s0)):
        if state_out is not None:
            raise ValueError("state_out is written in place: not with "
                             "inputs that need a gradient")
        return _rwkv.WkvFunction.apply(r, k, v, logw, u, s0, chunk)
    return _rwkv.rwkv_wkv(r, k, v, logw, u, s0, chunk=chunk,
                          state_out=state_out)


def sparse_gather_sum(table: torch.Tensor, indices: torch.Tensor,
                      weights: torch.Tensor, *, impl: str = "cuda"
                      ) -> torch.Tensor:
    """Embedding bag: out[i] = sum_j weights[i,j] * table[indices[i,j]].
    table (V, D) f32/bf16; indices (N, bag) int32; weights (N, bag) f32.
    Returns (N, D) in the table's dtype."""
    _cuda_only(table, impl)
    if impl == "ref":
        return _ref.sparse_gather_sum_ref(table, indices, weights)
    return _gather.sparse_gather_sum(table, indices, weights)
