"""Plain-torch twins of the matmul, flash-attention, dense ring decode,
paged-attention, grouped-GEMM, RWKV-6 WKV and embedding-bag oracles in
``repro/kernels/ref.py`` (the correctness contract of the CUDA kernels).

They materialize what the kernels never do: the (S_q, S_k) score matrix,
each request's contiguous KV view, gathered (and dequantized) from the
page pool, each expert's weights in f32 and every bag's (bag, D) rows;
the WKV oracle walks the recurrence one token at a time. ``row_steps``
and ``FLASH_ROW_C`` are the row-by-row limit that bf16 attention kernels
are held to against these oracles.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
# bf16 attention outputs are held, besides an absolute tolerance, row by
# row: |got - want| <= FLASH_ROW_C bf16 steps (2^-8) of the row's largest
# |want|. Most rows average hundreds of keys to |out| ~ 0.05, where the
# absolute tolerance alone is loose; a kernel run with its window off by
# one key fails this limit.
BF16_STEP = 2.0 ** -8
FLASH_ROW_C = 4.0


def row_steps(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in bf16 steps of its row's largest |want|."""
    err = (got.float() - want.float()).abs()
    scale = want.float().abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    return float((err / scale).max()) / BF16_STEP


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """An fp32 dot of the inputs' values, cast to ``out_dtype`` (default
    a's dtype)."""
    return (a.float() @ b.float()).to(out_dtype or a.dtype)


def check_lengths(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: Optional[int]) -> None:
    """q (BH, S_q, D), k and v (BH, S_k, D); S_k != S_q only for
    bidirectional attention without a window."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (BH, S_q, D) and two "
                         f"(BH, S_k, D)")
    if k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} in BH or D")
    if k.shape[1] != q.shape[1] and (causal or window is not None):
        raise ValueError(f"S_k {k.shape[1]} != S_q {q.shape[1]}: causal and "
                         f"windowed attention need one sequence")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (BH, S_q, D); k, v: (BH, S_k, D). The full (S_q, S_k) softmax in
    fp32; masks compare query position i with key position j."""
    check_lengths(q, k, v, causal=causal, window=window)
    s, d = q.shape[1], q.shape[2]
    sk = k.shape[1]
    dev = q.device
    scores = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (d ** -0.5)
    qpos = torch.arange(s, device=dev)[:, None]
    kpos = torch.arange(sk, device=dev)[None, :]
    allowed = torch.ones((s, sk), dtype=torch.bool, device=dev)
    if causal:
        allowed &= qpos >= kpos
    if window is not None:
        allowed &= (qpos - kpos) < window
    scores = torch.where(allowed, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bqk,bkd->bqd", probs, v.float()).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos: torch.Tensor, *,
                         window: Optional[int] = None) -> torch.Tensor:
    """q: (B,H,D); caches (B,W,KV,D); pos: (B,). Ring-buffer aware."""
    b, h, d = q.shape
    w, kv = k_cache.shape[1], k_cache.shape[2]
    groups = h // kv
    dev = q.device
    p = pos[:, None].long()
    slot = torch.arange(w, device=dev)[None, :]
    wraps = torch.clamp(p - 1 - slot, min=0) // w
    abs_pos = slot + wraps * w
    valid = abs_pos < p
    if window is not None:
        valid &= abs_pos >= p - window
    kf = k_cache.repeat_interleave(groups, dim=2).float()
    vf = v_cache.repeat_interleave(groups, dim=2).float()
    scores = torch.einsum("bhd,bshd->bhs", q.float(), kf) * (d ** -0.5)
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bshd->bhd", probs, vf).to(q.dtype)


def decode_span_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, pos: torch.Tensor, *,
                              window: Optional[int] = None) -> torch.Tensor:
    """q: (B,T,H,D); caches (B,S,KV,D) at absolute slots; pos (B,) valid
    count BEFORE the span: query t sits at pos + t and sees slots up to
    its own position. Returns (B,T,H,D)."""
    t, h, d = q.shape[1], q.shape[2], q.shape[3]
    s, kv = k_cache.shape[1], k_cache.shape[2]
    groups = h // kv
    dev = q.device
    qpos = pos[:, None].long() + torch.arange(t, device=dev)[None, :]
    spos = torch.arange(s, device=dev)[None, None, :]
    valid = spos <= qpos[..., None]
    if window is not None:
        valid &= spos > qpos[..., None] - window
    kf = k_cache.repeat_interleave(groups, dim=2).float()
    vf = v_cache.repeat_interleave(groups, dim=2).float()
    scores = torch.einsum("bthd,bshd->bhts", q.float(), kf) * (d ** -0.5)
    scores = torch.where(valid[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs, vf).to(q.dtype)


def paged_gather_dequant_ref(pages: torch.Tensor, page_table: torch.Tensor,
                             scale: Optional[torch.Tensor],
                             dtype: torch.dtype) -> torch.Tensor:
    """(N,P,KV,D) pages + (B,M) table -> (B, M*P, KV, D) in ``dtype``;
    ``scale`` (N,P,KV) dequantizes int8 pages."""
    _, p, kv, d = pages.shape
    b, m = page_table.shape
    tab = page_table.long()
    g = pages[tab]  # (B, M, P, KV, D)
    if scale is not None:
        g = g.float() * scale[tab][..., None].float()
    return g.to(dtype).reshape(b, m * p, kv, d)


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       group_ids: torch.Tensor, *,
                       w_scale: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Segment-matmul oracle of the m-grouped MoE GEMM.

    x: (M, D) sorted+padded token rows; w: (E, D, F); group_ids
    (M // block_m,) expert id per m-tile (-1 = pad-only tile -> zeros).
    Computes in f32 and returns x's dtype; ``w_scale`` (E,) multiplies
    the f32 product after the dot. Ids past the last expert clamp to it,
    as the reference's gather does. The reference gathers one (D, F)
    weight per tile; this twin runs one product per expert over that
    expert's rows instead, so it never holds more than one expert's
    weights in f32."""
    m = x.shape[0]
    e, _, f = w.shape
    nb = group_ids.shape[0]
    row_e = group_ids.long().repeat_interleave(m // nb)
    xf = x.float()
    out = torch.zeros((m, f), dtype=torch.float32, device=x.device)
    for g in torch.unique(group_ids).tolist():
        if g < 0:
            continue
        rows = torch.nonzero(row_e == g).squeeze(1)
        ge = min(g, e - 1)
        acc = xf[rows] @ w[ge].float()
        if w_scale is not None:
            acc = acc * w_scale[ge].float()
        out[rows] = acc
    return out.to(x.dtype)


def rwkv_wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 logw: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Token-serial RWKV-6 WKV recurrence (the definitional oracle).

    r, k, v, logw: (BH, S, hd) f32, logw the per-step log decay; u:
    (BH, hd) the current-token bonus. From a zero (hd, hd) state,
    out_t = r_t (S + diag(u) k_t^T v_t), then S <- diag(exp(logw_t)) S +
    k_t^T v_t. Returns (BH, S, hd)."""
    bh, s, hd = r.shape
    state = torch.zeros((bh, hd, hd), dtype=r.dtype, device=r.device)
    outs = []
    for t in range(s):
        kv = k[:, t, :, None] * v[:, t, None, :]  # (BH, hd_k, hd_v)
        outs.append(torch.einsum("bk,bkv->bv", r[:, t],
                                 state + u[:, :, None] * kv))
        state = torch.exp(logw[:, t])[:, :, None] * state + kv
    return torch.stack(outs, dim=1)


def sparse_gather_sum_ref(table: torch.Tensor, indices: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """Embedding bag: (V, D) table, (N, bag) indices and weights ->
    (N, D) in the table's dtype, the weighted sum in f32. ``table[idx]``
    in jnp wraps a negative index once and clamps the result to
    [0, V-1], where torch's indexing raises, so the rows are normalised
    first."""
    v = table.shape[0]
    idx = indices.long()
    idx = torch.where(idx < 0, idx + v, idx).clamp(0, v - 1)
    rows = table[idx].float()  # (N, bag, D)
    out = torch.einsum("nbd,nb->nd", rows, weights.float())
    return out.to(table.dtype)
