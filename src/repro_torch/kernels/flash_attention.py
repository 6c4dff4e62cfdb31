"""Flash attention (forward) on Hopper: wrapper of the CUDA kernel in
``csrc/flash_attention.cu`` and its plain-torch version.

Port of ``repro/kernels/flash_attention.py::flash_attention`` (the Pallas
training/prefill kernel). q is (BH, S_q, D) and k, v are (BH, S_k, D);
S_k may differ from S_q only for bidirectional attention (an
encoder-decoder's cross-attention): causal and windowed masks compare a
query's position with a key's in one sequence. A wrapper given CPU tensors
computes the plain version; given CUDA tensors it launches the kernel or
raises. Each launch adds one to ``launches["flash_attention"]``.

bf16 calls follow a launch plan (``flash_plan``), a pure function of the
shape computed here on the host: the tile width, the keys and stages of the
shared-memory ring, and the key-range splits for short query blocks.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.ref import check_lengths

SOURCE = "flash_attention.cu"
NEG_INF = -1e30
launches: Dict[str, int] = {"flash_attention": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The bf16 body's tiles (csrc/flash_attention.cu, Tile<DP>): query rows of
# a work item, and per tile width DP the keys of a K or V tile, the stages
# of the ring and the Q tiles in flight. tests/test_torch_flash_kernel.py
# holds them against the build (``bf16_tile``).
BLOCK_ROWS = 128
TILES = {64: (128, 4, 2), 128: (64, 4, 2), 256: (64, 2, 1)}
SMEM_MAX = 232448  # an H100 block's opt-in maximum
H100_SMS = 132


class FlashPlan(NamedTuple):
    """How a bf16 call runs: ``d_pad`` the row width the kernel reads (D
    rounded up to a multiple of 8), ``d_tile`` the tile width, ``rows`` and
    ``keys`` the query rows of a work item and the keys of a tile,
    ``stages`` the ring's depth, ``splits`` the key-range splits,
    ``workspace`` the f32 shape of their partial (acc, m, l) or None,
    ``smem`` the shared-memory bytes of a block."""
    d_pad: int
    d_tile: int
    rows: int
    keys: int
    stages: int
    splits: int
    workspace: Optional[Tuple[int, int, int, int]]
    smem: int


@functools.lru_cache(maxsize=1024)
def flash_plan(bh: int, sq: int, sk: int, d: int, *, causal: bool,
               window: Optional[int], num_sms: int = H100_SMS) -> FlashPlan:
    """The bf16 launch plan of a call. Splits only when the work items
    (query tiles x BH) fill at most half the SMs: each item's key tiles are
    then cut into ``splits`` contiguous ranges, so that about ``num_sms``
    items run at once, with no range shorter than it must be. Raises
    ValueError where no plan fits."""
    if bh < 1 or sq < 1 or sk < 1 or not 1 <= d <= 256 or num_sms < 1:
        raise ValueError(f"no flash plan for BH={bh} S_q={sq} S_k={sk} "
                         f"D={d} on {num_sms} SMs")
    d_pad = -(-d // 8) * 8
    d_tile = next(t for t in sorted(TILES) if d_pad <= t)
    keys, stages, q_tiles = TILES[d_tile]
    smem = (1024 + q_tiles * BLOCK_ROWS * d_tile * 2
            + 2 * stages * keys * d_tile * 2 + (4 * stages + 2 * q_tiles) * 8)
    if smem > SMEM_MAX:
        raise ValueError(f"flash plan at D={d}: {smem} bytes of shared "
                         f"memory, above {SMEM_MAX}")
    items = -(-sq // BLOCK_ROWS) * bh  # work items before any split
    tiles = -(-sk // keys)  # the most key tiles an item may visit
    if window is not None:
        tiles = min(tiles, -(-(window + BLOCK_ROWS - 1) // keys) + 1)
    splits = 1
    if 2 * items <= num_sms and tiles > 1:
        per = -(-tiles // (num_sms // items))
        splits = -(-tiles // per)
    work = (splits, bh, sq, d_pad + 2) if splits > 1 else None
    return FlashPlan(d_pad, d_tile, BLOCK_ROWS, keys, stages, splits, work,
                     smem)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    lib = load(SOURCE)
    if lib.flash_attention.argtypes is None:
        lib.flash_attention.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_attention.restype = ctypes.c_int
        lib.flash_bf16_tile.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.flash_bf16_tile.restype = ctypes.c_int
        lib.flash_wgmma_probe.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 3
            + [ctypes.c_int, ctypes.c_void_p])
        lib.flash_wgmma_probe.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bf16_tile(d_tile: int) -> Tuple[int, int, int, int]:
    """(query rows, keys, stages, shared-memory bytes) of the built bf16
    body at tile width ``d_tile``: what ``flash_plan`` must agree with."""
    out = (ctypes.c_int * 4)()
    rc = _lib().flash_bf16_tile(d_tile, out)
    if rc != 0:
        raise ValueError(f"no bf16 tile of width {d_tile}")
    return tuple(out)


def wgmma_probe(mode: int, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The kernel's two products alone, one warpgroup, bf16 in, f32 out:
    mode 0 is x (64, K) @ y (64, K)^T (both operands through TMA into
    swizzled shared memory), mode 1 x (64, K) @ y (K, 64) (x in registers,
    y through the transposed descriptor); K a multiple of 16 up to 64."""
    for t in (x, y):
        if (t.device.type != "cuda" or t.dtype != torch.bfloat16
                or not t.is_contiguous()):
            raise ValueError("probe needs contiguous bf16 CUDA tensors")
    k = x.shape[1]
    want = (64, k) if mode == 0 else (k, 64)
    if x.shape != (64, k) or y.shape != want:
        raise ValueError(f"probe mode {mode}: x {tuple(x.shape)}, y "
                         f"{tuple(y.shape)}")
    out = torch.empty((64, 64), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().flash_wgmma_probe(mode, x.data_ptr(), y.data_ptr(),
                                  out.data_ptr(), k, stream)
    if rc != 0:
        raise RuntimeError(f"flash_wgmma_probe launch failed: cudaError {rc}")
    return out


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"kernel needs CUDA tensors, got q on {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype}, q {q.dtype}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {q.dtype} not in (float32, bfloat16)")
    if q.dim() != 3 or not 1 <= q.shape[2] <= 256 or q.shape[0] > 65535:
        raise ValueError(f"q {tuple(q.shape)}: want (BH <= 65535, S, "
                         f"D <= 256)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          block_k: int = 128) -> torch.Tensor:
    """The Pallas kernel's arithmetic in plain torch: every query row at
    once, key blocks of ``block_k`` in sequence with the online softmax's
    fp32 (m, l, acc); scores (q * scale) . k, masked entries -1e30, the
    probabilities cast to v's dtype before an fp32 PV product. k, v may
    hold S_k != S_q keys when the attention is bidirectional."""
    check_lengths(q, k, v, causal=causal, window=window)
    bh, s, d = q.shape
    sk = k.shape[1]
    dev = q.device
    qf = q.float() * d ** -0.5
    m = torch.full((bh, s), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((bh, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((bh, s, d), dtype=torch.float32, device=dev)
    qpos = torch.arange(s, device=dev)[:, None]
    bk = min(block_k, sk)
    for k0 in range(0, sk, bk):
        kb, vb = k[:, k0:k0 + bk], v[:, k0:k0 + bk]
        scores = qf @ kb.float().transpose(1, 2)
        kpos = torch.arange(k0, k0 + kb.shape[1], device=dev)[None, :]
        ok = torch.ones((s, kb.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            ok &= qpos >= kpos
        if window is not None:
            ok &= (qpos - kpos) < window
        scores = torch.where(ok, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = p.to(v.dtype).float() @ vb.float()
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    drop_last_key: bool = False) -> torch.Tensor:
    """q: (BH, S_q, D), k, v: (BH, S_k, D), contiguous, f32 or bf16, one
    dtype; causal, windowed (query - key < window) or bidirectional, and
    S_k == S_q unless bidirectional. Returns (BH, S_q, D) in q's dtype.
    ``drop_last_key`` tells the kernel S_k - 1 keys, a planted fault for
    the checks."""
    if q.device.type == "cpu":
        if drop_last_key:
            raise ValueError("drop_last_key is a fault of the CUDA kernel")
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    check_lengths(q, k, v, causal=causal, window=window)
    _check(q, k, v, window)
    bh, s, d = q.shape
    sk = k.shape[1]
    work, splits, width = None, 1, d
    if q.dtype == torch.bfloat16:
        plan = flash_plan(bh, s, sk, d, causal=causal, window=window,
                          num_sms=_num_sms(q.device.index))
        width, splits = plan.d_pad, plan.splits
        if width != d:  # TMA reads rows of 16-byte multiples: zero
            # columns up to d_pad add nothing to the scores or the output
            q, k, v = (torch.nn.functional.pad(t, (0, width - d))
                       for t in (q, k, v))
        elif any(t.data_ptr() % 16 for t in (q, k, v)):
            q, k, v = (t.clone() for t in (q, k, v))
        if plan.workspace is not None:
            work = torch.empty(plan.workspace, dtype=torch.float32,
                               device=q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().flash_attention(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), None if work is None else work.data_ptr(), bh, s,
        sk, sk - int(drop_last_key), width, int(causal),
        0 if window is None else int(window), float(d ** -0.5), splits, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc}")
    launches["flash_attention"] += 1
    return out if width == d else out[..., :d].contiguous()
