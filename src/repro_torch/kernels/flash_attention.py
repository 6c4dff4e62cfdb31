"""Flash attention (forward) on Hopper: wrapper of the CUDA kernel in
``csrc/flash_attention.cu`` and its plain-torch version.

Port of ``repro/kernels/flash_attention.py::flash_attention`` (the Pallas
training/prefill kernel). q is (BH, S_q, D) and k, v are (BH, S_k, D);
S_k may differ from S_q only for bidirectional attention (an
encoder-decoder's cross-attention): causal and windowed masks compare a
query's position with a key's in one sequence. A wrapper given CPU tensors
computes the plain version; given CUDA tensors it launches the kernel or
raises. Each launch adds one to ``launches["flash_attention"]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.ref import check_lengths

SOURCE = "flash_attention.cu"
NEG_INF = -1e30
launches: Dict[str, int] = {"flash_attention": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    lib = load(SOURCE)
    if lib.flash_attention.argtypes is None:
        lib.flash_attention.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention.restype = ctypes.c_int
    return lib


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
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().flash_attention(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), bh, s, sk, sk - int(drop_last_key), d, int(causal),
        0 if window is None else int(window), float(d ** -0.5), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc}")
    launches["flash_attention"] += 1
    return out
