"""Tiled matrix product on Hopper: wrapper of the CUDA kernel in
``csrc/matmul.cu`` and its plain-torch version.

Port of ``repro/kernels/matmul.py::matmul`` (the Pallas MXU-tiled kernel
that the serving startup self-test screens). A wrapper given CPU tensors
computes the plain version (``ref.matmul_ref``); given CUDA tensors it
launches the kernel or raises. Each launch adds one to
``launches["matmul"]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import load

SOURCE = "matmul.cu"
launches: Dict[str, int] = {"matmul": 0}
# the kernel's K tile per input dtype (a block sums K in tiles of this size)
K_TILE = {torch.float32: 16, torch.bfloat16: 32}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    lib = load(SOURCE)
    if lib.matmul.argtypes is None:
        lib.matmul.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                               + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.matmul.restype = ctypes.c_int
    return lib


def _check(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> None:
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"kernel needs CUDA tensors, got a on {dev}")
    if b.device != dev:
        raise ValueError(f"b on {b.device}, a on {dev}")
    for name, t in (("a", a), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError(f"dtypes {a.dtype} @ {b.dtype}: want one of "
                         f"(float32, bfloat16) for both")
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"out_dtype {out_dtype} not in (float32, bfloat16)")
    if max(*a.shape, b.shape[1]) >= 2 ** 31:
        raise ValueError(f"shape {tuple(a.shape)} @ {tuple(b.shape)}: "
                         f"dimensions must fit an int32")


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a: (M, K), b: (K, N), both f32 or both bf16, any M, N, K. Products
    and sums in fp32 (never TF32), cast once to ``out_dtype`` (f32 or
    bf16; default a's dtype). Returns (M, N)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.device.type == "cpu":
        return ref.matmul_ref(a, b, out_dtype)
    out_dtype = out_dtype or a.dtype
    _check(a, b, out_dtype)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = _lib().matmul(_DTYPE_CODE[a.dtype], _DTYPE_CODE[out_dtype],
                       a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                       stream)
    if rc != 0:
        raise RuntimeError(f"matmul kernel launch failed: cudaError {rc}")
    launches["matmul"] += 1
    return out
