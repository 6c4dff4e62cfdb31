"""m-grouped MoE GEMM on Hopper: wrapper of the CUDA kernel in
``csrc/grouped_gemm.cu`` and its plain-torch version.

Port of ``repro/kernels/moe_gemm.py::grouped_matmul`` (the Pallas kernel
of the sort-based dropless MoE dispatch). A wrapper given CPU tensors
computes the plain version (``ref.grouped_matmul_ref``); given CUDA
tensors it launches the kernel or raises. Each launch adds one to
``launches["grouped_matmul"]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import load

SOURCE = "grouped_gemm.cu"
launches: Dict[str, int] = {"grouped_matmul": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    lib = load(SOURCE)
    if lib.grouped_matmul.argtypes is None:
        lib.grouped_matmul.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
            + [ctypes.c_void_p])
        lib.grouped_matmul.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, w: torch.Tensor, group_ids: torch.Tensor,
           w_scale: Optional[torch.Tensor]) -> None:
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"kernel needs CUDA tensors, got x on {dev}")
    named = {"x": x, "w": w, "group_ids": group_ids}
    if w_scale is not None:
        named["w_scale"] = w_scale
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"contraction mismatch {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x dtype {x.dtype} not in (float32, bfloat16)")
    if w.dtype not in (x.dtype, torch.int8):
        raise ValueError(f"w dtype {w.dtype}: want {x.dtype} or int8")
    if group_ids.dtype != torch.int32 or group_ids.dim() != 1:
        raise ValueError(f"group_ids {group_ids.dtype} "
                         f"{tuple(group_ids.shape)}, want int32 (nb,)")
    nb = group_ids.shape[0]
    if nb == 0 or x.shape[0] % nb:
        raise ValueError(f"M={x.shape[0]} not divisible into {nb} m-tiles")
    if w_scale is not None and (w_scale.dtype != torch.float32
                                or w_scale.shape != (w.shape[0],)):
        raise ValueError(f"w_scale {w_scale.dtype} {tuple(w_scale.shape)},"
                         f" want float32 ({w.shape[0]},)")


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   group_ids: torch.Tensor, *,
                   w_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (M, D) expert-sorted, block-padded rows (f32 or bf16); w:
    (E, D, F) in x's dtype or int8; group_ids (M // block_m,) int32
    expert id per m-tile (-1: the tile's rows are zeros); ``w_scale``
    (E,) f32 multiplies each expert's f32 product. Returns (M, F) in x's
    dtype."""
    if x.device.type == "cpu":
        return ref.grouped_matmul_ref(x, w, group_ids, w_scale=w_scale)
    _check(x, w, group_ids, w_scale)
    m, d = x.shape
    e, _, f = w.shape
    out = torch.empty((m, f), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().grouped_matmul(
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], x.data_ptr(),
        w.data_ptr(), group_ids.data_ptr(),
        None if w_scale is None else w_scale.data_ptr(), out.data_ptr(),
        m, d, e, f, group_ids.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"grouped_matmul kernel launch failed: "
                           f"cudaError {rc}")
    launches["grouped_matmul"] += 1
    return out
