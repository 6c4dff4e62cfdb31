"""Embedding bag on Hopper: wrapper of the CUDA kernel in
``csrc/sparse_gather.cu`` and its plain-torch version.

Port of ``repro/kernels/sparse_gather.py::sparse_gather_sum`` (the Pallas
SparseCore-style gather): ``out[i] = sum_j w[i,j] * table[idx[i,j]]``,
products and sums in f32, the result in the table's dtype. Indices follow
JAX's gather: a negative index wraps once, then clamps to [0, V-1].

A wrapper given CPU tensors computes the plain version; given CUDA tensors
it launches the kernel or raises. Each launch adds one to
``launches["sparse_gather_sum"]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels.build import load

SOURCE = "sparse_gather.cu"
launches: Dict[str, int] = {"sparse_gather_sum": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

Tensor = torch.Tensor


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    lib = load(SOURCE)
    if lib.sparse_gather_sum.argtypes is None:
        lib.sparse_gather_sum.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
            + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.sparse_gather_sum.restype = ctypes.c_int
    return lib


def wrap_negative(indices: Tensor, v: int) -> Tensor:
    """Each index as int64 with a negative one wrapped once (``idx + v``),
    as JAX's gather and its gradient read it; the result may still lie
    outside [0, v)."""
    idx = indices.long()
    return torch.where(idx < 0, idx + v, idx)


def table_rows(indices: Tensor, v: int) -> Tensor:
    """The table row each index reads (int64): a negative index wraps
    once, then the result clamps to [0, v-1], as JAX's gather does."""
    return wrap_negative(indices, v).clamp(0, v - 1)


def _shapes(table: Tensor, indices: Tensor, weights: Tensor) -> None:
    if table.dim() != 2:
        raise ValueError(f"table {tuple(table.shape)}: want (V, D)")
    if indices.dim() != 2 or weights.shape != indices.shape:
        raise ValueError(f"indices {tuple(indices.shape)}, weights "
                         f"{tuple(weights.shape)}: want both (N, bag)")
    if table.shape[0] < 1:
        raise ValueError("table has no rows")


def sparse_gather_sum_plain(table: Tensor, indices: Tensor,
                            weights: Tensor) -> Tensor:
    """The kernel's arithmetic in plain torch: the bag walked in order,
    ``acc += w[:, j] * table[idx[:, j]]`` in f32, then one cast to the
    table's dtype."""
    _shapes(table, indices, weights)
    rows = table_rows(indices, table.shape[0])
    wf = weights.float()
    acc = torch.zeros((indices.shape[0], table.shape[1]),
                      dtype=torch.float32, device=table.device)
    for j in range(indices.shape[1]):
        acc += wf[:, j, None] * table[rows[:, j]].float()
    return acc.to(table.dtype)


def _check(table: Tensor, indices: Tensor, weights: Tensor) -> None:
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"kernel needs CUDA tensors, got table on {dev}")
    for name, t in (("indices", indices), ("weights", weights)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, table on {dev}")
    if table.dtype not in _DTYPE_CODE:
        raise ValueError(f"table dtype {table.dtype} not in (float32, "
                         f"bfloat16)")
    if indices.dtype != torch.int32:
        raise ValueError(f"indices dtype {indices.dtype}: the kernel takes "
                         f"int32")
    if weights.dtype != torch.float32:
        raise ValueError(f"weights dtype {weights.dtype}: the kernel takes "
                         f"float32")
    for name, t in (("table", table), ("indices", indices),
                    ("weights", weights)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, d = indices.shape[0], table.shape[1]
    if indices.numel() >= 2 ** 31 or n * d >= 2 ** 31:
        raise ValueError(f"indices {tuple(indices.shape)} x D {d}: too "
                         f"many elements")


def sparse_gather_sum(table: Tensor, indices: Tensor, weights: Tensor, *,
                      skip_last: bool = False) -> Tensor:
    """Embedding bag: table (V, D) f32 or bf16, indices (N, bag) int32,
    weights (N, bag) f32, all contiguous. Returns (N, D) in the table's
    dtype. ``skip_last`` drops bag position bag-1, a planted fault of the
    kernel for the checks."""
    _shapes(table, indices, weights)
    if table.device.type == "cpu":
        if skip_last:
            raise ValueError("skip_last is a fault of the CUDA kernel")
        return sparse_gather_sum_plain(table, indices, weights)
    _check(table, indices, weights)
    v, d = table.shape
    n, bag = indices.shape
    out = torch.empty((n, d), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(table.device).cuda_stream
    rc = _lib().sparse_gather_sum(
        _DTYPE_CODE[table.dtype], table.data_ptr(), indices.data_ptr(),
        weights.data_ptr(), out.data_ptr(), v, d, n, bag, int(skip_last),
        stream)
    if rc != 0:
        raise RuntimeError(f"sparse_gather_sum kernel launch failed: "
                           f"cudaError {rc}")
    launches["sparse_gather_sum"] += 1
    return out
