"""Tiled matrix product on Hopper: wrapper of the CUDA kernel in
``csrc/matmul.cu`` and its plain-torch version.

Port of ``repro/kernels/matmul.py::matmul`` (the Pallas MXU-tiled kernel
that the serving startup self-test screens). A wrapper given CPU tensors
computes the plain version (``ref.matmul_ref``); given CUDA tensors it
launches the kernel or raises. Each launch adds one to
``launches["matmul"]``.

The bf16 body loads its operands by TMA, which needs rows of a whole
number of 16 bytes: ``tma_operand`` gives it a zero-padded copy of an
operand whose rows are not (zeros add exactly nothing to a sum), and the
operand itself otherwise. ``tile_walk`` is the order in which its
persistent blocks visit the output tiles.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.build import load

SOURCE = "matmul.cu"
launches: Dict[str, int] = {"matmul": 0}
# the kernel's K tile per input dtype (a block sums K in tiles of this size)
K_TILE = {torch.float32: 16, torch.bfloat16: 64}
# the bf16 body's (tile rows, tile columns, K tile, ring stages, tile rows
# of a raster group); csrc/matmul.cu's matmul_bf16_tile reports the same
BF16_TILE = (128, 256, 64, 4, 8)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    lib = load(SOURCE)
    if lib.matmul.argtypes is None:
        lib.matmul.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                               + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.matmul.restype = ctypes.c_int
        lib.matmul_bf16_tile.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.matmul_bf16_tile.restype = None
    return lib


def bf16_tile() -> Tuple[int, ...]:
    """The built kernel's (tile rows, tile columns, K tile, stages, group
    rows, shared-memory bytes a block): BF16_TILE plus the bytes."""
    out = (ctypes.c_int * 6)()
    _lib().matmul_bf16_tile(out)
    return tuple(out)


def tma_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` (rows, cols, contiguous) itself when its rows are whole 16-byte
    chunks on a 16-byte-aligned base, as the bf16 body's TMA loads need;
    else a copy with zero columns appended up to a multiple of 8."""
    cols = x.shape[1]
    if cols % 8 == 0 and x.data_ptr() % 16 == 0:
        return x
    return F.pad(x, (0, -cols % 8)).contiguous()


def tile_walk(m: int, n: int, num_sms: int) -> List[List[Tuple[int, int]]]:
    """The (tile row, tile column) pairs that each persistent block of the
    bf16 body visits, in order: one block an SM (at most one a tile), block
    i taking walk positions i, i + blocks, ...; the walk goes down groups
    of GROUP tile rows, column by column (csrc/matmul.cu::tile_coords)."""
    bm, bn, _, _, group = BF16_TILE
    tiles_m, tiles_n = -(-m // bm), -(-n // bn)
    tiles = tiles_m * tiles_n
    blocks = min(tiles, num_sms)

    def coords(t: int) -> Tuple[int, int]:
        per_group = group * tiles_n
        first = t // per_group * group
        rows = min(tiles_m - first, group)
        r = t % per_group
        return first + r % rows, r // rows

    return [[coords(t) for t in range(i, tiles, blocks)]
            for i in range(blocks)]


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
    bf16; default a's dtype). Returns (M, N). bf16 operands whose rows are
    not whole 16-byte chunks are padded (``tma_operand``)."""
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
    if a.dtype == torch.bfloat16:
        a, b = tma_operand(a), tma_operand(b)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = _lib().matmul(_DTYPE_CODE[a.dtype], _DTYPE_CODE[out_dtype],
                       a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                       a.shape[1], b.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"matmul kernel launch failed: cudaError {rc}")
    launches["matmul"] += 1
    return out
