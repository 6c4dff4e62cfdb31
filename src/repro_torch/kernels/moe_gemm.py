"""m-grouped MoE GEMM on Hopper: wrapper of the CUDA kernel in
``csrc/grouped_gemm.cu`` and its plain-torch version.

Port of ``repro/kernels/moe_gemm.py::grouped_matmul`` (the Pallas kernel
of the sort-based dropless MoE dispatch). A wrapper given CPU tensors
computes the plain version (``ref.grouped_matmul_ref``); given CUDA
tensors it launches the kernel or raises. Each call adds one to
``launches["grouped_matmul"]``.

The launch plan is chosen here, on the host, from shapes alone
(``grouped_plan``): f32 activations take the CUDA-core body; bf16
activations take the stream body (weights streamed once per chunk of up
to 64 rows, K split over the blocks of a cluster) or, with bf16 weights
and enough rows an expert, the wgmma body (persistent 128 x 256 tiles).
The bf16 bodies load by TMA, which needs rows of whole 16-byte chunks:
``tma_rows`` gives them a zero-padded copy of ``x`` or ``w`` where the
rows are not (so such shapes copy ``w``). ``chunk_table``,
``stream_walk``, ``split_range`` and ``wgmma_walk`` mirror how the
kernel cuts the rows and walks its work.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.build import load

SOURCE = "grouped_gemm.cu"
launches: Dict[str, int] = {"grouped_matmul": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_BODY_CODE = {"fma": 0, "stream": 1, "wgmma": 2}

# the stream body's (chunk rows, K tile) and, by weight dtype, (columns a
# unit, ring stages): a stage reads 256 bytes of each K row either way;
# the wgmma body's (chunk rows, columns an item, K tile, stages);
# csrc/grouped_gemm.cu's grouped_matmul_shape reports the same
STREAM = (64, 64)
STREAM_SHAPE = {torch.bfloat16: (128, 8), torch.int8: (256, 6)}
WGMMA = (128, 256, 64, 4)
MAX_SPLITS = 8  # the blocks of one cluster
# bf16 weights take the wgmma body from this many rows an expert (m over
# min(E, nb), as the host can infer them). Measured on the H100 at
# Mixtral's up projection (chip_smoke.py's "bodies" sweep, PERF.md §6):
# at 8 rows (a 4-token decode step) the two bodies tie, from 11 rows (16
# tokens) the wgmma body is ahead, and at the 128-token chunk (39 rows)
# it takes 0.55 ms against the stream body's 0.66
WGMMA_MIN_ROWS = 10
# the stream body's splits: the smallest power of two (at most
# MAX_SPLITS) that gives each SM STREAM_ROUNDS units of 128 columns,
# counting clusters as SMs / splits (one block an SM), while each split
# keeps at least STREAM_MIN_K_TILES K tiles (measured: 1 split at
# Mixtral's decode up projection, 2 at its down projection)
STREAM_ROUNDS = 4
STREAM_MIN_K_TILES = 8


class GroupedPlan(NamedTuple):
    """What one call launches: the body ("fma", "stream" or "wgmma"), its
    chunk rows and columns a unit, the K splits (blocks of a cluster) and
    the ring stages; the C entry point checks them against its build."""
    body: str
    chunk_rows: int
    f_tile: int
    splits: int
    stages: int


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    lib = load(SOURCE)
    if lib.grouped_matmul.argtypes is None:
        lib.grouped_matmul.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_longlong]
            + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        lib.grouped_matmul.restype = ctypes.c_int
        lib.grouped_matmul_shape.argtypes = [ctypes.c_int, ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_int)]
        lib.grouped_matmul_shape.restype = ctypes.c_int
        lib.grouped_matmul_scratch.argtypes = [ctypes.c_int] * 3
        lib.grouped_matmul_scratch.restype = ctypes.c_longlong
        lib.grouped_matmul_grid.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.grouped_matmul_grid.restype = ctypes.c_int
    return lib


def built_shape(body: str, w_dtype: torch.dtype) -> Tuple[int, ...]:
    """The built bf16 body's (chunk rows, columns, K tile, stages, threads
    a block, shared-memory bytes a block)."""
    out = (ctypes.c_int * 6)()
    rc = _lib().grouped_matmul_shape(_BODY_CODE[body], _DTYPE_CODE[w_dtype],
                                     out)
    if rc != 0:
        raise ValueError(f"no {body} body for {w_dtype} weights")
    return tuple(out)


def built_grid(plan: GroupedPlan, w_dtype: torch.dtype) -> int:
    """The blocks a launch of ``plan``'s bf16 body puts on the card (its
    persistent grid: clusters of ``plan.splits`` blocks for the stream
    body, one block an SM for the wgmma body)."""
    out = ctypes.c_int(0)
    rc = _lib().grouped_matmul_grid(_BODY_CODE[plan.body],
                                    _DTYPE_CODE[w_dtype], plan.splits,
                                    ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"grouped_matmul_grid: cudaError {rc}")
    return out.value


def built_scratch_ints(m: int, nb: int, chunk_rows: int) -> int:
    """The built source's count of scratch int32 for a call."""
    return int(_lib().grouped_matmul_scratch(m, nb, chunk_rows))


def stream_plan(w_dtype: torch.dtype, splits: int = 1) -> GroupedPlan:
    """The stream body at ``splits`` K splits (blocks of a cluster)."""
    cols, stages = STREAM_SHAPE[w_dtype]
    return GroupedPlan("stream", STREAM[0], cols, splits, stages)


def wgmma_plan() -> GroupedPlan:
    """The wgmma body (bf16 weights only)."""
    ch, cols, _, stages = WGMMA
    return GroupedPlan("wgmma", ch, cols, 1, stages)


def grouped_plan(x_dtype: torch.dtype, w_dtype: torch.dtype, m: int,
                 nb: int, d: int, f: int, e: int,
                 num_sms: int) -> GroupedPlan:
    """The body and its shape for (M, D) rows in ``nb`` m-tiles times
    (E, D, F) weights, from these numbers alone (no look at the ids)."""
    if x_dtype == torch.float32:
        return GroupedPlan("fma", 32, 128, 1, 2)
    experts = min(e, nb)
    rows = m / experts
    if w_dtype == torch.bfloat16 and rows >= WGMMA_MIN_ROWS:
        return wgmma_plan()
    ch, bk = STREAM
    units = experts * max(1, math.ceil(rows / ch)) * -(-f // 128)
    nk = -(-d // bk)
    splits = 1
    while (splits < MAX_SPLITS
           and units * splits < STREAM_ROUNDS * num_sms
           and nk >= 2 * splits * STREAM_MIN_K_TILES):
        splits *= 2
    return stream_plan(w_dtype, splits)


def chunk_cap(m: int, nb: int, ch: int) -> int:
    """Most chunks of at most ``ch`` rows (live or zero, each) that the
    runs of ``nb`` tiles of m / nb rows can make (the kernel's
    grouped_chunk_cap)."""
    bm = m // nb
    return min(nb * -(-bm // ch), m // ch + nb)


def scratch_ints(m: int, nb: int, ch: int) -> int:
    """int32 scratch of a bf16 call: counts (4), live and zero chunk
    lists (4 each a chunk), run table (2 (nb + 1))."""
    return 4 * (1 + 2 * chunk_cap(m, nb, ch)) + 2 * (nb + 1)


def chunk_table(group_ids: Sequence[int], bm: int, e: int, ch: int
                ) -> Tuple[List[Tuple[int, int, int]], List[Tuple[int, int]]]:
    """The kernel's table (csrc/grouped_gemm.cu::table_kernel): the runs of
    equal ids cut into chunks of at most ``ch`` rows; returns the live
    chunks (first row, rows, expert clamped to e - 1) and the zero chunks
    (first row, rows) of runs with id < 0, each in run order."""
    live, zero = [], []
    i, nb = 0, len(group_ids)
    while i < nb:
        j = i
        while j < nb and group_ids[j] == group_ids[i]:
            j += 1
        row0, rows, g = i * bm, (j - i) * bm, group_ids[i]
        for c in range(0, rows, ch):
            if g >= 0:
                live.append((row0 + c, min(ch, rows - c), min(g, e - 1)))
            else:
                zero.append((row0 + c, min(ch, rows - c)))
        i = j
    return live, zero


def split_range(nk: int, splits: int, rank: int) -> Tuple[int, int]:
    """K tiles [kb, ke) that rank ``rank`` of a cluster of ``splits``
    blocks sums for every unit."""
    per = -(-nk // splits)
    kb = min(nk, rank * per)
    return kb, min(nk, kb + per)


def stream_walk(n_live: int, tiles_f: int, clusters: int
                ) -> List[List[Tuple[int, int]]]:
    """The (live chunk, F-tile) units that each persistent cluster of the
    stream body takes, in order: unit u = cluster + i * clusters, chunk u
    % n_live, F-tile u // n_live (the chunks of one F-tile adjacent)."""
    units = n_live * tiles_f
    return [[(u % n_live, u // n_live) for u in range(c, units, clusters)]
            for c in range(clusters)]


def wgmma_walk(chunks: int, tiles_n: int, num_sms: int
               ) -> List[List[Tuple[int, int]]]:
    """The (live chunk, F-tile) items that each persistent block of the
    wgmma body takes, in order: one block an SM, block i taking walk
    positions i, i + SMs, ...; the walk goes down groups of 8 chunks,
    column by column (the kernel's item_coords)."""
    group = 8
    items = chunks * tiles_n

    def coords(i: int) -> Tuple[int, int]:
        per_group = group * tiles_n
        first = i // per_group * group
        rows = min(chunks - first, group)
        r = i % per_group
        return first + r % rows, r // rows

    return [[coords(i) for i in range(b, items, num_sms)]
            for b in range(num_sms)]


def tma_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous) itself when its rows are whole 16-byte chunks on
    a 16-byte-aligned base, as TMA needs; else a copy with zero columns
    appended up to the next 16 bytes."""
    unit = 16 // t.element_size()
    cols = t.shape[-1]
    if cols % unit == 0 and t.data_ptr() % 16 == 0:
        return t
    return F.pad(t, (0, -cols % unit)).contiguous()


def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
                   w_scale: Optional[torch.Tensor] = None,
                   plan: Optional[GroupedPlan] = None) -> torch.Tensor:
    """x: (M, D) expert-sorted, block-padded rows (f32 or bf16); w:
    (E, D, F) in x's dtype or int8; group_ids (M // block_m,) int32
    expert id per m-tile (-1: the tile's rows are zeros); ``w_scale``
    (E,) f32 multiplies each expert's f32 product. Returns (M, F) in x's
    dtype. ``plan`` overrides ``grouped_plan``'s choice (tests force each
    body with it). bf16 calls copy ``x`` or ``w`` when their rows are not
    whole 16-byte chunks (``tma_rows``)."""
    if x.device.type == "cpu":
        return ref.grouped_matmul_ref(x, w, group_ids, w_scale=w_scale)
    _check(x, w, group_ids, w_scale)
    m, d = x.shape
    e, _, f = w.shape
    nb = group_ids.shape[0]
    if plan is None:
        plan = grouped_plan(x.dtype, w.dtype, m, nb, d, f, e,
                            _num_sms(x.device.index))
    out = torch.empty((m, f), dtype=x.dtype, device=x.device)
    scratch, n_scratch = None, 0
    if plan.body != "fma":
        x, w = tma_rows(x), tma_rows(w)
        n_scratch = scratch_ints(m, nb, plan.chunk_rows)
        scratch = torch.empty((n_scratch,), dtype=torch.int32,
                              device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().grouped_matmul(
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], x.data_ptr(),
        w.data_ptr(), group_ids.data_ptr(),
        None if w_scale is None else w_scale.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), n_scratch,
        m, d, e, f, nb, x.shape[1], w.shape[2], _BODY_CODE[plan.body],
        plan.f_tile, plan.splits, plan.stages, stream)
    if rc != 0:
        raise RuntimeError(f"grouped_matmul kernel launch failed: "
                           f"cudaError {rc}")
    launches["grouped_matmul"] += 1
    return out
