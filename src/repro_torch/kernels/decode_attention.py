"""Decode attention on Hopper: wrappers of the CUDA kernels in
``csrc/decode_attention.cu`` (dense ring caches),
``csrc/paged_attention.cu`` (the page pool),
``csrc/paged_decode_attention.cu`` (one-token decode of bf16 queries over
bf16 or int8 pages) and ``csrc/paged_span_attention.cu`` (spans of bf16
queries over bf16 or int8 pages), and their plain-torch versions.

Port of ``repro/kernels/decode_attention.py``'s ``decode_attention`` (one
query against a dense ring cache), ``paged_decode_attention`` and
``paged_decode_span_attention`` (the Pallas page streams). A wrapper given
CPU tensors computes the plain version (the ring oracle; gather the pages,
then attend in torch); given CUDA tensors it launches the kernel or
raises. Each launch adds one to ``launches[name]``, so a run can show
which kernels its main path went through.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import load

SOURCE = "paged_attention.cu"
SPAN_SOURCE = "paged_span_attention.cu"
DENSE_SOURCE = "decode_attention.cu"
PAGED_DECODE_SOURCE = "paged_decode_attention.cu"
# head dims the span kernel of SPAN_SOURCE is built for: every multiple of
# 16 that a config serves through the page pool (16 in the smoke configs),
# and 256 for the tests
SPAN_HEAD_DIMS = (16, 64, 112, 128, 256)
launches: Dict[str, int] = {"decode_attention": 0,
                            "paged_decode_attention": 0,
                            "paged_decode_span_attention": 0}
# span launches by the source whose kernel ran
span_launches: Dict[str, int] = {SOURCE: 0, SPAN_SOURCE: 0}
# one-token paged decode launches by the source whose kernel ran
decode_launches: Dict[str, int] = {SOURCE: 0, PAGED_DECODE_SOURCE: 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def reset_launches() -> None:
    for counts in (launches, span_launches, decode_launches):
        for name in counts:
            counts[name] = 0


def _lib() -> ctypes.CDLL:
    lib = load(SOURCE)
    if lib.paged_attention.argtypes is None:
        lib.paged_attention.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
            + [ctypes.c_int] * 10 + [ctypes.c_float] + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
        lib.paged_attention.restype = ctypes.c_int
        lib.paged_attention_plan.argtypes = (
            [ctypes.c_int] * 10 + [ctypes.POINTER(ctypes.c_int)])
        lib.paged_attention_plan.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def _plan(q_code: int, page_code: int, b: int, t: int, h: int, kv: int,
          d: int, p: int, m: int, num_sms: int) -> Tuple[int, int, int]:
    """(span tokens per block, keys per tile, key-range splits) of a
    shape; a few shapes recur on the serving path, so plans are cached."""
    out = (ctypes.c_int * 3)()
    rc = _lib().paged_attention_plan(q_code, page_code, b, t, h, kv, d, p,
                                     m, num_sms, out)
    if rc != 0:
        raise ValueError(f"no launch plan for B={b} T={t} H={h} KV={kv} "
                         f"D={d} P={p} M={m} (cudaError {rc})")
    return out[0], out[1], out[2]


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, k_pages, v_pages, page_table, pos, k_scale, v_scale):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"kernel needs CUDA tensors, got q on {dev}")
    named = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
             "page_table": page_table, "pos": pos}
    if k_scale is not None or v_scale is not None:
        named.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in named.items():
        if t is None:
            raise ValueError(f"{name} is missing")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, t, h, d = q.shape
    n, p, kv, dp = k_pages.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q.dtype} not in (float32, bfloat16)")
    if k_pages.dtype not in _DTYPE_CODE or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"page dtypes {k_pages.dtype}/{v_pages.dtype}")
    if v_pages.shape != k_pages.shape or dp != d or h % kv:
        raise ValueError(f"shapes q {tuple(q.shape)} pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    quant = k_pages.dtype == torch.int8
    if quant != (k_scale is not None and v_scale is not None):
        raise ValueError("int8 pages need both scale pools, others none")
    if quant:
        for s in (k_scale, v_scale):
            if s.dtype != torch.bfloat16 or s.shape != (n, p, kv):
                raise ValueError(f"scale pool {s.dtype} {tuple(s.shape)}, "
                                 f"want bfloat16 {(n, p, kv)}")
    if page_table.dtype != torch.int32 or page_table.dim() != 2 \
            or page_table.shape[0] != b:
        raise ValueError(f"page_table {page_table.dtype} "
                         f"{tuple(page_table.shape)}, want int32 (B, M)")
    if pos.dtype != torch.int32 or pos.shape != (b,):
        raise ValueError(f"pos {pos.dtype} {tuple(pos.shape)}, "
                         f"want int32 ({b},)")


def _launch(q, k_pages, v_pages, page_table, pos, k_scale, v_scale,
            window: Optional[int], pos_offset: int) -> torch.Tensor:
    """q (B,T,H,D) -> out (B,T,H,D); query t of row b sits at absolute
    position pos[b] + pos_offset + t."""
    _check(q, k_pages, v_pages, page_table, pos, k_scale, v_scale)
    b, t, h, d = q.shape
    n, p, kv, _ = k_pages.shape
    out = torch.empty_like(q)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    m = page_table.shape[1]
    q_code, page_code = _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype]
    tq, tk, splits = _plan(q_code, page_code, b, t, h, kv, d, p, m,
                           _num_sms(q.device.index))
    work = None
    if splits > 1:  # partial softmax states of the key-range splits
        work = torch.empty(splits * b * t * h * (d + 2),
                           dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptr = lambda x: None if x is None else x.data_ptr()
    rc = _lib().paged_attention(
        q_code, page_code, ptr(q),
        ptr(k_pages), ptr(v_pages), ptr(k_scale), ptr(v_scale),
        ptr(page_table), ptr(pos), ptr(out), ptr(work), b, t, h, kv, d, n,
        p, m, 0 if window is None else int(window), pos_offset,
        float(d ** -0.5), tq, tk, splits, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {rc}")
    return out


def span_source(q_dtype: torch.dtype, page_dtype: torch.dtype,
                d: int) -> str:
    """The CUDA source whose kernel a span call on the card launches: the
    span kernel for bf16 queries over bf16 or int8 pages at a head dim it
    is built for, ``paged_attention.cu``'s body otherwise. Fixed by the
    dtypes and the head dim before any launch."""
    if (q_dtype == torch.bfloat16
            and page_dtype in (torch.bfloat16, torch.int8)
            and d in SPAN_HEAD_DIMS):
        return SPAN_SOURCE
    return SOURCE


def _span_lib() -> ctypes.CDLL:
    lib = load(SPAN_SOURCE)
    if lib.paged_span_attention.argtypes is None:
        lib.paged_span_attention.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.paged_span_attention.restype = ctypes.c_int
        lib.paged_span_plan.argtypes = (
            [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)])
        lib.paged_span_plan.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def span_plan(page_code: int, b: int, t: int, h: int, kv: int, d: int,
              p: int, m: int, num_sms: int) -> Tuple[int, int, int]:
    """(key-range splits, shared-memory bytes of a block, blocks an SM
    holds) of the span kernel at a shape."""
    out = (ctypes.c_int * 3)()
    rc = _span_lib().paged_span_plan(page_code, b, t, h, kv, d, p, m,
                                     num_sms, out)
    if rc != 0:
        raise ValueError(f"no span-kernel plan for B={b} T={t} H={h} "
                         f"KV={kv} D={d} P={p} M={m} (cudaError {rc})")
    return out[0], out[1], out[2]


def _launch_span(q, k_pages, v_pages, page_table, pos, k_scale, v_scale,
                 window: Optional[int]) -> torch.Tensor:
    """The span kernel of SPAN_SOURCE: q (B,T,H,D) bf16 -> out."""
    _check(q, k_pages, v_pages, page_table, pos, k_scale, v_scale)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    b, t, h, d = q.shape
    n, p, kv, _ = k_pages.shape
    m = page_table.shape[1]
    page_code = _DTYPE_CODE[k_pages.dtype]
    splits, _, _ = span_plan(page_code, b, t, h, kv, d, p, m,
                             _num_sms(q.device.index))
    out = torch.empty_like(q)
    work = None
    if splits > 1:  # partial softmax states of the key-range splits
        work = torch.empty(splits * b * t * h * (d + 2),
                           dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptr = lambda x: None if x is None else x.data_ptr()
    rc = _span_lib().paged_span_attention(
        page_code, ptr(q), ptr(k_pages), ptr(v_pages), ptr(k_scale),
        ptr(v_scale), ptr(page_table), ptr(pos), ptr(out), ptr(work), b, t,
        h, kv, d, n, p, m, 0 if window is None else int(window),
        float(d ** -0.5), splits, stream)
    if rc != 0:
        raise RuntimeError(f"paged_span_attention kernel launch failed: "
                           f"cudaError {rc}")
    return out


# ---------------------------------------------------------------------------
# The bf16 one-token paged decode body (csrc/paged_decode_attention.cu)
# ---------------------------------------------------------------------------

# keys a ring stage, the most splits of a row (the blocks of one
# thread-block cluster), query heads a KV head (mma's 16 rows) and head dims
# of the body; paged_decode_ring reports the built ones
PAGED_KEYS = 64
PAGED_MAX_SPLITS = 8
PAGED_MAX_GROUPS = 16
PAGED_MAX_D = 256


def decode_source(q_dtype: torch.dtype, page_dtype: torch.dtype, d: int,
                  groups: int) -> str:
    """The CUDA source whose kernel a one-token paged decode on the card
    launches: PAGED_DECODE_SOURCE for bf16 queries over bf16 or int8
    pages at D a multiple of 8 up to PAGED_MAX_D and at most
    PAGED_MAX_GROUPS query heads a KV head, ``paged_attention.cu``'s
    bodies otherwise (f32 queries or pages among them). Fixed by the
    dtypes and the shape before any launch."""
    if (q_dtype == torch.bfloat16
            and page_dtype in (torch.bfloat16, torch.int8)
            and d > 0 and d % 8 == 0 and d <= PAGED_MAX_D
            and 1 <= groups <= PAGED_MAX_GROUPS):
        return PAGED_DECODE_SOURCE
    return SOURCE


@dataclasses.dataclass(frozen=True)
class PagedDecodePlan:
    """A launch of the bf16 paged decode body: ``splits`` blocks (one
    cluster) a (row, KV head), a ring of ``stages`` stages of PAGED_KEYS
    keys, ``smem`` bytes of dynamic shared memory a block."""
    splits: int
    stages: int
    smem: int


def paged_tile(d: int) -> int:
    """The body's tile width at head dim ``d``: the columns of its K and V
    rows, zeros past d."""
    for dp in (16, 32, 64, 128, 256):
        if d <= dp:
            return dp
    raise ValueError(f"head dim {d} > {PAGED_MAX_D}")


def paged_decode_ring(dp: int, quant: bool) -> Tuple[int, int]:
    """(stages, shared-memory bytes of a block) of the body at tile width
    ``dp``, bf16 or int8 (``quant``) pages: the Cfg of
    csrc/paged_decode_attention.cu, which paged_decode_ring there
    reports."""
    ld = dp + 8
    # int8: K and V rows, then a 4-byte word and a byte for each of the
    # stage's 128 scales
    stage = 2 * PAGED_KEYS * dp + 10 * PAGED_KEYS if quant \
        else 2 * PAGED_KEYS * ld * 2
    stages = 4 if quant or dp <= 64 else 3
    dequant = 4 * 2 * 16 * ld * 2 if quant else 0
    # the page-id ring: 2 * stages slots of 68 ids
    walk = stages * stage + dequant + 2 * stages * 68 * 4
    merge = (4 * 16 * (dp + 8) + 4 * 16 * 2) * 4  # the 4 warps' states
    return stages, max(walk, merge)


@functools.lru_cache(maxsize=256)
def paged_decode_plan(b: int, kv: int, groups: int, d: int, p: int, m: int,
                      num_sms: int,
                      page_dtype: torch.dtype = torch.bfloat16
                      ) -> PagedDecodePlan:
    """The body's launch at a shape: splits of each (row, KV head)'s keys,
    the largest power of two up to PAGED_MAX_SPLITS (the blocks of one
    cluster) that keeps B * KV * splits blocks at one an SM for bf16 pages
    (the dense decode's rule, dense_plan) and at two an SM for int8 pages,
    and no more than the stages of a full table row (M * P slots); the
    ring's stages and shared memory. Raises for a shape the body does not
    take. The H100's readings behind the rule (chip_smoke.py's splits
    sweep): bf16 pages stream, and at Mixtral's decode 4 splits of 32 rows
    beat 8; int8 pages are held by the dequantize pass, and 8 splits (two
    blocks an SM) beat 4."""
    if (groups < 1 or groups > PAGED_MAX_GROUPS or d <= 0 or d % 8
            or d > PAGED_MAX_D or p < 1 or m < 1 or kv < 1):
        raise ValueError(f"the bf16 paged decode body takes H / KV <= "
                         f"{PAGED_MAX_GROUPS} and D a multiple of 8 up to "
                         f"{PAGED_MAX_D}; got groups={groups} D={d} P={p} "
                         f"M={m} KV={kv}")
    blocks = b * kv
    slots = num_sms * (2 if page_dtype == torch.int8 else 1)
    splits = 1
    while (blocks > 0 and splits < PAGED_MAX_SPLITS
           and 2 * splits * blocks <= slots):
        splits *= 2
    most = -(-m * p // PAGED_KEYS)  # stages of a full table row
    while splits > most:
        splits //= 2
    stages, smem = paged_decode_ring(paged_tile(d),
                                     page_dtype == torch.int8)
    return PagedDecodePlan(splits=splits, stages=stages, smem=smem)


def paged_row_slots(pos: int, p: int, m: int,
                    window: Optional[int]) -> Tuple[int, int, bool]:
    """(lo, hi, masked): the slots [lo, hi) of its table row that a decode
    row at valid count ``pos`` streams (the kernel's row_range): its valid
    keys, or, when it has none (masked), all M * P slots at -1e30."""
    s, qp = m * p, pos - 1
    masked = qp < 0 or (window is not None and qp - window + 1 > s - 1)
    if masked:
        return 0, s, True
    lo = max(0, qp - window + 1) if window is not None else 0
    return lo, min(qp + 1, s), False


def paged_split_slots(pos: int, p: int, m: int, window: Optional[int],
                      splits: int) -> List[List[int]]:
    """The table-row slots that each of a row's ``splits`` ranks streams,
    in order: the row's range in stages of PAGED_KEYS slots,
    ceil(stages / splits) consecutive stages a rank."""
    lo, hi, _ = paged_row_slots(pos, p, m, window)
    stages = -(-(hi - lo) // PAGED_KEYS)
    per = -(-stages // splits)
    out = []
    for r in range(splits):
        sb = min(stages, r * per)
        se = min(stages, sb + per)
        out.append(list(range(lo + sb * PAGED_KEYS,
                              min(lo + se * PAGED_KEYS, hi))))
    return out


def _paged_decode_lib() -> ctypes.CDLL:
    lib = load(PAGED_DECODE_SOURCE)
    if lib.paged_decode_attention.argtypes is None:
        lib.paged_decode_attention.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
            + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.paged_decode_attention.restype = ctypes.c_int
        lib.paged_decode_ring.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.paged_decode_ring.restype = ctypes.c_int
    return lib


def built_paged_ring(page_dtype: torch.dtype,
                     dp: int) -> Tuple[int, int, int, int]:
    """The built body at tile width ``dp``: (keys a stage, stages, most
    splits a row, shared-memory bytes a block)."""
    out = (ctypes.c_int * 4)()
    rc = _paged_decode_lib().paged_decode_ring(_DTYPE_CODE[page_dtype], dp,
                                               out)
    if rc != 0:
        raise ValueError(f"no paged decode ring for {page_dtype} at tile "
                         f"width {dp}")
    return out[0], out[1], out[2], out[3]


def _launch_decode(q, k_pages, v_pages, page_table, pos, k_scale, v_scale,
                   window: Optional[int], splits: Optional[int],
                   drop_stage: bool, merge_short: bool) -> torch.Tensor:
    """The body of PAGED_DECODE_SOURCE: q (B,H,D) bf16 -> out (B,H,D)."""
    _check(q[:, None], k_pages, v_pages, page_table, pos, k_scale, v_scale)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    b, h, d = q.shape
    n, p, kv, _ = k_pages.shape
    m = page_table.shape[1]
    plan = paged_decode_plan(b, kv, h // kv, d, p, m,
                             _num_sms(q.device.index), k_pages.dtype)
    if splits is None:
        splits = plan.splits
    elif not 1 <= splits <= PAGED_MAX_SPLITS:
        raise ValueError(f"splits {splits} not in 1..{PAGED_MAX_SPLITS}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t is not None and t.data_ptr() % 4:
            raise ValueError(f"{name} must start on 4 bytes")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptr = lambda x: None if x is None else x.data_ptr()
    rc = _paged_decode_lib().paged_decode_attention(
        _DTYPE_CODE[k_pages.dtype], ptr(q), ptr(k_pages), ptr(v_pages),
        ptr(k_scale), ptr(v_scale), ptr(page_table), ptr(pos), ptr(out), b,
        h, kv, d, n, p, m, 0 if window is None else int(window),
        float(d ** -0.5), splits, int(drop_stage), int(merge_short),
        stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed "
                           f"(splits {splits}): cudaError {rc}")
    return out


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, pos, *,
                                 k_scale=None, v_scale=None,
                                 window: Optional[int] = None
                                 ) -> torch.Tensor:
    """Gather-dequant + dense oracle: the kernel's plain version."""
    kg = ref.paged_gather_dequant_ref(k_pages, page_table, k_scale, q.dtype)
    vg = ref.paged_gather_dequant_ref(v_pages, page_table, v_scale, q.dtype)
    return ref.decode_attention_ref(q, kg, vg, pos, window=window)


def paged_decode_span_attention_plain(q, k_pages, v_pages, page_table, pos,
                                      *, k_scale=None, v_scale=None,
                                      window: Optional[int] = None
                                      ) -> torch.Tensor:
    kg = ref.paged_gather_dequant_ref(k_pages, page_table, k_scale, q.dtype)
    vg = ref.paged_gather_dequant_ref(v_pages, page_table, v_scale, q.dtype)
    return ref.decode_span_attention_ref(q, kg, vg, pos, window=window)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           pos: torch.Tensor, *,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           window: Optional[int] = None,
                           splits: Optional[int] = None,
                           drop_stage: bool = False,
                           merge_short: bool = False) -> torch.Tensor:
    """q: (B,H,D); pages (N,P,KV,D), int8 with bf16 (N,P,KV) scales;
    page_table (B,M) int32 (unused entries point at trash page 0); pos
    (B,) int32 valid token count. Returns (B,H,D) in q's dtype. On the
    card, bf16 queries over bf16 or int8 pages take the body of
    PAGED_DECODE_SOURCE (decode_source), whose ``splits`` overrides
    paged_decode_plan's (sweeps and tests). Its planted faults for the
    checks: ``drop_stage`` has each rank skip its last stage;
    ``merge_short`` has the merge leave out the last rank holding keys (a
    no-op where a row's keys lie in one rank)."""
    options = splits is not None or drop_stage or merge_short
    if q.device.type == "cpu":
        if options:
            raise ValueError("splits, drop_stage and merge_short are "
                             "options of the CUDA body")
        return paged_decode_attention_plain(
            q, k_pages, v_pages, page_table, pos, k_scale=k_scale,
            v_scale=v_scale, window=window)
    if (q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape[2] < 1
            or q.shape[1] % k_pages.shape[2]):
        raise ValueError(f"shapes q {tuple(q.shape)} pages "
                         f"{tuple(k_pages.shape)}, want (B,H,D), (N,P,KV,D)")
    src = decode_source(q.dtype, k_pages.dtype, q.shape[-1],
                        q.shape[1] // k_pages.shape[2])
    if src == PAGED_DECODE_SOURCE:
        out = _launch_decode(q, k_pages, v_pages, page_table, pos, k_scale,
                             v_scale, window, splits, drop_stage,
                             merge_short)
    else:
        if options:
            raise ValueError(f"splits, drop_stage and merge_short are "
                             f"options of {PAGED_DECODE_SOURCE}'s body, not "
                             f"of {src}'s")
        out = _launch(q[:, None], k_pages, v_pages, page_table, pos,
                      k_scale, v_scale, window, pos_offset=-1)[:, 0]
    launches["paged_decode_attention"] += 1
    decode_launches[src] += 1
    return out


def paged_decode_span_attention(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                page_table: torch.Tensor, pos: torch.Tensor,
                                *, k_scale: Optional[torch.Tensor] = None,
                                v_scale: Optional[torch.Tensor] = None,
                                window: Optional[int] = None
                                ) -> torch.Tensor:
    """q: (B,T,H,D), T consecutive queries at positions pos .. pos+T-1
    (their own k/v already in the pages); pos (B,) int32 valid count
    BEFORE the span. Other args as ``paged_decode_attention``."""
    if q.device.type == "cpu":
        return paged_decode_span_attention_plain(
            q, k_pages, v_pages, page_table, pos, k_scale=k_scale,
            v_scale=v_scale, window=window)
    src = span_source(q.dtype, k_pages.dtype, q.shape[-1])
    if src == SPAN_SOURCE:
        out = _launch_span(q, k_pages, v_pages, page_table, pos, k_scale,
                           v_scale, window)
    else:
        out = _launch(q, k_pages, v_pages, page_table, pos, k_scale,
                      v_scale, window, pos_offset=0)
    launches["paged_decode_span_attention"] += 1
    span_launches[src] += 1
    return out


# ---------------------------------------------------------------------------
# Dense ring caches
# ---------------------------------------------------------------------------

_DENSE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# the bf16 body: keys a ring stage, and the most splits of a row (the blocks
# of one thread-block cluster); csrc/decode_attention.cu's
# decode_attention_bf16_ring reports both
DENSE_KEYS = 64
DENSE_MAX_SPLITS = 8
# the f32 body: keys a staged tile, and the most splits of a row
DENSE_F32_KEYS = 32
DENSE_F32_MAX_SPLITS = 32
# the bf16 body's limits: query heads a KV head (mma's 16 rows), head dims
DENSE_MAX_GROUPS = 16
DENSE_MAX_D = 256


def _dense_lib() -> ctypes.CDLL:
    lib = load(DENSE_SOURCE)
    if lib.decode_attention.argtypes is None:
        lib.decode_attention.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.decode_attention.restype = ctypes.c_int
        lib.decode_attention_bf16_ring.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.decode_attention_bf16_ring.restype = ctypes.c_int
    return lib


def dense_bf16_ring(dp: int) -> Tuple[int, int, int, int]:
    """The built bf16 body at tile width ``dp``: (keys a stage, stages,
    most splits a row, shared-memory bytes a block)."""
    out = (ctypes.c_int * 4)()
    rc = _dense_lib().decode_attention_bf16_ring(dp, out)
    if rc != 0:
        raise ValueError(f"no bf16 dense ring at tile width {dp}")
    return out[0], out[1], out[2], out[3]


@functools.lru_cache(maxsize=256)
def dense_plan(dtype: torch.dtype, b: int, kv: int, w: int,
               num_sms: int) -> int:
    """Splits of each row's keys for a dense decode call, at most one per
    stage of W keys. bf16: the largest power of two up to
    DENSE_MAX_SPLITS (the blocks of one cluster) that keeps B * KV * splits
    blocks at one an SM: on the H100, 4 splits of 32 rows beat 8 and 2 of
    48 rows beat 4, while 8 splits of 8 rows beat 4 (the merge costs more
    with each rank; fewer blocks stream less). f32: blocks
    enough to fill the card twice, at most DENSE_F32_MAX_SPLITS, and one
    split once B * KV blocks alone reach the SM count (its splits merge in
    a second kernel)."""
    blocks = b * kv
    if blocks <= 0 or w <= 0:
        return 1
    if dtype == torch.float32:
        if blocks >= num_sms:
            return 1
        return max(1, min(-(-2 * num_sms // blocks), -(-w // DENSE_F32_KEYS),
                          DENSE_F32_MAX_SPLITS))
    splits = 1
    while splits < DENSE_MAX_SPLITS and 2 * splits * blocks <= num_sms:
        splits *= 2
    return min(splits, -(-w // DENSE_KEYS))


def dense_row_keys(pos: int, w: int,
                   window: Optional[int]) -> Tuple[int, int, bool]:
    """(start, n, masked): the keys a row at ``pos`` streams, logical key
    j < n at slot (start + j) % w; a row with no valid key (masked)
    streams all w slots (the kernel's row_keys)."""
    lo = max(0, pos - w)
    if window is not None:
        lo = max(lo, pos - window)
    n = pos - lo
    if n <= 0:
        return 0, w, True
    return lo % w, n, False


def dense_split_slots(pos: int, w: int, window: Optional[int], splits: int,
                      keys: int = DENSE_KEYS) -> List[List[int]]:
    """The ring slots that each of a row's ``splits`` blocks streams, in
    order: the row's keys in stages of ``keys``, ceil(stages / splits)
    consecutive stages a block (DENSE_KEYS for the bf16 body,
    DENSE_F32_KEYS for the f32 one)."""
    start, n, _ = dense_row_keys(pos, w, window)
    tiles = -(-n // keys)
    per = -(-tiles // splits)
    out = []
    for r in range(splits):
        tb = min(tiles, r * per)
        te = min(tiles, tb + per)
        out.append([(start + j) % w
                    for j in range(tb * keys, min(te * keys, n))])
    return out


def _check_dense(q, k_cache, v_cache, pos, window) -> None:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"kernel needs CUDA tensors, got q on {dev}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("pos", pos)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DENSE_CODE:
        raise ValueError(f"q dtype {q.dtype} not in (float32, bfloat16)")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"cache dtypes {k_cache.dtype}/{v_cache.dtype} "
                         f"differ from q's {q.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"shapes q {tuple(q.shape)} cache "
                         f"{tuple(k_cache.shape)}, want (B,H,D), "
                         f"(B,W,KV,D)")
    b, h, d = q.shape
    bc, w, kv, dc = k_cache.shape
    if (v_cache.shape != k_cache.shape or bc != b or dc != d or w < 1
            or h % kv):
        raise ValueError(f"shapes q {tuple(q.shape)} caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    if pos.dtype != torch.int32 or pos.shape != (b,):
        raise ValueError(f"pos {pos.dtype} {tuple(pos.shape)}, "
                         f"want int32 ({b},)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.dtype == torch.bfloat16:
        if h // kv > DENSE_MAX_GROUPS or d % 8 or d > DENSE_MAX_D:
            raise ValueError(f"bf16 dense decode takes H / KV <= "
                             f"{DENSE_MAX_GROUPS} and D a multiple of 8 up "
                             f"to {DENSE_MAX_D}; got H={h} KV={kv} D={d}")
        for name, t in (("q", q), ("k_cache", k_cache),
                        ("v_cache", v_cache)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must start on 16 bytes")


def decode_attention_plain(q, k_cache, v_cache, pos, *,
                           window: Optional[int] = None) -> torch.Tensor:
    """The ring oracle: the kernel's plain version."""
    return ref.decode_attention_ref(q, k_cache, v_cache, pos, window=window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """q: (B,H,D); caches (B,W,KV,D) ring-addressed (slot i holds position
    i + W * wraps), f32 or bf16 like q; pos (B,) int32 valid token count.
    Returns (B,H,D) in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos,
                                      window=window)
    _check_dense(q, k_cache, v_cache, pos, window)
    b, h, d = q.shape
    w, kv = k_cache.shape[1], k_cache.shape[2]
    splits = dense_plan(q.dtype, b, kv, w, _num_sms(q.device.index))
    out = torch.empty_like(q)
    work = None
    if q.dtype == torch.float32 and splits > 1:  # the splits' partial states
        work = torch.empty(splits * b * h * (d + 2), dtype=torch.float32,
                           device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _dense_lib().decode_attention(
        _DENSE_CODE[q.dtype], q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), pos.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), b, h, kv, d, w,
        0 if window is None else int(window), float(d ** -0.5), splits,
        stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {rc}")
    launches["decode_attention"] += 1
    return out
