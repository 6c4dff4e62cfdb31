"""Chunked RWKV-6 WKV on Hopper: wrapper of the CUDA kernels in
``csrc/rwkv_wkv.cu``, their launch plan and the plain-torch version.

Port of ``repro/kernels/rwkv_scan.py::rwkv_wkv`` (the Pallas chunked WKV)
with the function of ``repro/models/rwkv6.py::_chunked_wkv``, which the
reference model runs: the same chunked math and the same clamp of the
per-step log decay at DECAY_CLAMP = -4, plus an initial state in and the
final state out. With a zero initial state and the final state dropped it
is ``ref.rwkv_wkv_ref``'s recurrence

    out_t = r_t (S_{t-1} + diag(u) k_t^T v_t),
    S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t.

The launch plan is chosen here, on the host, from shapes alone
(``wkv_plan``): a decode step (S 1) takes the streaming decode body; a
sequence of at most one group of G chunks takes the one-pass body; a longer
one takes a state pass, which writes the state at the start of every group
to a scratch tensor, then an output pass with a block for each group.

A wrapper given CPU tensors computes the plain version; given CUDA tensors
it launches the planned body or raises. Each call adds one to
``launches["rwkv_wkv"]``, whatever the number of kernels it runs.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.build import load

SOURCE = "rwkv_wkv.cu"
launches: Dict[str, int] = {"rwkv_wkv": 0}
DECAY_CLAMP = -4.0  # min per-step log decay; exp(16 * 4) fits in f32
MAX_CHUNK = 16  # exp(-cum) stays below e^64 only for chunks <= 16
HEAD_DIMS = (16, 64)  # the kernel's instantiations: the smoke and rwkv6
# the most chunks a group of the split body takes (each is a serial step of
# its state-pass and output blocks)
MAX_GROUP = 8
THREADS = 256  # threads of a state-pass, state-scan, output or one-pass block
DECODE_COLS = 16  # value columns a decode block streams
NUM_SMS = 132  # an H100 SXM
RESIDENT_BLOCKS = 3  # chunk-body blocks an SM holds (its launch bounds)
BODIES = ("decode", "onepass", "split")
_BODY_CODE = {body: i for i, body in enumerate(BODIES)}

Tensor = torch.Tensor


class WkvPlan(NamedTuple):
    """What one call launches: the body ("decode", "onepass" or "split"),
    G (chunks a group; the whole sequence for the one-pass body), the
    groups, the grid of the decode, one-pass or output body (the split
    body's state pass has the same), the state scan's grid and the scratch
    (split only): for each group, hd rows of state (its contribution, then
    its start state) and a row of its decay."""
    body: str
    group: int
    n_groups: int
    grid: Tuple[int, int, int]
    scan_grid: Optional[Tuple[int, int, int]]
    scratch: Optional[Tuple[int, int, int, int, int]]


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    lib = load(SOURCE)
    if lib.rwkv_wkv.argtypes is None:
        lib.rwkv_wkv.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                                 + [ctypes.c_void_p])
        lib.rwkv_wkv.restype = ctypes.c_int
        lib.rwkv_wkv_grids.argtypes = ([ctypes.c_int] * 8
                                       + [ctypes.POINTER(ctypes.c_int)])
        lib.rwkv_wkv_grids.restype = ctypes.c_int
    return lib


def _shapes(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor,
            s0: Optional[Tensor], chunk: int) -> Tuple[int, int, int, int]:
    if r.dim() != 4:
        raise ValueError(f"r {tuple(r.shape)}: want (B, S, H, hd)")
    b, s, h, hd = r.shape
    for name, t in (("k", k), ("v", v), ("logw", logw)):
        if t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != r "
                             f"{tuple(r.shape)}")
    if tuple(u.shape) != (h, hd):
        raise ValueError(f"u {tuple(u.shape)}: want {(h, hd)}")
    if s0 is not None and tuple(s0.shape) != (b, h, hd, hd):
        raise ValueError(f"s0 {tuple(s0.shape)}: want {(b, h, hd, hd)}")
    _check_chunk(s, chunk)
    return b, s, h, hd


def _check_chunk(s: int, chunk: int) -> None:
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not in 1..{MAX_CHUNK}: exp(-cum) "
                         f"is bounded only for chunks of at most "
                         f"{MAX_CHUNK} at the {DECAY_CLAMP} clamp")
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk}")


def make_plan(body: str, b: int, s: int, h: int, hd: int, chunk: int, *,
              group: Optional[int] = None) -> WkvPlan:
    """The plan of ``body`` at these shapes (tests force each body through
    it): ``group`` chunks a group for the split body. A block of the
    one-pass, state or output body holds a whole head."""
    _check_chunk(s, chunk)
    if body not in BODIES:
        raise ValueError(f"body {body!r} not in {BODIES}")
    nc = s // chunk
    if body == "decode":
        if s != 1:
            raise ValueError(f"the decode body takes S 1, not {s}")
        return WkvPlan("decode", 1, 1, (max(1, hd // DECODE_COLS), h, b),
                       None, None)
    if body == "onepass":
        group = nc
    elif group is None or group < 1:
        raise ValueError(f"the split body needs a group >= 1, not {group}")
    ng = -(-nc // group)
    split = body == "split"
    return WkvPlan(body, group, ng, (ng, h, b),
                   (max(1, hd * hd // 4 // THREADS), h, b) if split else None,
                   (b, h, ng, hd + 1, hd) if split else None)


def wkv_plan(b: int, s: int, h: int, hd: int, chunk: int) -> WkvPlan:
    """The body and its shape for (B, S, H, hd) inputs at ``chunk``, from
    these numbers alone: decode at S 1; one pass for a single chunk, or
    for a few chunks of so few heads that a split could not fill half the
    card; else the state and output passes at the smallest G (a power of
    two, at most MAX_GROUP) whose blocks the card holds at once: more,
    shorter groups run in parallel, but a block beyond those waits for a
    free slot, and each group costs the scan a step. Where that G takes
    every chunk (one group), one pass does the same work in one launch."""
    _check_chunk(s, chunk)
    if s == 1:
        return make_plan("decode", b, s, h, hd, chunk)
    nc = s // chunk
    if nc == 1 or (nc <= MAX_GROUP and b * h * nc < NUM_SMS // 2):
        return make_plan("onepass", b, s, h, hd, chunk)
    group = 1
    while (2 * group <= MAX_GROUP
           and b * h * -(-nc // group) > RESIDENT_BLOCKS * NUM_SMS):
        group *= 2
    if group >= nc:
        return make_plan("onepass", b, s, h, hd, chunk)
    return make_plan("split", b, s, h, hd, chunk, group=group)


def built_grids(plan: WkvPlan, b: int, s: int, h: int, hd: int,
                chunk: int) -> Tuple[int, ...]:
    """The built source's grids for ``plan``: the state pass's grid and
    threads (zeros without one), the other body's grid and threads, a
    chunk body's dynamic shared memory in bytes, the state scan's grid and
    threads (zeros without one)."""
    out = (ctypes.c_int * 13)()
    rc = _lib().rwkv_wkv_grids(b, s, h, hd, chunk, _BODY_CODE[plan.body],
                               plan.group, plan.n_groups, out)
    if rc != 0:
        raise ValueError(f"rwkv_wkv_grids refused {plan}: cudaError {rc}")
    return tuple(out)


def chunked_wkv_plain(r: Tensor, k: Tensor, v: Tensor, logw: Tensor,
                      u: Tensor, s0: Optional[Tensor] = None, *, chunk: int
                      ) -> Tuple[Tensor, Tensor]:
    """Chunk-parallel WKV, the torch twin of the reference's
    ``_chunked_wkv``. r, k, v, logw: (B,S,H,hd) f32, logw clamped to
    [DECAY_CLAMP, 0]; u: (H, hd); s0: (B,H,hd,hd) (None: zeros).

    Within a chunk, query t reads the state decayed to t-1 and the
    chunk's keys s < t through exp(cum_excl[t]) * exp(-cum[s]), whose
    exponents stay bounded at the clamp; the current token adds the bonus
    (r_t . u k_t) v_t. The boundary states are carried by a loop over
    chunks where the reference runs ``associative_scan``: the same terms,
    another fp32 rounding. Returns (out (B,S,H,hd), s_final
    (B,H,hd,hd))."""
    b, s, h, hd = _shapes(r, k, v, logw, u, s0, chunk)
    if s0 is None:
        s0 = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                         device=r.device)
    nc = s // chunk
    rc = r.reshape(b, nc, chunk, h, hd)
    kc = k.reshape(b, nc, chunk, h, hd)
    vc = v.reshape(b, nc, chunk, h, hd)
    lw = logw.reshape(b, nc, chunk, h, hd)

    cum = torch.cumsum(lw, dim=2)  # within-chunk cumulative log decay
    total = cum[:, :, -1]  # (B,nc,H,hd)
    # key s reaches the chunk's end state decayed by exp(total - cum[s])
    k_out = kc * torch.exp(total[:, :, None] - cum)
    delta = torch.einsum("bnchk,bnchv->bnhkv", k_out, vc)
    a_fac = torch.exp(total)  # decay of the k-dim across a chunk
    state = s0.float()
    starts = []
    for i in range(nc):
        starts.append(state)
        state = state * a_fac[:, i, :, :, None] + delta[:, i]
    s_starts = torch.stack(starts, dim=1)  # (B,nc,H,hd,hd)

    # inter-chunk: r_t reads the state decayed to t-1
    cum_excl = cum - lw
    r_in = rc * torch.exp(cum_excl)
    inter = torch.einsum("bnchk,bnhkv->bnchv", r_in, s_starts)
    # intra-chunk: pairs s < t with exponent cum_excl[t] - cum[s] <= 0
    scores = torch.einsum("bnchk,bnshk->bnhcs", r_in, kc * torch.exp(-cum))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    scores = torch.where(mask, scores, 0.0)
    intra = torch.einsum("bnhcs,bnshv->bnchv", scores, vc)
    # current-token bonus: (r_t . (u * k_t)) v_t
    bonus = torch.einsum("bnchk,bnchk->bnch", rc, kc * u)
    intra = intra + bonus[..., None] * vc
    out = (inter + intra).reshape(b, s, h, hd)
    return out, state


def rwkv_wkv_plain(r: Tensor, k: Tensor, v: Tensor, logw: Tensor,
                   u: Tensor, s0: Optional[Tensor] = None, *, chunk: int,
                   state_out: Optional[Tensor] = None
                   ) -> Tuple[Tensor, Tensor]:
    """``chunked_wkv_plain`` with the kernel's interface: the final state
    is copied into ``state_out`` when one is given."""
    out, s_final = chunked_wkv_plain(r, k, v, logw, u, s0, chunk=chunk)
    if state_out is None:
        return out, s_final
    state_out.copy_(s_final)
    return out, state_out


def _check(r, k, v, logw, u, s0, state_out) -> None:
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"kernel needs CUDA tensors, got r on {dev}")
    named = {"r": r, "k": k, "v": v, "logw": logw, "u": u, "s0": s0,
             "state_out": state_out}
    for name, t in named.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, r on {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} dtype {t.dtype}: the WKV runs in "
                             f"float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned: the kernels "
                             f"read it in float4")
    if r.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {r.shape[-1]} not in {HEAD_DIMS}")
    if r.numel() >= 2 ** 31:
        raise ValueError(f"r {tuple(r.shape)}: too many elements")


def rwkv_wkv(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor,
             s0: Optional[Tensor] = None, *, chunk: int,
             state_out: Optional[Tensor] = None,
             skip_bonus: bool = False, stale_state: bool = False,
             plan: Optional[WkvPlan] = None) -> Tuple[Tensor, Tensor]:
    """The chunked WKV of ``chunked_wkv_plain`` (same arguments) through
    the CUDA kernels on CUDA tensors. ``state_out`` (B,H,hd,hd) f32 takes
    the final state and may be ``s0`` itself: no kernel reads s0 after
    any kernel has written the final state. ``plan`` overrides
    ``wkv_plan``'s choice (tests force each body). Planted faults for the
    checks: ``skip_bonus`` leaves out the current-token bonus;
    ``stale_state`` has the output pass start each group from the state
    one group behind (group 0 from zeros), a no-op for the one-pass and
    decode bodies. Returns (out (B,S,H,hd), the final state)."""
    if r.device.type == "cpu":
        if skip_bonus or stale_state:
            raise ValueError("skip_bonus and stale_state are faults of the "
                             "CUDA kernels")
        return rwkv_wkv_plain(r, k, v, logw, u, s0, chunk=chunk,
                              state_out=state_out)
    b, s, h, hd = _shapes(r, k, v, logw, u, s0, chunk)
    if state_out is not None and tuple(state_out.shape) != (b, h, hd, hd):
        raise ValueError(f"state_out {tuple(state_out.shape)}: want "
                         f"{(b, h, hd, hd)}")
    _check(r, k, v, logw, u, s0, state_out)
    if plan is None:
        plan = wkv_plan(b, s, h, hd, chunk)
    out = torch.empty_like(r)
    if state_out is None:
        state_out = torch.empty((b, h, hd, hd), dtype=torch.float32,
                                device=r.device)
    if out.numel() == 0:
        if s0 is None:
            state_out.zero_()
        else:
            state_out.copy_(s0)
        return out, state_out
    scratch = (None if plan.scratch is None else
               torch.empty(plan.scratch, dtype=torch.float32,
                           device=r.device))
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = _lib().rwkv_wkv(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), None if s0 is None else s0.data_ptr(),
        out.data_ptr(), state_out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), b, s, h, hd, chunk,
        _BODY_CODE[plan.body], plan.group, plan.n_groups,
        int(skip_bonus), int(stale_state), stream)
    if rc != 0:
        raise RuntimeError(f"rwkv_wkv kernel launch failed ({plan}): "
                           f"cudaError {rc}")
    launches["rwkv_wkv"] += 1
    return out, state_out
