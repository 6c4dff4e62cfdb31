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

The gradient: the TPU kernel has none (the reference trains through
``jax.grad`` of ``_chunked_wkv``), so this module adds one.
``wkv_backward_plain`` writes the gradient of ``chunked_wkv_plain`` out
chunk by chunk, and ``rwkv_wkv_backward`` runs it through the kernels of
``csrc/rwkv_wkv_bwd.cu`` on CUDA tensors, starting from the group start
states that the forward's split body leaves in its scratch; its own scratch
(``backward_scratch``) follows the forward's groups. ``WkvFunction``
is the autograd function of the kernel route: the forward kernel, keeping
those states, then the backward kernel; each backward call adds one to
``launches["rwkv_wkv_backward"]``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.build import load

SOURCE = "rwkv_wkv.cu"
BWD_SOURCE = "rwkv_wkv_bwd.cu"
launches: Dict[str, int] = {"rwkv_wkv": 0, "rwkv_wkv_backward": 0}
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


def _bwd_lib() -> ctypes.CDLL:
    lib = load(BWD_SOURCE)
    if lib.rwkv_wkv_backward.argtypes is None:
        lib.rwkv_wkv_backward.argtypes = ([ctypes.c_void_p] * 17
                                          + [ctypes.c_int] * 8
                                          + [ctypes.c_void_p])
        lib.rwkv_wkv_backward.restype = ctypes.c_int
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


def _running_sum(x: Tensor, dim: int, reverse: bool = False) -> Tensor:
    """The running sum over ``dim`` (from the last position when
    ``reverse``), one add a position in order: the kernels' order, and
    deterministic on the card, where torch's deterministic mode (the
    trainer's) refuses ``torch.cumsum`` of floats."""
    parts = x.unbind(dim)
    order = reversed(range(len(parts))) if reverse else range(len(parts))
    out = [None] * len(parts)
    acc = None
    for i in order:
        acc = parts[i] if acc is None else acc + parts[i]
        out[i] = acc
    return torch.stack(out, dim)


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
        s0 = torch.zeros((b, h, hd, hd), dtype=r.dtype, device=r.device)
    nc = s // chunk
    rc = r.reshape(b, nc, chunk, h, hd)
    kc = k.reshape(b, nc, chunk, h, hd)
    vc = v.reshape(b, nc, chunk, h, hd)
    lw = logw.reshape(b, nc, chunk, h, hd)

    cum = _running_sum(lw, 2)  # within-chunk cumulative log decay
    total = cum[:, :, -1]  # (B,nc,H,hd)
    # key s reaches the chunk's end state decayed by exp(total - cum[s])
    k_out = kc * torch.exp(total[:, :, None] - cum)
    delta = torch.einsum("bnchk,bnchv->bnhkv", k_out, vc)
    a_fac = torch.exp(total)  # decay of the k-dim across a chunk
    state = s0.to(r.dtype)
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


def _check(r, k, v, logw, u, s0, state_out, **more) -> None:
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"kernel needs CUDA tensors, got r on {dev}")
    named = {"r": r, "k": k, "v": v, "logw": logw, "u": u, "s0": s0,
             "state_out": state_out, **more}
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


def _forward(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor,
             s0: Optional[Tensor], *, chunk: int,
             state_out: Optional[Tensor] = None, skip_bonus: bool = False,
             stale_state: bool = False, plan: Optional[WkvPlan] = None
             ) -> Tuple[Tensor, Tensor, Optional[Tensor], Optional[WkvPlan]]:
    """``rwkv_wkv``, also returning the split body's scratch (None for the
    other bodies and on the CPU) and the plan (None on the CPU). After the
    call the scratch holds, for each group, its start state in rows
    0..hd-1 and its decay in row hd: what the backward kernel starts its
    groups from."""
    if r.device.type == "cpu":
        if skip_bonus or stale_state:
            raise ValueError("skip_bonus and stale_state are faults of the "
                             "CUDA kernels")
        out, state_out = rwkv_wkv_plain(r, k, v, logw, u, s0, chunk=chunk,
                                        state_out=state_out)
        return out, state_out, None, None
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
        return out, state_out, None, plan
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
    return out, state_out, scratch, plan


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
    out, state_out, _, _ = _forward(
        r, k, v, logw, u, s0, chunk=chunk, state_out=state_out,
        skip_bonus=skip_bonus, stale_state=stale_state, plan=plan)
    return out, state_out


# ---------------------------------------------------------------- gradient


def wkv_backward_plain(r: Tensor, k: Tensor, v: Tensor, logw: Tensor,
                       u: Tensor, s0: Optional[Tensor], d_out: Tensor,
                       d_state: Optional[Tensor], *, chunk: int
                       ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor,
                                  Tensor]:
    """The gradient of ``chunked_wkv_plain``, written out chunk by chunk
    (not through autograd): the backward kernel's contract. ``d_out``
    (B,S,H,hd) and ``d_state`` (B,H,hd,hd; None: zeros) are the
    cotangents of out and the final state; ``logw`` is the clamped log
    decay, whose clamp's gradient stays with the caller. Returns (dr, dk,
    dv, dlogw, du, ds0).

    Per head, with S_t = diag(w_t) S_{t-1} + k_t^T v_t, out_t = r_t
    S_{t-1} + (r_t . u k_t) v_t and G_t the gradient of S_t (G_T =
    d_state, G_{t-1} = diag(w_t) G_t + r_t^T dout_t):

        dr_t = dout_t S_{t-1}^T + (dout_t . v_t) u k_t
        dk_t = G_t v_t^T + (dout_t . v_t) u r_t
        dv_t = k_t G_t + (r_t . u k_t) dout_t
        du = sum over rows and tokens of (dout_t . v_t) r_t k_t
        ds0 = G_0.

    Inside a chunk the states are the chunk's start state S_start and the
    gradient G_end of its end state, read through the forward's bounded
    factors: S_{t-1} = e^cum_excl[t] (S_start + sum_{s<t} e^-cum[s] k_s^T
    v_s), G_t = e^-cum[t] (e^total G_end + sum_{s>t} e^cum_excl[s] r_s^T
    dout_s), each product of factors at most 1. The log decay's gradient,
    w_t . rowsum(S_{t-1} o G_t), is the chunk's reverse sum over
    tokens m >= t of r_{m+1} . dr'_{m+1} - k_m . dk'_m (the primes: no
    bonus term; r_c = 0), plus rowsum(G_end o S_end): the chunk depends
    on its log decays only through their cumulative sums. No decay is
    ever divided by: one step at the -4 clamp is x e^4, and inverting a
    chunk's overflows. The start states are carried forward and the end
    gradients backward by loops over chunks."""
    b, s, h, hd = _shapes(r, k, v, logw, u, s0, chunk)
    if tuple(d_out.shape) != (b, s, h, hd):
        raise ValueError(f"d_out {tuple(d_out.shape)} != r "
                         f"{(b, s, h, hd)}")
    dt = r.dtype
    zero_state = torch.zeros((b, h, hd, hd), dtype=dt, device=r.device)
    s0 = zero_state if s0 is None else s0.to(dt)
    d_state = zero_state if d_state is None else d_state.to(dt)
    nc = s // chunk
    rc, kc, vc, lw, do = (x.reshape(b, nc, chunk, h, hd)
                          for x in (r, k, v, logw, d_out))

    cum = _running_sum(lw, 2)
    total = cum[:, :, -1]  # (B,nc,H,hd)
    e_cx = torch.exp(cum - lw)  # e^cum_excl
    e_ncum = torch.exp(-cum)
    e_out = torch.exp(total[:, :, None] - cum)
    r_in, k_n, k_out = rc * e_cx, kc * e_ncum, kc * e_out
    a_fac = torch.exp(total)[..., None]  # (B,nc,H,hd,1)

    # each chunk's start state, then the end state of the last
    delta = torch.einsum("bnchk,bnchv->bnhkv", k_out, vc)
    state, starts = s0, []
    for i in range(nc):
        starts.append(state)
        state = state * a_fac[:, i] + delta[:, i]
    s_starts = torch.stack(starts, dim=1)  # (B,nc,H,hd,hd)
    s_ends = torch.cat([s_starts[:, 1:], state[:, None]], dim=1)
    # the gradient of each chunk's end state; a chunk's start state
    # reaches its end through e^total and its queries through r e^cum_excl
    reads = torch.einsum("bnchk,bnchv->bnhkv", r_in, do)
    grad, ends = d_state, [None] * nc
    for i in reversed(range(nc)):
        ends[i] = grad
        grad = grad * a_fac[:, i] + reads[:, i]
    g_ends = torch.stack(ends, dim=1)  # (B,nc,H,hd,hd)

    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    # [t, s], s < t: the forward's scores, and dout_t . v_s
    scores = torch.where(mask, torch.einsum("bnchk,bnshk->bnhcs", r_in,
                                            k_n), 0.0)
    dv_scores = torch.where(mask, torch.einsum("bnchv,bnshv->bnhcs", do,
                                               vc), 0.0)
    bv = torch.einsum("bnchv,bnchv->bnch", do, vc)[..., None]
    bu = torch.einsum("bnchk,bnchk->bnch", rc, kc * u)[..., None]

    dr_nb = e_cx * (torch.einsum("bnchv,bnhkv->bnchk", do, s_starts)
                    + torch.einsum("bnhcs,bnshk->bnchk", dv_scores, k_n))
    dk_nb = (e_ncum * torch.einsum("bnhts,bnthk->bnshk", dv_scores, r_in)
             + e_out * torch.einsum("bnhkv,bnchv->bnchk", g_ends, vc))
    dv = (torch.einsum("bnhts,bnthv->bnshv", scores, do)
          + torch.einsum("bnchk,bnhkv->bnchv", k_out, g_ends) + bu * do)
    dr = dr_nb + bv * (u * kc)
    dk = dk_nb + bv * (u * rc)
    x_r = rc * dr_nb
    step = torch.cat([x_r[:, :, 1:], torch.zeros_like(x_r[:, :, :1])],
                     dim=2) - kc * dk_nb
    ends_term = (g_ends * s_ends).sum(-1)  # rowsum(G_end o S_end)
    dlogw = _running_sum(step, 2, reverse=True) + ends_term[:, :, None]
    du = torch.einsum("bnchk->hk", bv * rc * kc)
    shape = (b, s, h, hd)
    return (dr.reshape(shape), dk.reshape(shape), dv.reshape(shape),
            dlogw.reshape(shape), du, grad)


def backward_scratch(plan: WkvPlan, b: int, h: int, hd: int
                     ) -> Dict[str, Tuple[int, ...]]:
    """The backward kernels' scratch after a forward of ``plan``: for
    each of the forward's groups (one for a one-pass or decode forward), a
    gradient slot of hd + 1 rows of hd (the group's contribution and decay,
    then its end gradient) and a share of du. Nothing scales with the
    chunks: no chunk's state is stored."""
    ng = plan.n_groups if plan.body == "split" else 1
    return {"grads": (b, h, ng, hd + 1, hd), "du_parts": (b, h, ng, hd)}


def backward_scratch_bytes(plan: WkvPlan, b: int, h: int, hd: int) -> int:
    """Bytes of ``backward_scratch`` (f32)."""
    return sum(4 * math.prod(shape)
               for shape in backward_scratch(plan, b, h, hd).values())


def rwkv_wkv_backward(r: Tensor, k: Tensor, v: Tensor, logw: Tensor,
                      u: Tensor, s0: Optional[Tensor], d_out: Tensor,
                      d_state: Optional[Tensor] = None, *, chunk: int,
                      states: Optional[Tensor] = None,
                      plan: Optional[WkvPlan] = None, need_ds0: bool = True,
                      drop_carry: bool = False
                      ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor,
                                 Optional[Tensor]]:
    """``wkv_backward_plain``'s six results (same arguments) through the
    kernels of ``csrc/rwkv_wkv_bwd.cu`` on CUDA tensors; ds0 is None
    unless ``need_ds0``. ``plan`` is the forward's (default
    ``wkv_plan``'s); after a split forward, ``states`` is the scratch that
    ``_forward`` returned, whose group start states the backward starts
    from (the other bodies run one group from s0). Planted fault for the
    checks: ``drop_carry`` starts every group's gradient walk from zero,
    ignoring the later groups and ``d_state``."""
    if r.device.type == "cpu":
        if drop_carry:
            raise ValueError("drop_carry is a fault of the CUDA kernels")
        grads = wkv_backward_plain(r, k, v, logw, u, s0, d_out, d_state,
                                   chunk=chunk)
        return grads[:5] + (grads[5] if need_ds0 else None,)
    b, s, h, hd = _shapes(r, k, v, logw, u, s0, chunk)
    for name, t, shape in (("d_out", d_out, (b, s, h, hd)),
                           ("d_state", d_state, (b, h, hd, hd))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)}: want {shape}")
    _check(r, k, v, logw, u, s0, None, d_out=d_out, d_state=d_state,
           states=states)
    if plan is None:
        plan = wkv_plan(b, s, h, hd, chunk)
    nc = s // chunk
    if plan.body == "split":  # the forward's groups, from its states
        group, n_groups = plan.group, plan.n_groups
        if states is None or tuple(states.shape) != plan.scratch:
            raise ValueError(
                f"the split body's backward needs the forward's scratch of "
                f"shape {plan.scratch}, got "
                f"{None if states is None else tuple(states.shape)}")
    else:  # one group of every chunk, from s0
        group, n_groups, states = nc, 1, None
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk, dv, dlogw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty((h, hd), **f32)
    ds0 = torch.empty((b, h, hd, hd), **f32) if need_ds0 else None
    scratch = backward_scratch(plan, b, h, hd)
    g_scratch = torch.empty(scratch["grads"], **f32)
    du_part = torch.empty(scratch["du_parts"], **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = _bwd_lib().rwkv_wkv_backward(
        ptr(r), ptr(k), ptr(v), ptr(logw), ptr(u), ptr(s0), ptr(states),
        ptr(d_out), ptr(d_state), ptr(dr), ptr(dk), ptr(dv), ptr(dlogw),
        ptr(du), ptr(ds0), ptr(g_scratch), ptr(du_part),
        b, s, h, hd, chunk, group, n_groups, int(drop_carry), stream)
    if rc != 0:
        raise RuntimeError(f"rwkv_wkv_backward kernel launch failed ({plan}"
                           f"): cudaError {rc}")
    launches["rwkv_wkv_backward"] += 1
    return dr, dk, dv, dlogw, du, ds0


class WkvFunction(torch.autograd.Function):
    """The chunked WKV with a gradient: the forward kernel, keeping the
    split body's group start states in autograd's saved tensors, and the
    backward kernel (``rwkv_wkv_backward``) from them. Given CPU tensors
    both wrappers run their plain versions (the CPU tests' stand-in).
    ``apply(r, k, v, logw, u, s0, chunk)`` -> (out, final state)."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0, chunk):
        out, s_final, states, plan = _forward(r, k, v, logw, u, s0,
                                              chunk=chunk)
        ctx.save_for_backward(r, k, v, logw, u, s0, states)
        ctx.chunk, ctx.plan = chunk, plan
        ctx.set_materialize_grads(False)
        return out, s_final

    @staticmethod
    def backward(ctx, d_out, d_state):
        r, k, v, logw, u, s0, states = ctx.saved_tensors
        d_out = torch.zeros_like(r) if d_out is None else d_out.contiguous()
        if d_state is not None:
            d_state = d_state.contiguous()
        need_ds0 = s0 is not None and ctx.needs_input_grad[5]
        dr, dk, dv, dlogw, du, ds0 = rwkv_wkv_backward(
            r, k, v, logw, u, s0, d_out, d_state, chunk=ctx.chunk,
            states=states, plan=ctx.plan, need_ds0=need_ds0)
        return dr, dk, dv, dlogw, du, ds0, None
