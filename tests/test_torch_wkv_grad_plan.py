"""A torch model of the WKV backward kernel's walk (``csrc/rwkv_wkv_bwd.cu``)
and its host plan, on the CPU (the CUDA kernels themselves:
tests/test_torch_wkv_grad_kernel.py, on the card).

``grad_walk`` follows the kernels' decomposition, which nothing on the
main path calls:

* each group after the first: its contribution to the state gradient from
  a zero end, walking its chunks backward, and its decay (the product of
  its chunks' e^total, in the walk's order);
* the scan: each group's end gradient, from d_state (or zeros) back;
* each group from its start state (the forward's group states): a forward
  walk over its chunks that writes dr and r o dr' (dr without the bonus)
  and carries the state to the group's end, then a backward walk from the
  group's end gradient that writes dk, dv and dlogw and carries the
  gradient to the group's start (ds0 for the first group). No chunk state
  is kept: dlogw is the group's reverse sum over tokens of r_{m+1} o
  dr'_{m+1} - k_m o dk'_m (r past the group's end taken as zero) plus
  rowsum(G_end o S_end) of the group, not of every chunk.

Held against ``wkv_backward_plain`` within fp32 rounding (WALK_TOL of each
result's largest |value|: the same terms in another order) at head dims
16 and 64, chunks 1, 5, 13 and 16, groups that do and do not divide the
chunks, one group of every chunk (the one-pass forward's plan) and groups
of 1-3 chunks (K - 1, K and K + 1 for the kernels' ring of K = 2 staged
chunks); against ``jax.vjp`` of ``rwkv6._chunked_wkv`` within
tests/test_torch_wkv_grad.py's 2e-5 on five small cases that cover the
same head dims, chunks and kinds of group; with the planted fault
``drop_carry`` (every
group's backward walk from a zero end gradient) failing that tolerance
wherever a later group or a d_state exists, and passing where neither
does. ``backward_scratch``, the host's scratch plan, is pinned at the
shapes ``chip_smoke.py`` and the rwkv6 trainer run.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv6 as jrwkv
from repro_torch.kernels import rwkv_scan

jax.config.update("jax_default_matmul_precision", "highest")

WKV_GRAD_TOL = 2e-5  # tests/test_torch_wkv_grad.py's
WALK_TOL = 4e-6  # fp32 rounding of the walk's reordered sums over a group
NAMES = ("dr", "dk", "dv", "dlogw", "du", "ds0")
RING = 2  # the chunks the kernels' cp.async ring stages (kStages)


def _rev(x, dim):
    return rwkv_scan._running_sum(x, dim, reverse=True)


def grad_walk(r, k, v, logw, u, s0, d_out, d_state, *, chunk, group,
              drop_carry=False):
    """The backward kernels' walk in torch (see the module docstring).
    Arguments as ``wkv_backward_plain``'s, plus ``group`` (chunks a group,
    the forward's G) and the planted fault. Returns (dr, dk, dv, dlogw, du,
    ds0)."""
    b, s, h, hd = r.shape
    nc = s // chunk
    ng = -(-nc // group)
    zeros = torch.zeros((b, h, hd, hd), dtype=r.dtype)
    s0 = zeros if s0 is None else s0
    d_state = zeros if d_state is None else d_state
    rc, kc, vc, lw, do = (x.reshape(b, nc, chunk, h, hd)
                          for x in (r, k, v, logw, d_out))
    cum = rwkv_scan._running_sum(lw, 2)
    total = cum[:, :, -1]
    e_cx, e_n = torch.exp(cum - lw), torch.exp(-cum)
    e_o = torch.exp(total[:, :, None] - cum)
    r_in, k_n, k_o = rc * e_cx, kc * e_n, kc * e_o
    a_fac = torch.exp(total)[..., None]  # (B, nc, H, hd, 1)
    lower = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool),
                       diagonal=-1)
    chunks = [range(g * group, min(nc, (g + 1) * group)) for g in range(ng)]

    # the forward's group start states (its scratch)
    starts, state = [], s0
    for ids in chunks:
        starts.append(state)
        for i in ids:
            state = a_fac[:, i] * state + torch.einsum(
                "bchk,bchv->bhkv", k_o[:, i], vc[:, i])

    def reads(i):  # chunk i's read of the gradient: (r e^cum_excl)^T dout
        return torch.einsum("bchk,bchv->bhkv", r_in[:, i], do[:, i])

    # each later group's contribution from a zero end, and its decay
    contrib = [None] * ng
    for g in range(1, ng):
        grad, dec = torch.zeros_like(zeros), torch.ones_like(a_fac[:, 0])
        for i in reversed(chunks[g]):
            grad = a_fac[:, i] * grad + reads(i)
            dec = dec * a_fac[:, i]
        contrib[g] = (grad, dec)
    # the scan: each group's end gradient
    ends = [None] * ng
    grad = d_state
    for g in reversed(range(ng)):
        ends[g] = grad
        if g:
            grad = contrib[g][1] * grad + contrib[g][0]

    dr, dk, dv, dlogw = (torch.empty_like(rc) for _ in range(4))
    du = torch.zeros((h, hd), dtype=r.dtype)
    ds0 = None
    for g, ids in enumerate(chunks):
        # forward walk: dr and r o dr' of every chunk, the state onward
        state, x_r = starts[g], {}
        for i in ids:
            dvs = torch.where(lower, torch.einsum(
                "bthv,bshv->bhts", do[:, i], vc[:, i]), 0.0)
            dr_nb = e_cx[:, i] * (
                torch.einsum("bthv,bhkv->bthk", do[:, i], state)
                + torch.einsum("bhts,bshk->bthk", dvs, k_n[:, i]))
            bv = torch.einsum("bthv,bthv->bth", do[:, i], vc[:, i])[..., None]
            dr[:, i] = dr_nb + bv * (u * kc[:, i])
            x_r[i] = rc[:, i] * dr_nb
            state = a_fac[:, i] * state + torch.einsum(
                "bchk,bchv->bhkv", k_o[:, i], vc[:, i])
        # backward walk from the group's end gradient
        grad = torch.zeros_like(zeros) if drop_carry else ends[g]
        carry = (grad * state).sum(-1)  # rowsum(G_end o S_end): (B, H, hd)
        nxt = torch.zeros_like(x_r[ids[0]][:, :1])  # r past the group's end
        for i in reversed(ids):
            scores = torch.where(lower, torch.einsum(
                "bthk,bshk->bhts", r_in[:, i], k_n[:, i]), 0.0)
            dvs = torch.where(lower, torch.einsum(
                "bthv,bshv->bhts", do[:, i], vc[:, i]), 0.0)
            bv = torch.einsum("bthv,bthv->bth", do[:, i], vc[:, i])[..., None]
            bu = torch.einsum("bthk,bthk->bth", rc[:, i],
                              kc[:, i] * u)[..., None]
            dk_nb = (e_n[:, i] * torch.einsum("bhts,bthk->bshk", dvs,
                                              r_in[:, i])
                     + e_o[:, i] * torch.einsum("bhkv,bshv->bshk", grad,
                                                vc[:, i]))
            dk[:, i] = dk_nb + bv * (u * rc[:, i])
            dv[:, i] = (torch.einsum("bhts,bthv->bshv", scores, do[:, i])
                        + torch.einsum("bshk,bhkv->bshv", k_o[:, i], grad)
                        + bu * do[:, i])
            step = (torch.cat([x_r[i][:, 1:], nxt], dim=1)
                    - kc[:, i] * dk_nb)
            dlogw[:, i] = _rev(step, 1) + carry[:, None]
            carry = dlogw[:, i, 0]
            nxt = x_r[i][:, :1]
            du = du + torch.einsum("bth,bthk->hk", bv[..., 0],
                                   rc[:, i] * kc[:, i])
            grad = a_fac[:, i] * grad + reads(i)
        if g == 0:
            ds0 = grad
    shape = (b, s, h, hd)
    return (dr.reshape(shape), dk.reshape(shape), dv.reshape(shape),
            dlogw.reshape(shape), du, ds0)


def _inputs(seed, b, s, h, hd, *, nonzero=True):
    """r, k, v ~ N(0, 1), logw = clip(-exp(N(0, 1)), -4, 0), u ~ N(0,
    0.25), s0 ~ N(0, 0.09), cotangents dout ~ N(0, 1) and d_state ~ N(0,
    0.25) (s0 and d_state None unless ``nonzero``): numpy f32, as
    tests/test_torch_wkv_grad.py draws them."""
    rng = np.random.default_rng(seed)
    shape = (b, s, h, hd)
    r, k, v = (rng.standard_normal(shape) for _ in range(3))
    lw = np.clip(-np.exp(rng.standard_normal(shape)), -4.0, 0.0)
    u = rng.standard_normal((h, hd)) * 0.5
    s0 = rng.standard_normal((b, h, hd, hd)) * 0.3
    dout = rng.standard_normal(shape)
    dstate = rng.standard_normal((b, h, hd, hd)) * 0.5
    out = [x.astype(np.float32) for x in (r, k, v, lw, u, s0, dout, dstate)]
    if not nonzero:
        out[5] = out[7] = None
    return out


def _t(*xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


def _err(got, want):
    """max |got - want| over max(1, max |want|)."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


# (B, S, H, hd, chunk, G, nonzero s0 and d_state): chunks 1, 5, 13 and 16 at
# hd 16 and 64; groups that divide the chunks and groups that do not; one
# group of every chunk (97 chunks of 1, 16 of 16); groups of RING - 1, RING
# and RING + 1 chunks; a zero start and no final-state cotangent (the loss)
WALK_CASES = [
    (2, 64, 3, 16, 16, 1, True), (2, 96, 2, 16, 16, 4, True),
    (1, 80, 2, 16, 5, 3, True), (2, 60, 2, 64, 5, 4, True),
    (2, 97, 2, 16, 1, 8, True), (1, 97, 2, 64, 1, 97, True),
    (2, 130, 2, 16, 13, 3, True), (1, 65, 2, 64, 13, 5, True),
    (1, 256, 2, 64, 16, 16, True), (1, 256, 2, 64, 16, 3, False),
    (2, 48, 2, 16, 16, RING - 1, True), (2, 96, 2, 16, 16, RING, True),
    (1, 112, 2, 64, 16, RING + 1, True), (1, 128, 2, 64, 16, RING, False),
    (2, 40, 2, 64, 5, RING + 1, False), (1, 13, 2, 16, 13, 1, True),
]


# the cases held to jax.vjp too (each compiles _chunked_wkv anew): hd 16
# and 64, chunks 1, 5, 13 and 16, groups that do and do not divide the
# chunks, one group of several chunks, a zero start
JAX_CASES = [
    (2, 48, 2, 16, 16, 1, True), (1, 65, 2, 64, 13, 2, True),
    (2, 40, 2, 64, 5, 3, False), (1, 24, 2, 16, 1, 5, True),
    (1, 64, 2, 64, 16, 4, True),
]


def _case(case):
    b, s, h, hd, chunk, group, nonzero = case
    return _inputs(s * 3 + hd + group, b, s, h, hd, nonzero=nonzero), chunk, \
        group


@pytest.mark.parametrize("case", WALK_CASES)
def test_walk_matches_plain_backward(case):
    args, chunk, group = _case(case)
    got = grad_walk(*_t(*args), chunk=chunk, group=group)
    want = rwkv_scan.wkv_backward_plain(*_t(*args), chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        assert bool(torch.isfinite(g).all()), name
        assert _err(g, w) <= WALK_TOL, (name, _err(g, w))


@pytest.mark.parametrize("case", JAX_CASES)
def test_walk_matches_jax_vjp(case):
    args, chunk, group = _case(case)
    r, k, v, lw, u, s0, dout, dstate = args
    b, _, h, hd = r.shape
    s0_j = np.zeros((b, h, hd, hd), np.float32) if s0 is None else s0
    (_, s_final), vjp = jax.vjp(
        lambda *a: jrwkv._chunked_wkv(*a, chunk=chunk),
        *(jnp.asarray(x) for x in (r, k, v, lw, u, s0_j)))
    want = vjp((jnp.asarray(dout), jnp.zeros_like(s_final)
                if dstate is None else jnp.asarray(dstate)))
    got = grad_walk(*_t(*args), chunk=chunk, group=group)
    for name, g, w in zip(NAMES, got, want):
        assert _err(g, w) <= WKV_GRAD_TOL, (name, _err(g, w))


@pytest.mark.parametrize("case", WALK_CASES)
def test_dropped_carry_fails(case):
    """The planted fault: every group's backward walk from a zero end
    gradient. It fails wherever a later group or a d_state exists, and
    changes nothing where neither does."""
    args, chunk, group = _case(case)
    want = rwkv_scan.wkv_backward_plain(*_t(*args), chunk=chunk)
    bad = grad_walk(*_t(*args), chunk=chunk, group=group, drop_carry=True)
    reading = max(_err(g, w) for g, w in zip(bad[:4], want[:4]))
    n_groups = math.ceil(case[1] // case[4] / group)
    if n_groups > 1 or case[6]:
        assert reading > WKV_GRAD_TOL
    else:
        assert reading <= WALK_TOL


# (B, S, H, hd, chunk): chip_smoke.py's WKV_GRAD_CASES, the rwkv6 trainer
# at chip_smoke.py's batch and at the f32 check's (1 x 2048), the smoke
# model's trainer (chunk 16), and tests/test_torch_wkv_grad_kernel.py's
# training row
SCRATCH_SHAPES = {
    (4, 2048, 32, 64, 16): ("split", 8, 16),
    (1, 2048, 32, 64, 16): ("split", 8, 16),
    (4, 256, 4, 16, 16): ("split", 1, 16),
    (2, 64, 4, 16, 16): ("onepass", 4, 1),
    (2, 32, 4, 16, 16): ("onepass", 2, 1),
}


@pytest.mark.parametrize("shape", sorted(SCRATCH_SHAPES))
def test_backward_scratch_at_main_path_shapes(shape):
    """The backward's scratch follows the forward's groups, never the
    chunks: a gradient slot (hd + 1 rows of hd) a group and a du share a
    group, each (B, H, groups, ...); no chunk state is stored."""
    b, s, h, hd, chunk = shape
    body, group, ng = SCRATCH_SHAPES[shape]
    plan = rwkv_scan.wkv_plan(b, s, h, hd, chunk)
    assert (plan.body, plan.group, plan.n_groups) == (body, group, ng)
    shapes = rwkv_scan.backward_scratch(plan, b, h, hd)
    assert shapes == {"grads": (b, h, ng, hd + 1, hd),
                      "du_parts": (b, h, ng, hd)}
    nbytes = rwkv_scan.backward_scratch_bytes(plan, b, h, hd)
    assert nbytes == 4 * b * h * ng * (hd + 2) * hd


def test_backward_scratch_at_training_shape():
    """rwkv6-1.6B's training shape: 34.6 MB of scratch where the chunk
    states took 270.5 MB."""
    plan = rwkv_scan.wkv_plan(4, 2048, 32, 64, 16)
    assert rwkv_scan.backward_scratch_bytes(plan, 4, 32, 64) == 34_603_008
    assert 4 * 4 * 32 * 129 * 64 * 64 == 270_532_608


def test_backward_scratch_of_other_bodies():
    """The one-pass and decode forwards run one group from s0."""
    for body, s, chunk in (("onepass", 64, 16), ("decode", 1, 1)):
        plan = rwkv_scan.make_plan(body, 2, s, 4, 64, chunk)
        assert rwkv_scan.backward_scratch(plan, 2, 4, 64) == {
            "grads": (2, 4, 1, 65, 64), "du_parts": (2, 4, 1, 64)}
    plan = rwkv_scan.make_plan("split", 2, 64, 4, 16, 16, group=3)
    assert rwkv_scan.backward_scratch(plan, 2, 4, 16)["grads"] == (
        2, 4, 2, 17, 16)
