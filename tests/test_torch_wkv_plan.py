"""The chunked WKV kernel's host plan and a torch model of its walk, on the
CPU (the CUDA bodies themselves: tests/test_torch_wkv_kernel.py, on the
card).

* ``rwkv_scan.wkv_plan``: the body, G, the grids and the scratch shape at
  every WKV shape ``chip_smoke.py`` and the rwkv6 serve
  run (S 1 to 4096; chunks 1, 8, 9, 10, 13, 15 and 16; groups that do not
  divide the chunks), and ``make_plan``'s refusals.
* ``walk``, a model of the split body that nothing on the main path calls:
  the state pass's contribution of each group from a zero start and the
  group's decay, the scan's start state of every group, then each group's
  outputs from its stored start. Held against ``chunked_wkv_plain``
  within fp32 rounding (2e-6 of the largest |value|: the group decays are
  products of the chunks' e^total, the states sums in another order);
  against JAX ``rwkv6._chunked_wkv`` from a nonzero initial state within
  1e-5 of the largest |value|, the tolerance tests/test_torch_rwkv.py
  holds the chunked WKV to; and with the planted fault ``stale_state``
  (each group from the state one group behind, group 0 from zeros) failing
  that tolerance wherever there is more than one group.
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
_jax_chunked_wkv = jax.jit(jrwkv._chunked_wkv, static_argnames="chunk")

WKV_TOL = 1e-5  # tests/test_torch_rwkv.py's
WALK_TOL = 2e-6  # fp32 rounding of the walk's reordered sums and products
CHUNKS = (1, 8, 9, 10, 13, 15, 16)
# rwkv6's 32 heads x 64: the serve's bucketed prefills, its decode steps at
# 1-4 rows, 8-16 token spans, generate_pertoken's 256- and 97-token prompts
# and chip_smoke.py's WKV cases; the smoke width hd 16; up to 4096 tokens
SERVE_SHAPES = ([(1, s, 32, 64, 16) for s in (64, 128, 256, 512, 1024)]
                + [(b, 1, 32, 64, 1) for b in (1, 2, 3, 4)]
                + [(4, s, 32, 64, s) for s in (8, 13, 16)]
                + [(2, 256, 32, 64, 16), (2, 97, 32, 64, 1),
                   (1, 97, 32, 64, 1), (1, 200, 32, 64, 10),
                   (4, 256, 32, 64, 16), (2, 48, 4, 16, 16),
                   (1, 4096, 32, 64, 16), (2, 4096, 4, 16, 16)])
GRID_SHAPES = sorted({(b, s, h, hd, c)
                      for b, s, h, hd in ((1, 1, 32, 64), (4, 1, 32, 64),
                                          (1, 90, 32, 64), (2, 270, 4, 16),
                                          (1, 360, 32, 64), (3, 720, 8, 64),
                                          (1, 2340, 32, 64),
                                          (1, 4095, 32, 64),
                                          (1, 4096, 32, 64))
                      for c in CHUNKS if s % c == 0})


def _blocks(b, h, nc, group):
    return b * h * math.ceil(nc / group)


def _check_plan(plan, b, s, h, hd, chunk):
    num_sms = rwkv_scan.NUM_SMS
    nc = s // chunk
    g_max = rwkv_scan.MAX_GROUP
    resident = rwkv_scan.RESIDENT_BLOCKS * num_sms
    if s == 1:
        assert plan.body == "decode"
        assert plan.grid == (max(1, hd // rwkv_scan.DECODE_COLS), h, b)
        assert plan.scan_grid is None and plan.scratch is None
        return
    # the split's G: the smallest power of two whose blocks the card holds
    # at once, or the largest allowed
    powers = [1 << i for i in range(g_max.bit_length()) if 1 << i <= g_max]
    g_split = next((g for g in powers if _blocks(b, h, nc, g) <= resident),
                   powers[-1])
    if (nc == 1 or (nc <= g_max and b * h * nc < num_sms // 2)
            or g_split >= nc):  # one group: one pass does it in one launch
        assert plan.body == "onepass"
        assert (plan.group, plan.n_groups) == (nc, 1)
        assert plan.scan_grid is None and plan.scratch is None
    else:
        g = plan.group
        assert plan.body == "split"
        assert g == g_split
        assert g & (g - 1) == 0 and g <= g_max
        assert _blocks(b, h, nc, g) <= resident or 2 * g > g_max
        assert g == 1 or _blocks(b, h, nc, g // 2) > resident
        assert plan.n_groups == math.ceil(nc / g) > 1
        assert (plan.n_groups - 1) * g < nc
        assert plan.scratch == (b, h, plan.n_groups, hd + 1, hd)
        assert plan.scan_grid == (max(1, hd * hd // 4 // rwkv_scan.THREADS),
                                  h, b)
    # a block a group of a whole head
    assert plan.grid == (plan.n_groups, h, b)


@pytest.mark.parametrize("shape", SERVE_SHAPES)
def test_plan_at_the_serve_shapes(shape):
    _check_plan(rwkv_scan.wkv_plan(*shape), *shape)


@pytest.mark.parametrize("shape", GRID_SHAPES)
def test_plan_over_lengths_and_chunks(shape):
    _check_plan(rwkv_scan.wkv_plan(*shape), *shape)


@pytest.mark.parametrize("shape,want", [
    # the 1024-token bucketed prefill: 8 groups of 8 chunks, 256 blocks
    ((1, 1024, 32, 64, 16), ("split", 8, 8, (8, 32, 1))),
    # the 256-token bucket: 8 groups of 2 chunks
    ((1, 256, 32, 64, 16), ("split", 2, 8, (8, 32, 1))),
    # a decode step of 4 rows: 4 blocks of 16 value columns a head
    ((4, 1, 32, 64, 1), ("decode", 1, 1, (4, 32, 4))),
    # a batch of 16-token spans: one chunk a row, in one pass
    ((4, 16, 32, 64, 16), ("onepass", 1, 1, (1, 32, 4))),
    # one 16-token span: a block a head
    ((1, 16, 32, 64, 16), ("onepass", 1, 1, (1, 32, 1))),
    # 8 rows of 2 chunks: the split's G (2) would take every chunk, so one
    # pass, one launch, reading s0 itself
    ((8, 32, 32, 64, 16), ("onepass", 2, 1, (1, 32, 8))),
    # generate_pertoken's prompt at chunk 1: 97 chunks in 13 groups of <= 8
    ((1, 97, 32, 64, 1), ("split", 8, 13, (13, 32, 1))),
    # chunk 10 at S 200: 20 chunks in groups of 2
    ((1, 200, 32, 64, 10), ("split", 2, 10, (10, 32, 1))),
    # the smoke width at 48 tokens: 3 chunks of 8 heads in one pass
    ((2, 48, 4, 16, 16), ("onepass", 3, 1, (1, 4, 2))),
])
def test_plan_at_named_shapes(shape, want):
    plan = rwkv_scan.wkv_plan(*shape)
    assert (plan.body, plan.group, plan.n_groups, plan.grid) == want


def test_make_plan_forces_and_refuses():
    split = rwkv_scan.make_plan("split", 2, 256, 4, 64, 16, group=3)
    assert (split.n_groups, split.scratch) == (6, (2, 4, 6, 65, 64))
    one = rwkv_scan.make_plan("onepass", 2, 256, 4, 64, 16)
    assert (one.group, one.n_groups, one.grid) == (16, 1, (1, 4, 2))
    assert rwkv_scan.make_plan("split", 1, 1, 2, 16, 1, group=1).n_groups == 1
    with pytest.raises(ValueError, match="S 1"):
        rwkv_scan.make_plan("decode", 1, 16, 2, 64, 16)
    with pytest.raises(ValueError, match="group"):
        rwkv_scan.make_plan("split", 1, 64, 2, 64, 16)
    with pytest.raises(ValueError, match="body"):
        rwkv_scan.make_plan("serial", 1, 64, 2, 64, 16)
    with pytest.raises(ValueError, match="chunk"):
        rwkv_scan.wkv_plan(1, 64, 2, 64, 17)
    with pytest.raises(ValueError, match="%"):
        rwkv_scan.wkv_plan(1, 64, 2, 64, 10)


def test_cpu_wrapper_refuses_the_planted_faults():
    r, k, v, lw, u = _t(*_inputs(1, (1, 32, 2, 16)))
    for fault in ("skip_bonus", "stale_state"):
        with pytest.raises(ValueError, match="faults"):
            rwkv_scan.rwkv_wkv(r, k, v, lw, u, chunk=16, **{fault: True})


# --------------------------------------------------------- the walk model


def walk(r, k, v, lw, u, s0, *, chunk, group, stale=False):
    """The split body's walk in torch: each group's contribution from a zero
    start and its decay (the product of its chunks' e^total, in order), the
    start state of every group in order from s0, then each group's outputs
    from its stored start (``stale``: the start one group behind, group 0
    from zeros). Returns (out, final state)."""
    b, s, h, hd = r.shape
    nc = s // chunk
    span = group * chunk
    cuts = [slice(g, min(s, g + span)) for g in range(0, s, span)]
    contrib, decays = [], []
    for sl in cuts:
        _, delta = rwkv_scan.chunked_wkv_plain(
            r[:, sl], k[:, sl], v[:, sl], lw[:, sl], u, chunk=chunk)
        totals = torch.cumsum(lw[:, sl].reshape(b, -1, chunk, h, hd),
                              dim=2)[:, :, -1]  # (B, chunks, H, hd)
        dec = torch.ones((b, h, hd))
        for i in range(totals.shape[1]):
            dec = dec * torch.exp(totals[:, i])
        contrib.append(delta)
        decays.append(dec)
    assert len(cuts) == math.ceil(nc / group)
    state = torch.zeros((b, h, hd, hd)) if s0 is None else s0
    starts = []
    for delta, dec in zip(contrib, decays):
        starts.append(state)
        state = dec[..., None] * state + delta
    outs = []
    for g, sl in enumerate(cuts):
        start = starts[g]
        if stale:
            start = starts[g - 1] if g else torch.zeros_like(start)
        out, _ = rwkv_scan.chunked_wkv_plain(
            r[:, sl], k[:, sl], v[:, sl], lw[:, sl], u, start, chunk=chunk)
        outs.append(out)
    return torch.cat(outs, dim=1), state


def _inputs(seed, shape):
    """r, k, v ~ N(0, 1), logw = clip(-exp(N(0, 1)), -4, 0), u ~ N(0,
    0.25): numpy f32, as tests/test_torch_rwkv.py draws them."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    lw = np.clip(-np.exp(rng.standard_normal(shape)), -4.0,
                 0.0).astype(np.float32)
    u = (rng.standard_normal(shape[2:]) * 0.5).astype(np.float32)
    return r, k, v, lw, u


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _err(got, want):
    """max |got - want| over max(1, max |want|)."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


# (B, S, H, hd, chunk, G): groups that divide the chunks and groups that do
# not, one chunk a group, one group, chunk 1 at generate_pertoken's 97
# tokens, rwkv6's head dim
WALK_CASES = [
    (2, 64, 3, 16, 16, 1), (2, 96, 3, 16, 16, 4), (1, 80, 2, 16, 8, 3),
    (2, 97, 2, 16, 1, 8), (1, 97, 2, 16, 1, 64), (2, 90, 3, 16, 9, 4),
    (1, 200, 2, 16, 10, 6), (2, 130, 2, 16, 13, 2), (1, 150, 2, 16, 15, 3),
    (1, 48, 2, 16, 16, 5), (1, 256, 2, 64, 16, 4), (1, 128, 1, 64, 16, 3),
]


def _walk_inputs(case):
    b, s, h, hd, chunk, group = case
    r, k, v, lw, u = _inputs(s * 7 + chunk, (b, s, h, hd))
    s0 = (np.random.default_rng(s + group).standard_normal((b, h, hd, hd))
          * 0.3).astype(np.float32)
    return (r, k, v, lw, u, s0), chunk, group


@pytest.mark.parametrize("case", WALK_CASES)
def test_walk_matches_chunked_plain(case):
    args, chunk, group = _walk_inputs(case)
    out, sf = walk(*_t(*args), chunk=chunk, group=group)
    want, wsf = rwkv_scan.chunked_wkv_plain(*_t(*args), chunk=chunk)
    assert _err(out, want) <= WALK_TOL
    assert _err(sf, wsf) <= WALK_TOL


@pytest.mark.parametrize("case", WALK_CASES)
def test_walk_matches_jax_chunked_wkv(case):
    args, chunk, group = _walk_inputs(case)
    out, sf = walk(*_t(*args), chunk=chunk, group=group)
    jout, jsf = _jax_chunked_wkv(*[jnp.asarray(x) for x in args],
                                 chunk=chunk)
    assert _err(out, jout) <= WKV_TOL
    assert _err(sf, jsf) <= WKV_TOL


@pytest.mark.parametrize("case", WALK_CASES)
def test_walk_from_zeros_matches_jax(case):
    """No initial state: the kernel's zero start of group 0."""
    (r, k, v, lw, u, _), chunk, group = _walk_inputs(case)
    out, sf = walk(*_t(r, k, v, lw, u), None, chunk=chunk, group=group)
    b, _, h, hd = r.shape
    jout, jsf = _jax_chunked_wkv(
        *[jnp.asarray(x) for x in (r, k, v, lw, u)],
        jnp.zeros((b, h, hd, hd), jnp.float32), chunk=chunk)
    assert _err(out, jout) <= WKV_TOL
    assert _err(sf, jsf) <= WKV_TOL


@pytest.mark.parametrize("case", WALK_CASES)
def test_stale_walk_fails(case):
    args, chunk, group = _walk_inputs(case)
    want, _ = rwkv_scan.chunked_wkv_plain(*_t(*args), chunk=chunk)
    bad, sf = walk(*_t(*args), chunk=chunk, group=group, stale=True)
    n_groups = math.ceil(case[1] // chunk / group)
    assert n_groups > 1 or _err(bad, want) > WKV_TOL  # from zeros, not s0
    assert _err(bad, want) > WKV_TOL
    # the scan's final state does not read the stale starts
    _, wsf = rwkv_scan.chunked_wkv_plain(*_t(*args), chunk=chunk)
    assert _err(sf, wsf) <= WALK_TOL
