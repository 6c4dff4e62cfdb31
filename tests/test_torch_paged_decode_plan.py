"""CPU checks of the bf16 paged one-token decode body's launch plan and key
split (kernels/decode_attention.py; the body is
csrc/paged_decode_attention.cu and runs only on the card, see
tests/test_torch_paged_decode_kernel.py).

- ``decode_source`` routes bf16 queries over bf16 or int8 pages (D a
  multiple of 8 up to 256, at most 16 query heads a KV head) to the body,
  everything else to paged_attention.cu.
- ``paged_decode_plan`` at every decode shape of chip_smoke.py and of the
  serves: splits a power of two up to 8 (one cluster), at most one block an
  SM, no more splits than a full table row has stages; the ring's stages and
  shared memory within a block's limit.
- ``paged_split_slots``: every slot the plain version's mask weighs falls in
  exactly one split; a row with no valid key streams all M * P slots; pages
  wholly behind the window are never streamed.
- ``walk``, a torch model of the body's walk (per-warp online softmax over
  16-key chunks of 64-key stages, the row's warp states merged in rank then
  warp order), held against ``paged_decode_attention_plain`` within fp32
  rounding and against the JAX ``paged_decode_attention`` (interpret mode
  and the ref path) on the same numpy inputs within test_torch_kernels.py's
  bf16 tolerance; the walks of the two planted faults fail it.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jdec
from repro.kernels import ops as jops
from repro.models.blocks import paged_quantize as j_paged_quantize
from repro_torch.kernels import decode_attention as kern

SMS = 132
LOG2E = 1.4426950408889634
NEG_INF = -1e30
BF16_TOL = 2e-2  # tests/test_torch_kernels.py's bf16 tolerance


# ------------------------------------------------------------------ route


@pytest.mark.parametrize("q_dt,page_dt,d,groups,want", [
    (torch.bfloat16, torch.bfloat16, 64, 7, kern.PAGED_DECODE_SOURCE),
    (torch.bfloat16, torch.int8, 128, 6, kern.PAGED_DECODE_SOURCE),
    (torch.bfloat16, torch.bfloat16, 8, 2, kern.PAGED_DECODE_SOURCE),
    (torch.bfloat16, torch.int8, 112, 16, kern.PAGED_DECODE_SOURCE),
    (torch.bfloat16, torch.bfloat16, 256, 1, kern.PAGED_DECODE_SOURCE),
    (torch.float32, torch.float32, 64, 7, kern.SOURCE),
    (torch.float32, torch.int8, 64, 7, kern.SOURCE),
    (torch.bfloat16, torch.float32, 64, 7, kern.SOURCE),
    (torch.bfloat16, torch.bfloat16, 12, 2, kern.SOURCE),
    (torch.bfloat16, torch.bfloat16, 264, 2, kern.SOURCE),
    (torch.bfloat16, torch.bfloat16, 64, 17, kern.SOURCE),
])
def test_decode_source_routes_bf16_queries_to_the_body(q_dt, page_dt, d,
                                                       groups, want):
    assert kern.decode_source(q_dt, page_dt, d, groups) == want


# ------------------------------------------------------------------- plan

# (label, B, KV, groups, D, P, M): chip_smoke.py's decode cases and the
# serves' decode steps (qwen2-0.5B 14/2 x 64, Mixtral 48/8 x 128 with a
# 4096-token window over 289 pages, Qwen2-VL-7B 28/4 x 128, phi4-mini 24/8
# x 128, the wide 131,072-token row over 8-slot pages, the floor case of
# 16-token rows), the smoke configs' head dims, kimi's 112 and a group of
# 16
SHAPES = [
    ("qwen", 8, 2, 7, 64, 16, 129),
    ("qwen_serve", 4, 2, 7, 64, 16, 40),
    ("qwen_d128_window", 8, 2, 7, 128, 16, 129),
    ("mixtral", 4, 8, 6, 128, 16, 289),
    ("mixtral_serve", 5, 8, 6, 128, 16, 300),
    ("qwen2_vl", 4, 4, 7, 128, 16, 40),
    ("phi4", 4, 8, 3, 128, 16, 65),
    ("wide", 1, 8, 3, 128, 8, 16385),
    ("floor", 8, 2, 7, 64, 16, 2),
    ("smoke_d8", 2, 2, 2, 8, 8, 4),
    ("smoke_d16", 3, 2, 3, 16, 8, 6),
    ("kimi", 2, 8, 8, 112, 16, 64),
    ("group16", 1, 2, 16, 64, 16, 32),
    ("one_request", 1, 2, 7, 64, 16, 129),
]


@pytest.mark.parametrize("page_dt", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("label,b,kv,groups,d,p,m", SHAPES)
def test_plan_at_every_decode_shape(label, b, kv, groups, d, p, m, page_dt):
    plan = kern.paged_decode_plan(b, kv, groups, d, p, m, SMS, page_dt)
    s = plan.splits
    most = -(-m * p // kern.PAGED_KEYS)
    assert 1 <= s <= kern.PAGED_MAX_SPLITS and s & (s - 1) == 0
    assert s <= most  # no split beyond a full table row's stages
    slots = SMS * (2 if page_dt == torch.int8 else 1)
    if s > 1:
        assert b * kv * s <= slots  # one block an SM, two for int8
    if s < kern.PAGED_MAX_SPLITS and 2 * s <= most:
        assert b * kv * 2 * s > slots  # no room to double
    dp = kern.paged_tile(d)
    assert dp >= d and dp in (16, 32, 64, 128, 256)
    assert plan.stages == (4 if page_dt == torch.int8 or dp <= 64 else 3)
    assert plan.smem <= 232448
    # the ring, the int8 tiles and the id ring (4 bytes x 68 a stage)
    # hold every stage
    assert plan.smem >= plan.stages * (kern.PAGED_KEYS * 2 * d
                                       + 68 * 4)


@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("kv", [1, 2, 4, 8])
@pytest.mark.parametrize("m", [1, 2, 8, 129, 16385])
def test_plan_splits_fill_the_card_in_one_cluster(b, kv, m):
    for p in (8, 16):
        for page_dt, per_sm in ((torch.bfloat16, 1), (torch.int8, 2)):
            s = kern.paged_decode_plan(b, kv, 7, 64, p, m, SMS,
                                       page_dt).splits
            most = -(-m * p // kern.PAGED_KEYS)
            want = 1
            while (want < 8 and 2 * want * b * kv <= per_sm * SMS
                   and 2 * want <= most):
                want *= 2
            assert s == want


def test_serving_shapes_plan():
    # qwen's kernel case and serve: 16 and 8 (row, KV head) blocks take 8
    # splits; Mixtral's 32 take 4 (8 with int8 pages); Qwen2-VL's 16 take
    # 8; the floor case's 32-slot rows have one stage; the wide row 8
    plan = lambda *a: kern.paged_decode_plan(*a, SMS).splits
    assert kern.paged_decode_plan(4, 8, 6, 128, 16, 289, SMS,
                                  torch.int8).splits == 8
    assert plan(8, 2, 7, 64, 16, 129) == 8
    assert plan(4, 2, 7, 64, 16, 40) == 8
    assert plan(4, 8, 6, 128, 16, 289) == 4
    assert plan(4, 4, 7, 128, 16, 40) == 8
    assert plan(8, 2, 7, 64, 16, 2) == 1
    assert plan(1, 8, 3, 128, 8, 16385) == 8
    assert plan(40, 8, 6, 128, 16, 289) == 1


@pytest.mark.parametrize("groups,d,p,m", [
    (17, 64, 16, 8), (7, 12, 16, 8), (7, 264, 16, 8), (0, 64, 16, 8),
    (7, 64, 0, 8), (7, 64, 16, 0)])
def test_plan_refuses_shapes_outside_the_body(groups, d, p, m):
    with pytest.raises(ValueError):
        kern.paged_decode_plan(4, 2, groups, d, p, m, SMS)


def test_ring_shared_memory_mirrors_the_source():
    """paged_decode_ring's numbers are the Cfg of the CUDA source: the
    walk's bytes at every tile width (the gpu test pins them to the built
    body's report)."""
    for dp in (16, 32, 64, 128, 256):
        ld = dp + 8
        st, smem = kern.paged_decode_ring(dp, False)
        assert smem == max(st * 2 * 64 * ld * 2 + 2 * st * 272,
                           (64 * (dp + 8) + 128) * 4)
        st, smem = kern.paged_decode_ring(dp, True)
        assert smem == max(st * (2 * 64 * dp + 640) + 4 * 32 * ld * 2
                           + 2 * st * 272, (64 * (dp + 8) + 128) * 4)


# ------------------------------------------------------------------ split

# (P, M, window, rows' pos): windows (pages behind them trimmed), pos 0,
# rows shorter than one stage, rows at a stage's edge, a full table row,
# one-slot pages, a window of one key, a window past the table
ROWS = [
    (16, 129, None, (0, 1, 15, 16, 63, 64, 65, 256, 1000, 2048, 2064)),
    (16, 289, 4096, (1000, 4150, 4400, 4608, 4624)),
    (16, 40, 500, (1, 132, 356, 512, 632, 640)),
    (8, 20, 5, (0, 1, 2, 5, 6, 64, 100, 160)),
    (1, 200, None, (0, 1, 64, 65, 128, 200)),
    (1, 200, 1, (1, 2, 100, 200)),
    (16, 2, None, (0, 16, 17, 32)),
    (8, 16385, None, (131072,)),
    (8, 4, 3, (0, 30, 32)),
]


def _valid_slots(pos, p, m, window):
    """The slots that the plain version (gather, then the ring oracle with
    W = M * P) weighs: position < pos and, with a window, >= pos - window."""
    slot = torch.arange(m * p)
    valid = slot < pos
    if window is not None:
        valid &= slot >= pos - window
    return set(torch.nonzero(valid).flatten().tolist())


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("p,m,window,rows", ROWS)
def test_every_valid_slot_is_in_exactly_one_split(p, m, window, rows,
                                                  splits):
    for pos in rows:
        parts = kern.paged_split_slots(pos, p, m, window, splits)
        assert len(parts) == splits
        flat = [s for part in parts for s in part]
        valid = _valid_slots(pos, p, m, window)
        want = valid or set(range(m * p))  # no valid key: every slot
        assert len(flat) == len(set(flat)) == len(want)
        assert set(flat) == want
        assert parts[0]  # the first rank is never empty
        # a rank streams whole 64-slot stages of consecutive slots
        for part in parts:
            assert part == list(range(part[0], part[0] + len(part))) \
                if part else True
        lo, hi, masked = kern.paged_row_slots(pos, p, m, window)
        assert masked == (not valid)
        if valid:
            # pages wholly behind the window (their table entries trimmed
            # to 0) are never streamed
            assert lo == min(valid) and hi == max(valid) + 1
            assert min(flat) // p >= max(0, pos - (window or pos)) // p


def test_rows_with_no_valid_key_stream_every_slot():
    for pos, window in ((0, None), (0, 4), (100, 1)):
        m, p = 3, 8
        if window == 1 and pos == 100:
            # the window starts past the table's last slot
            assert kern.paged_row_slots(pos, p, m, window) == (0, 24, True)
            continue
        parts = kern.paged_split_slots(pos, p, m, window, 2)
        assert sorted(s for part in parts for s in part) == list(range(24))


# ------------------------------------------------------------ walk model


def walk(q, k_pages, v_pages, table, pos, *, k_scale=None, v_scale=None,
         window=None, splits=1, drop_stage=False, merge_short=False,
         p_bf16=False):
    """A torch model of the body's walk: for each (row, KV head), each rank
    streams its stages of paged_split_slots (its last one left out with
    ``drop_stage``) in 16-key chunks, one chunk a warp and stage, each warp
    keeping its own online softmax (exp2 domain, probabilities rounded to
    bf16 with ``p_bf16``, as the body's P V operand is); the row's
    4 x splits warp states merge in rank then warp order (the last rank
    holding keys left out with ``merge_short``, where two or more hold
    keys). Gathered
    keys dequantize to q's dtype, as the plain version's gather does. A
    test helper: nothing on the main path calls it."""
    b, h, d = q.shape
    n, p, kv, _ = k_pages.shape
    m = table.shape[1]
    groups = h // kv
    scale = d ** -0.5 * LOG2E
    tab = table.long().clamp(0, n - 1)
    out = torch.zeros((b, h, d), dtype=torch.float32)
    keys = kern.PAGED_KEYS
    for bi in range(b):
        lo, hi, masked = kern.paged_row_slots(int(pos[bi]), p, m, window)
        n_st = -(-(hi - lo) // keys)
        per = -(-n_st // splits)
        live = -(-n_st // per)
        skip = live - 1 if merge_short and live >= 2 else -1
        for g in range(kv):
            qg = q[bi, g * groups:(g + 1) * groups].float()  # (groups, d)
            states = []  # every warp's (m, l, acc), rank then warp
            for r in range(splits):
                sb = min(n_st, r * per)
                nt = min(n_st, sb + per) - sb
                if drop_stage:
                    nt = max(0, nt - 1)
                end = min(lo + (sb + nt) * keys, hi)
                warps = [[torch.full((groups,), -math.inf),
                          torch.zeros(groups), torch.zeros(groups, d)]
                         for _ in range(4)]
                for st in range(nt):
                    for w in range(4):
                        j0 = lo + (sb + st) * keys + 16 * w
                        if j0 >= end:  # the warp's keys are past the range
                            continue
                        slots = torch.arange(j0, min(j0 + 16, end))
                        rows = tab[bi, slots // p] * p + slots % p

                        def gathered(pages, scales):
                            x = pages.reshape(n * p, kv, d)[rows, g]
                            if scales is not None:
                                x = x.float() * scales.reshape(
                                    n * p, kv)[rows, g, None].float()
                            return x.to(q.dtype).float()

                        kk = gathered(k_pages, k_scale)
                        vv = gathered(v_pages, v_scale)
                        s = (qg @ kk.T) * scale
                        if masked:
                            s = torch.full_like(s, NEG_INF)
                        mw, lw, aw = warps[w]
                        mn = torch.maximum(mw, s.max(dim=1).values)
                        corr = torch.exp2(mw - mn)
                        pr = torch.exp2(s - mn[:, None])
                        lw = lw * corr + pr.sum(dim=1)
                        if p_bf16:
                            pr = pr.to(torch.bfloat16).float()
                        aw = aw * corr[:, None] + pr @ vv
                        warps[w] = [mn, lw, aw]
                if r == skip:
                    warps = [[m, torch.zeros_like(l), a] for m, l, a in warps]
                states += warps
            _, l, acc = _merge(states)
            out[bi, g * groups:(g + 1) * groups] = \
                acc / l.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


def _merge(states):
    """States (m, l, acc) merged in order; one with l = 0 weighs
    nothing."""
    mx = torch.stack([m for m, _, _ in states]).max(dim=0).values
    l_sum = torch.zeros_like(states[0][1])
    acc = torch.zeros_like(states[0][2])
    for m, l, a in states:
        wt = torch.where(l > 0, torch.exp2(m - mx), torch.zeros_like(l))
        l_sum = l_sum + wt * l
        acc = acc + wt[:, None] * a
    return mx, l_sum, acc


B, H, KV, P, M = 3, 6, 2, 16, 20
N = 1 + B * M


def _inputs(d, pages, q_dt, pos, window=None, seed=0, trim=True):
    """Numpy inputs made from a seed for both packages: with ``trim``, the
    table's unused entries 0 (the trash page), and with a window, the
    entries of pages wholly behind it 0, as the engine's trimming leaves
    them; int8 scales from JAX's own paged_quantize."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    k = rng.standard_normal((N, P, KV, d)).astype(np.float32)
    v = rng.standard_normal((N, P, KV, d)).astype(np.float32)
    table = (1 + rng.permutation(N - 1)[:B * M]).reshape(B, M)
    pos = np.asarray(pos, np.int32)
    col = np.arange(M)[None, :]
    if trim:
        table[col >= -(-pos[:, None] // P)] = 0
    if trim and window is not None:
        table[col < np.maximum(pos[:, None] - window, 0) // P] = 0
    table = table.astype(np.int32)
    jdt = jnp.bfloat16 if q_dt == torch.bfloat16 else jnp.float32
    jq = jnp.asarray(q, jdt)
    if pages == "int8":
        jk, jks = j_paged_quantize(jnp.asarray(k), jnp.int8)
        jv, jvs = j_paged_quantize(jnp.asarray(v), jnp.int8)
    else:
        jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
        jks = jvs = None
    jside = (jq, jk, jv, jnp.asarray(table), jnp.asarray(pos), jks, jvs)

    def to_torch(x):
        if x is None:
            return None
        if x.dtype == jnp.bfloat16:
            return torch.from_numpy(np.asarray(x, np.float32)).to(
                torch.bfloat16)
        return torch.from_numpy(np.array(x))

    tside = [to_torch(x) for x in jside]
    tside[0] = tside[0].to(q_dt)
    return jside, tuple(tside)


# rows: pos 0 (no valid key), shorter than one stage, several stages, a
# full table row (M * P = 320 slots: 5 stages)
POS = (0, 37, 320)
WIN_POS = (5, 150, 300)  # with window 100: trimmed pages, a partial stage


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("window,pos", [(None, POS), (100, WIN_POS),
                                        (1, (1, 64, 320))])
@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("d", [8, 64])
def test_walk_matches_plain_within_fp32_rounding(d, pages, window, pos,
                                                 splits):
    """f32 queries (the walk and the plain version both in fp32, the
    gathered keys exact): only the order of the sums differs."""
    _, (q, k, v, tab, ps, ks, vs) = _inputs(d, pages, torch.float32, pos,
                                            window)
    got = walk(q, k, v, tab, ps, k_scale=ks, v_scale=vs, window=window,
               splits=splits)
    want = kern.paged_decode_attention_plain(q, k, v, tab, ps, k_scale=ks,
                                             v_scale=vs, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize("window,pos", [(None, POS), (100, WIN_POS)])
@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("d", [16, 64])
def test_walk_matches_jax(d, pages, window, pos, splits):
    """bf16 queries, as the body takes them, with the body's bf16
    probabilities: the walk against JAX's Pallas kernel in interpret mode
    and its ref path, on the same numpy inputs."""
    (jq, jk, jv, jtab, jpos, jks, jvs), (q, k, v, tab, ps, ks, vs) = \
        _inputs(d, pages, torch.bfloat16, pos, window)
    got = walk(q, k, v, tab, ps, k_scale=ks, v_scale=vs, window=window,
               splits=splits, p_bf16=True)
    want_pl = jdec.paged_decode_attention(
        jq, jk, jv, jtab, jpos, k_scale=jks, v_scale=jvs, window=window,
        interpret=True)
    want_ref = jops.paged_decode_attention(
        jq, jk, jv, jtab, jpos, k_scale=jks, v_scale=jvs, impl="ref",
        window=window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    for want in (want_pl, want_ref):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("splits", [1, 2, 4])
def test_drop_stage_walk_fails(pages, splits):
    _, (q, k, v, tab, ps, ks, vs) = _inputs(64, pages, torch.bfloat16, POS)
    want = kern.paged_decode_attention_plain(q, k, v, tab, ps, k_scale=ks,
                                             v_scale=vs)
    bad = walk(q, k, v, tab, ps, k_scale=ks, v_scale=vs, splits=splits,
               drop_stage=True, p_bf16=True)
    assert float((bad.float() - want.float()).abs().max()) > BF16_TOL


@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("splits", [2, 4, 8])
def test_merge_short_walk_fails_where_two_ranks_hold_keys(pages, splits):
    """Untrimmed tables: a row with no valid key then averages distinct
    pages (through a trimmed table it reads the trash page M times, and
    any subset of its slots has the same mean)."""
    _, (q, k, v, tab, ps, ks, vs) = _inputs(64, pages, torch.bfloat16, POS,
                                            trim=False)
    want = kern.paged_decode_attention_plain(q, k, v, tab, ps, k_scale=ks,
                                             v_scale=vs)
    bad = walk(q, k, v, tab, ps, k_scale=ks, v_scale=vs, splits=splits,
               merge_short=True, p_bf16=True)
    err = (bad.float() - want.float()).abs().amax(dim=(1, 2))
    for row, p in enumerate(POS):
        parts = kern.paged_split_slots(p, P, M, None, splits)
        if sum(1 for part in parts if part) >= 2:
            assert float(err[row]) > BF16_TOL
        else:
            assert float(err[row]) <= BF16_TOL


def test_merge_short_is_a_no_op_with_one_split():
    _, (q, k, v, tab, ps, ks, vs) = _inputs(64, "bf16", torch.bfloat16, POS)
    good = walk(q, k, v, tab, ps, splits=1, p_bf16=True)
    short = walk(q, k, v, tab, ps, splits=1, merge_short=True, p_bf16=True)
    assert torch.equal(good, short)


def test_table_entries_clamp_into_the_pool():
    """Entries past the pool (or negative) read page N - 1 (or 0), as the
    body clamps them; the plain version's gather would raise, so the walk
    is held to itself on the clamped table."""
    _, (q, k, v, tab, ps, _, _) = _inputs(16, "bf16", torch.float32, POS)
    wild = tab.clone()
    wild[1, 0] = N + 5
    wild[2, 1] = -3
    clamped = wild.clamp(0, N - 1)
    np.testing.assert_array_equal(
        walk(q, k, v, wild, ps, splits=2).numpy(),
        walk(q, k, v, clamped, ps, splits=2).numpy())
    want = kern.paged_decode_attention_plain(q, k, v, clamped, ps)
    np.testing.assert_allclose(walk(q, k, v, wild, ps, splits=2).numpy(),
                               want.numpy(), atol=2e-6, rtol=1e-5)


def test_cpu_wrapper_takes_the_plain_version_and_refuses_options():
    _, (q, k, v, tab, ps, _, _) = _inputs(16, "bf16", torch.bfloat16, POS)
    before = dict(kern.decode_launches)
    got = kern.paged_decode_attention(q, k, v, tab, ps)
    assert kern.decode_launches == before
    assert torch.equal(got, kern.paged_decode_attention_plain(q, k, v, tab,
                                                              ps))
    for opt in ({"splits": 2}, {"drop_stage": True}, {"merge_short": True}):
        with pytest.raises(ValueError):
            kern.paged_decode_attention(q, k, v, tab, ps, **opt)
