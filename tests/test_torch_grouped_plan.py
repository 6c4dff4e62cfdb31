"""CPU checks of the grouped MoE GEMM's launch plan (kernels/moe_gemm.py):
which body ``grouped_plan`` picks at the serving shapes, its K splits, the
Python mirrors of the kernel's chunk table and work walks, and the padding
that gives TMA rows of whole 16-byte chunks. The kernel itself runs only on
the card (tests/test_torch_grouped_kernel.py)."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import moe_gemm as mg
from repro_torch.kernels import ref
from repro_torch.models.moe import GROUPED_BLOCK_M

SMS = 132  # the H100's SM count


def _rows(t, k, e, bm=GROUPED_BLOCK_M):
    """(M, nb) of the dispatch plan for t tokens routed top-k over e
    experts (models/moe.py::grouped_dispatch_plan's worst case)."""
    m = -(-(t * k + e * (bm - 1)) // bm) * bm
    return m, m // bm


# (label, tokens, top-k, experts, D, F, the bf16 body the plan must pick)
SERVING = [
    ("mixtral decode up", 4, 2, 8, 6144, 16384, "stream"),
    ("mixtral decode down", 4, 2, 8, 16384, 6144, "stream"),
    ("mixtral chunk up", 128, 2, 8, 6144, 16384, "wgmma"),
    ("mixtral chunk down", 128, 2, 8, 16384, 6144, "wgmma"),
    ("mixtral prompt up", 4500, 2, 8, 6144, 16384, "wgmma"),
    ("mixtral prompt down", 4500, 2, 8, 16384, 6144, "wgmma"),
    ("jamba decode up", 4, 2, 16, 4096, 14336, "stream"),
    ("jamba decode down", 4, 2, 16, 14336, 4096, "stream"),
    ("kimi-k2 decode up", 4, 8, 384, 7168, 2048, "stream"),
    ("kimi-k2 decode down", 4, 8, 384, 2048, 7168, "stream"),
    ("mixtral decode up, 8 tokens", 8, 2, 8, 6144, 16384, "stream"),
    ("mixtral smoke", 10, 2, 4, 64, 96, "wgmma"),
    ("mixtral smoke decode", 2, 2, 4, 64, 96, "stream"),
]


@pytest.mark.parametrize("label,t,k,e,d,f,body", SERVING,
                         ids=[s[0] for s in SERVING])
def test_body_at_serving_shapes(label, t, k, e, d, f, body):
    m, nb = _rows(t, k, e)
    plan = mg.grouped_plan(torch.bfloat16, torch.bfloat16, m, nb, d, f, e,
                           SMS)
    assert plan.body == body
    assert (plan.body == "wgmma") == (m / min(e, nb) >= mg.WGMMA_MIN_ROWS)
    want = mg.wgmma_plan() if body == "wgmma" else \
        mg.stream_plan(torch.bfloat16, plan.splits)
    assert plan == want
    # int8 weights always stream, at their own shape; f32 takes its body
    q = mg.grouped_plan(torch.bfloat16, torch.int8, m, nb, d, f, e, SMS)
    assert q == mg.stream_plan(torch.int8, q.splits)
    for wdt in (torch.float32, torch.int8):
        assert mg.grouped_plan(torch.float32, wdt, m, nb, d, f, e,
                               SMS).body == "fma"


@pytest.mark.parametrize("t", [1, 4, 16, 64, 128, 300])
@pytest.mark.parametrize("d,f,e", [(6144, 16384, 8), (16384, 6144, 8),
                                   (4096, 14336, 16), (7168, 2048, 384),
                                   (64, 96, 4), (200, 424, 4)])
def test_splits_are_a_power_of_two_at_most_8(t, d, f, e):
    m, nb = _rows(t, 2, e)
    plan = mg.grouped_plan(torch.bfloat16, torch.int8, m, nb, d, f, e, SMS)
    s = plan.splits
    assert s in (1, 2, 4, 8)
    nk = -(-d // mg.STREAM[1])
    if s > 1:  # every split keeps its share of K tiles
        assert nk >= s * mg.STREAM_MIN_K_TILES
    # no split where one unit a cluster-round is already reached
    experts = min(e, nb)
    units = experts * max(1, -(-(m // experts) // mg.STREAM[0])) \
        * -(-f // 128)
    if units >= mg.STREAM_ROUNDS * SMS:
        assert s == 1


# (block_m, tile ids): unsorted ids, -1 runs in the middle, ids past E,
# runs longer than a chunk
IDS = [
    (1, [2, 2, 0, 3, 3, 3, -1, 1]),
    (8, [0] * 10 + [1] * 21 + [-1, -1] + [2] * 3 + [7]),
    (8, [3, -1, 3, 3, 9, 0, -1, -1, 0, 1] * 7),
    (64, [0, 0, 0, 2, -1, 5, 5]),
    (128, [3, 1, -1, 1, 1, 2]),
    (1, [1] * 150 + [0] * 70 + [-1] * 9 + [3] * 3),
    (8, [-1, -1, -1]),
]
E = 4


def _random_ids(seed, nb):
    rng = np.random.default_rng(seed)
    return rng.integers(-1, E + 2, size=nb).tolist()


CASES = IDS + [(bm, _random_ids(bm * 31 + nb, nb))
               for bm in (1, 8, 64, 128) for nb in (1, 17, 300)]


@pytest.mark.parametrize("ch", [64, 128])
@pytest.mark.parametrize("bm,ids", CASES)
def test_chunk_table_covers_every_row_once(bm, ids, ch):
    live, zero = mg.chunk_table(ids, bm, E, ch)
    m, nb = bm * len(ids), len(ids)
    seen = np.zeros(m, dtype=np.int64)
    row_id = np.repeat(np.array(ids), bm)
    for row0, rows, g in live:
        assert 0 < rows <= ch
        seen[row0:row0 + rows] += 1
        run = row_id[row0:row0 + rows]
        assert (run == run[0]).all() and run[0] >= 0  # one run a chunk
        assert g == min(int(run[0]), E - 1)
    for row0, rows in zero:
        assert 0 < rows <= ch
        seen[row0:row0 + rows] += 1
        assert (row_id[row0:row0 + rows] < 0).all()
    assert (seen == 1).all()
    cap = mg.chunk_cap(m, nb, ch)
    assert len(live) <= cap and len(zero) <= cap
    assert mg.scratch_ints(m, nb, ch) == 4 * (1 + 2 * cap) + 2 * (nb + 1)


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("bm,ids", CASES)
def test_stream_walk_covers_every_output_and_k_once(bm, ids, splits):
    """Every output element of every live chunk is summed once, from every
    K index exactly once among a cluster's splits; zero chunks cover the
    rest."""
    f, nk = 300, 5  # 3 F-tiles (the last ragged); 5 K tiles
    cols = mg.STREAM_SHAPE[torch.bfloat16][0]
    tiles_f = -(-f // cols)
    live, zero = mg.chunk_table(ids, bm, E, mg.STREAM[0])
    m = bm * len(ids)
    cover = np.zeros((m, f), dtype=np.int64)
    for clusters in (1, 3, SMS // splits):
        cover[:] = 0
        walk = mg.stream_walk(len(live), tiles_f, clusters)
        units = [u for c in walk for u in c]
        assert sorted(units) == [(c, n) for c in range(len(live))
                                 for n in range(tiles_f)]
        for c, n in units:
            k_seen = np.zeros(nk, dtype=np.int64)
            for rank in range(splits):
                kb, ke = mg.split_range(nk, splits, rank)
                k_seen[kb:ke] += 1
            assert (k_seen == 1).all()
            row0, rows, _ = live[c]
            cover[row0:row0 + rows, n * cols:(n + 1) * cols] += 1
        for row0, rows in zero:
            cover[row0:row0 + rows] += 1
        assert (cover == 1).all()


@pytest.mark.parametrize("bm,ids", CASES)
def test_wgmma_walk_covers_every_item_once(bm, ids):
    live, _ = mg.chunk_table(ids, bm, E, mg.WGMMA[0])
    tiles_n = 3
    for sms in (1, 7, SMS):
        walk = mg.wgmma_walk(len(live), tiles_n, sms)
        assert len(walk) == sms
        items = [it for block in walk for it in block]
        assert sorted(items) == [(c, n) for c in range(len(live))
                                 for n in range(tiles_n)]
        # a block's items come in walk order: positions b, b + sms, ...
        for b, block in enumerate(walk):
            assert len(block) == len(range(b, len(items), sms))


def test_wgmma_walk_keeps_eight_chunks_on_a_column():
    """The walk goes down groups of 8 chunks before it moves a column, so
    the blocks running at once share the weight panels of few F-tiles."""
    walk = mg.wgmma_walk(20, 5, 1)[0]
    assert walk[:8] == [(c, 0) for c in range(8)]
    assert walk[8:16] == [(c, 1) for c in range(8)]
    assert walk[40:48] == [(c, 0) for c in range(8, 16)]
    assert walk[80:84] == [(c, 0) for c in range(16, 20)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("cols", [1, 36, 100, 130, 96, 256])
def test_tma_rows_pads_whole_16_byte_rows(dtype, cols):
    t = torch.arange(3 * 5 * cols).reshape(3, 5, cols).remainder(
        100).to(dtype)
    p = mg.tma_rows(t)
    unit = 16 // t.element_size()
    if cols % unit == 0:
        assert p is t
    assert p.is_contiguous() and p.shape[-1] % unit == 0
    assert p.shape[-1] - cols < unit
    assert torch.equal(p[..., :cols], t)
    assert not bool(p[..., cols:].any())


@pytest.mark.parametrize("bm,ids,d,f", [(1, [2, 2, 0, 3, 3, 3, -1, 1], 36, 100),
                                        (64, [0, 0, 0, 2], 128, 130),
                                        (8, [1, -1, 0], 20, 7)])
@pytest.mark.parametrize("wdt", [torch.bfloat16, torch.int8])
def test_padded_operands_give_the_plain_result(bm, ids, d, f, wdt):
    """What the bf16 bodies multiply (x and w with zero columns appended;
    K past D reads zeros, never the pad) gives grouped_matmul_ref's result:
    exactly, on small integers, whose products and sums are exact."""
    rng = np.random.default_rng(d * f)
    x = torch.from_numpy(rng.integers(-3, 4, (bm * len(ids), d)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.integers(-3, 4, (E, d, f)).astype(
        np.float32)).to(wdt)
    scale = torch.full((E,), 0.5) if wdt == torch.int8 else None
    gids = torch.tensor(ids, dtype=torch.int32)
    want = ref.grouped_matmul_ref(x, w, gids, w_scale=scale)
    xp, wp = mg.tma_rows(x), mg.tma_rows(w)
    # the kernel's view: x's pad columns pair with zero rows of K
    wk = torch.nn.functional.pad(wp, (0, 0, 0, xp.shape[1] - d))
    got = ref.grouped_matmul_ref(xp, wk, gids, w_scale=scale)[:, :f]
    assert torch.equal(got, want)
