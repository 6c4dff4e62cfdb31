"""On-card checks of the grouped MoE GEMM's two bf16 bodies
(``csrc/grouped_gemm.cu``: the stream body, weights streamed once per
chunk with K split over the blocks of a cluster; the wgmma body,
persistent 128 x 256 tiles over a TMA ring), skipped without a GPU.

Run on a machine with an H100:
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_grouped_kernel.py

Each body is forced through the plan (``moe_gemm.GroupedPlan``) and held
against ``ref.grouped_matmul_ref`` at the limits tests/test_torch_gpu.py
holds the kernel to (bf16 out: one bf16 step of the largest |value|):
every case of that file's GEMM_CASES, runs longer than a chunk with a
ragged end, K not a multiple of 64 and F not a multiple of 256, every
split count. The two bodies agree within one bf16 step; a repeat is
bitwise equal; -1 tiles are exactly zero; a call is one counted launch
and no host sync; the ids rotated by one expert fail the limit.
"""

import pytest
import torch

from repro_torch.kernels import moe_gemm, ref

pytestmark = pytest.mark.gpu

E = 4
# tests/test_torch_gpu.py's GEMM_CASES: (block_m, tile ids, D, F)
GEMM_CASES = [
    (8, [0, 0, 1, -1, 2, 3, 3, -1], 64, 96),
    (8, [1] * 20 + [0, -1], 96, 32),
    (1, [2, 2, 0, 3, 3, 3, -1, 1], 36, 100),
    (128, [3, 1, -1], 200, 256),
    (64, [0, 0, 0, 2], 128, 130),
    (8, [-1, -1, -1], 64, 96),
]
# runs longer than 64 and 128 rows with ragged ends, -1 runs in the
# middle, ids past E, K not a multiple of 64, F not a multiple of 256
LONG_CASES = [
    (8, [0] * 10 + [1] * 21 + [-1, -1] + [2] * 3 + [7], 200, 424),
    (24, [3] * 7 + [-1] + [0] * 6 + [2], 520, 136),
    (1, [1] * 150 + [0] * 70 + [-1] * 9 + [3] * 3, 72, 264),
]


def _plans(w_dtype):
    """Every body the weight dtype allows, the stream body at every split
    count."""
    plans = [moe_gemm.stream_plan(w_dtype, s) for s in (1, 2, 4, 8)]
    if w_dtype == torch.bfloat16:
        plans.append(moe_gemm.wgmma_plan())
    return plans


def _plan_id(plan):
    return f"{plan.body}{plan.splits if plan.body == 'stream' else ''}"


PLANS = ([("bf16", p) for p in _plans(torch.bfloat16)]
         + [("int8", p) for p in _plans(torch.int8)])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, bm, gids, d, f, wdt, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((bm * len(gids), d), generator=g).to(torch.bfloat16)
    if wdt == "int8":
        w = torch.randint(-127, 128, (E, d, f), generator=g,
                          dtype=torch.int8)
        scale = torch.rand((E,), generator=g) * 0.01 + 1e-3
    else:
        w, scale = torch.randn((E, d, f), generator=g).to(torch.bfloat16), None
    ids = torch.tensor(gids, dtype=torch.int32, device=dev)
    return (x.to(dev), w.to(dev), ids,
            None if scale is None else scale.to(dev))


def _limit(want):
    big = float(want.float().abs().max()) if want.numel() else 0.0
    return 2 ** -7 * big + 1e-6


def _run(plan, x, w, ids, scale):
    before = moe_gemm.launches["grouped_matmul"]
    got = moe_gemm.grouped_matmul(x, w, ids, w_scale=scale, plan=plan)
    assert moe_gemm.launches["grouped_matmul"] == before + 1
    return got


def test_built_shapes_are_the_wrappers(cuda):
    ch, bk = moe_gemm.STREAM
    for wdt in (torch.bfloat16, torch.int8):
        cols, stages = moe_gemm.STREAM_SHAPE[wdt]
        built = moe_gemm.built_shape("stream", wdt)
        assert built[:4] == (ch, cols, bk, stages)
        assert built[5] <= 232448
    built = moe_gemm.built_shape("wgmma", torch.bfloat16)
    assert built[:4] == moe_gemm.WGMMA and built[5] <= 232448
    with pytest.raises(ValueError):
        moe_gemm.built_shape("wgmma", torch.int8)
    for m, nb, c in ((64, 8, 64), (312, 39, 64), (9056, 1132, 128),
                     (8, 8, 64), (1000, 8, 64), (384, 3, 128)):
        assert moe_gemm.built_scratch_ints(m, nb, c) == \
            moe_gemm.scratch_ints(m, nb, c)


@pytest.mark.parametrize("wdt,plan", PLANS,
                         ids=[f"{w}-{_plan_id(p)}" for w, p in PLANS])
@pytest.mark.parametrize("bm,gids,d,f", GEMM_CASES + LONG_CASES)
def test_body_matches_plain(cuda, wdt, plan, bm, gids, d, f):
    x, w, ids, scale = _inputs(cuda, bm, gids, d, f, wdt,
                               len(gids) * d + f)
    got = _run(plan, x, w, ids, scale)
    want = ref.grouped_matmul_ref(x, w, ids, w_scale=scale)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    err = float((got.float() - want.float()).abs().max())
    assert err <= _limit(want), err
    rows = got.reshape(len(gids), bm, f)[torch.tensor(gids) < 0]
    assert bool((rows == 0).all())
    # one fixed summation order: bit-reproducible
    assert torch.equal(_run(plan, x, w, ids, scale), got)


def test_bodies_agree(cuda):
    bm, gids, d, f = LONG_CASES[0]
    x, w, ids, _ = _inputs(cuda, bm, gids, d, f, "bf16", 1)
    stream, wgmma = _plans(torch.bfloat16)[1], _plans(torch.bfloat16)[-1]
    a = _run(stream, x, w, ids, None).float()
    b = _run(wgmma, x, w, ids, None).float()
    big = float(torch.maximum(a.abs().max(), b.abs().max()))
    assert float((a - b).abs().max()) <= 2 ** -7 * big


@pytest.mark.parametrize("wdt", ["bf16", "int8"])
def test_one_launch_and_no_host_sync(cuda, wdt):
    """At Mixtral's decode widths cut to 2 experts: the planned call is
    one counted launch, with any host sync an error."""
    bm, gids, d, f = 8, [0, 1, -1, -1], 6144, 2048
    x, w, ids, scale = _inputs(cuda, bm, gids, d, f, wdt, 2)
    torch.cuda.synchronize()
    before = moe_gemm.launches["grouped_matmul"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = moe_gemm.grouped_matmul(x, w, ids, w_scale=scale)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert moe_gemm.launches["grouped_matmul"] == before + 1
    want = ref.grouped_matmul_ref(x, w, ids, w_scale=scale)
    assert float((got.float() - want.float()).abs().max()) <= _limit(want)


@pytest.mark.parametrize("wdt,plan", PLANS,
                         ids=[f"{w}-{_plan_id(p)}" for w, p in PLANS])
def test_rotated_ids_fail_the_limit(cuda, wdt, plan):
    """A planted fault: the ids rotated by one expert must not pass."""
    bm, gids, d, f = LONG_CASES[0]
    x, w, ids, scale = _inputs(cuda, bm, gids, d, f, wdt, 3)
    want = ref.grouped_matmul_ref(x, w, ids, w_scale=scale)
    bad = torch.where(ids >= 0, (ids + 1) % E, ids)
    got = _run(plan, x, w, bad, scale)
    assert float((got.float() - want.float()).abs().max()) > _limit(want)
