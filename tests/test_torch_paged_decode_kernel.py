"""On-card checks of the bf16 paged one-token decode body
(``csrc/paged_decode_attention.cu``: page-gathered K/V through a cp.async
ring, mma.sync with the softmax in registers, a row's key-range splits
merged in one thread-block cluster), skipped without a GPU.

Run on a machine with an H100:
    PYTHONPATH=src python -m pytest -q -m gpu \
        tests/test_torch_paged_decode_kernel.py

Each call is held against ``paged_decode_attention_plain`` (gather, then
the ring oracle) within TOL and within one bf16 step of each row's largest
|value| (both sides round an fp32 result to bf16; the body also rounds the
probabilities to bf16 for the P V product; int8 pages dequantize to the
same bf16 values on both sides). Shapes: bf16 and int8 pages at D 8, 64,
112, 128 and 256, GQA groups of 1, 6, 7 and 16, with and without a window
(pages behind it trimmed to the trash page, as the engine leaves them); a
table row of 16,385 pages; rows with no valid key (the uniform mean); every
split count. A repeat is bitwise equal; a call is one kernel launch and
allocates only its output; decode_source pins the route, f32 staying on
paged_attention.cu; both planted faults fail TOL where they apply.
"""

import pytest
import torch

from repro_torch.kernels import decode_attention as kern
from repro_torch.models.blocks import paged_quantize

pytestmark = pytest.mark.gpu

TOL = 2e-2  # chip_smoke.py's TOL for bf16 and int8 pages


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _steps(got, want):
    """max |got - want| in bf16 steps of its row's largest |want|."""
    err = (got.float() - want.float()).abs()
    top = want.float().abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    return float((err / torch.exp2(torch.floor(torch.log2(top)) - 7)).max())


def _inputs(dev, pages, h, kv, d, ctxs, *, p=16, window=None, trim=True,
            seed=3):
    """q (B,H,D) bf16, (N,P,KV,D) pages (int8 with bf16 scales), a table
    whose rows hold their contexts' pages (unused entries 0, and with
    ``trim`` and a window, the pages wholly behind it 0) and pos = the
    contexts."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    b = len(ctxs)
    m = max(ctxs) // p + 1
    n = 1 + b * m
    q = torch.randn((b, h, d), generator=g).to(torch.bfloat16)
    kf = torch.randn((n, p, kv, d), generator=g)
    vf = torch.randn((n, p, kv, d), generator=g)
    ks = vs = None
    if pages == "int8":
        k, ks = paged_quantize(kf, torch.int8)
        v, vs = paged_quantize(vf, torch.int8)
    else:
        k, v = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
    table = (1 + torch.randperm(n - 1, generator=g)[:b * m]).reshape(b, m)
    pos = torch.tensor(ctxs, dtype=torch.int32)
    col = torch.arange(m)[None, :]
    if trim:
        table[col >= ((pos + p - 1) // p)[:, None]] = 0
    if trim and window is not None:
        table[col < ((pos - window).clamp(min=0) // p)[:, None]] = 0
    to = lambda x: None if x is None else x.to(dev)
    return (to(q), to(k), to(v), to(table.int().contiguous()), to(pos),
            to(ks), to(vs))


def _run(args, window=None, **kw):
    q, k, v, table, pos, ks, vs = args
    return kern.paged_decode_attention(q, k, v, table, pos, k_scale=ks,
                                       v_scale=vs, window=window, **kw)


def _plain(args, window=None):
    q, k, v, table, pos, ks, vs = args
    return kern.paged_decode_attention_plain(q, k, v, table, pos,
                                             k_scale=ks, v_scale=vs,
                                             window=window)


def _held(got, want):
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    assert float((got.float() - want.float()).abs().max()) <= TOL
    assert _steps(got, want) <= 1.0


def test_built_ring_is_the_wrappers(cuda):
    for page_dt in (torch.bfloat16, torch.int8):
        for dp in (16, 32, 64, 128, 256):
            keys, stages, most, smem = kern.built_paged_ring(page_dt, dp)
            assert keys == kern.PAGED_KEYS
            assert most == kern.PAGED_MAX_SPLITS
            assert (stages, smem) == kern.paged_decode_ring(
                dp, page_dt == torch.int8)


CTXS = (1, 40, 300, 1000)  # shorter than a stage, several, many


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("groups", [1, 6, 7, 16])
@pytest.mark.parametrize("d", [8, 64, 112, 128, 256])
@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_body_matches_plain(cuda, pages, d, groups, window):
    kv = 2
    args = _inputs(cuda, pages, groups * kv, kv, d, CTXS, window=window)
    before = dict(kern.decode_launches)
    got = _run(args, window)
    want = _plain(args, window)
    torch.cuda.synchronize()
    assert kern.decode_launches[kern.PAGED_DECODE_SOURCE] == \
        before[kern.PAGED_DECODE_SOURCE] + 1
    _held(got, want)
    # one fixed order of every sum: bit-reproducible
    assert torch.equal(_run(args, window), got)


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_every_split_count_matches_plain(cuda, pages, splits):
    # Mixtral's heads and window over contexts below, at and past it
    args = _inputs(cuda, pages, 48, 8, 128, (1000, 4150, 4400, 4608),
                   window=4096)
    _held(_run(args, 4096, splits=splits), _plain(args, 4096))


@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_a_table_row_of_16385_pages(cuda, pages):
    # phi4-mini's 128K context over the engine's 8-slot pages
    args = _inputs(cuda, pages, 24, 8, 128, (131072,), p=8)
    assert args[3].shape == (1, 16385)
    _held(_run(args), _plain(args))


@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_rows_with_no_valid_key_get_the_uniform_mean(cuda, pages):
    # pos 0 over untrimmed tables: every slot of the row, distinct pages
    q, k, v, table, _, ks, vs = _inputs(cuda, pages, 24, 8, 128,
                                        (300, 300, 300), trim=False)
    pos = torch.zeros(3, dtype=torch.int32, device=cuda)
    args = (q, k, v, table, pos, ks, vs)
    got = _run(args)
    want = _plain(args)
    _held(got, want)
    kg = kern.ref.paged_gather_dequant_ref(v, table, vs, torch.bfloat16)
    mean = kg.float().mean(dim=1).repeat_interleave(3, dim=1)
    assert _steps(got, mean.to(torch.bfloat16)) <= 1.0


def test_a_call_is_one_kernel_and_allocates_only_its_output(cuda):
    args = _inputs(cuda, "bf16", 48, 8, 128, (1000, 4150, 4400, 4608),
                   window=4096)
    _run(args, 4096)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    _run(args, 4096)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == \
        allocs + 1
    names = _kernels_of(lambda: _run(args, 4096))
    assert set(names) == {n for n in names if "paged_decode_kernel" in n}
    assert 1 <= len(names) <= CALLS, names


CALLS = 5


def _kernels_of(fn):
    """The device kernels of CALLS calls of ``fn`` under torch.profiler.
    A session may lose a device event, most often its first: it opens with
    a marker fill of its own, which is left out."""
    marker = torch.empty(4096, dtype=torch.uint8, device="cuda")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        marker.zero_()
        torch.cuda.synchronize()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    names = []
    for e in prof.key_averages():
        if ("CUDA" in str(getattr(e, "device_type", ""))
                and "FillFunctor<unsigned char>" not in e.key):
            names += [e.key] * e.count
    return names


def test_route_is_pinned_by_decode_source(cuda):
    """bf16 queries over bf16 or int8 pages launch the body; f32 queries or
    pages stay on paged_attention.cu, which takes none of the body's
    options."""
    for pages in ("bf16", "int8"):
        q, k, v, table, pos, ks, vs = _inputs(cuda, pages, 14, 2, 64, CTXS)
        assert kern.decode_source(q.dtype, k.dtype, 64, 7) == \
            kern.PAGED_DECODE_SOURCE
        before = dict(kern.decode_launches)
        _run((q, k, v, table, pos, ks, vs))
        assert kern.decode_launches[kern.PAGED_DECODE_SOURCE] == \
            before[kern.PAGED_DECODE_SOURCE] + 1
        assert kern.decode_launches[kern.SOURCE] == before[kern.SOURCE]
    q, k, v, table, pos, _, _ = _inputs(cuda, "bf16", 14, 2, 64, CTXS)
    qf, kf, vf = q.float(), k.float(), v.float()
    assert kern.decode_source(qf.dtype, kf.dtype, 64, 7) == kern.SOURCE
    before = dict(kern.decode_launches)
    got = kern.paged_decode_attention(qf, kf, vf, table, pos)
    assert kern.decode_launches[kern.SOURCE] == before[kern.SOURCE] + 1
    assert kern.decode_launches[kern.PAGED_DECODE_SOURCE] == \
        before[kern.PAGED_DECODE_SOURCE]
    want = kern.paged_decode_attention_plain(qf, kf, vf, table, pos)
    assert float((got - want).abs().max()) <= 1e-4
    with pytest.raises(ValueError):
        kern.paged_decode_attention(qf, kf, vf, table, pos, drop_stage=True)


# contexts whose every rank holds two or more stages at 4 splits (Mixtral's
# heads: 32 blocks take 4), and a window
FAULT_CTXS = (600, 900, 1500, 2000)


@pytest.mark.parametrize("window", [None, 700])
@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_drop_stage_fails(cuda, pages, window):
    args = _inputs(cuda, pages, 48, 8, 128, FAULT_CTXS, window=window)
    want = _plain(args, window)
    bad = _run(args, window, drop_stage=True)
    assert float((bad.float() - want.float()).abs().max()) > TOL


@pytest.mark.parametrize("window", [None, 700])
@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_merge_short_fails_where_two_ranks_hold_keys(cuda, pages, window):
    args = _inputs(cuda, pages, 48, 8, 128, FAULT_CTXS, window=window)
    want = _plain(args, window)
    splits = kern.paged_decode_plan(4, 8, 6, 128, 16, args[3].shape[1],
                                    kern._num_sms(cuda.index),
                                    args[1].dtype).splits
    assert splits >= 2
    bad = _run(args, window, merge_short=True)
    err = (bad.float() - want.float()).abs().amax(dim=(1, 2))
    for row, ctx in enumerate(FAULT_CTXS):
        parts = kern.paged_split_slots(ctx, 16, args[3].shape[1], window,
                                       splits)
        assert sum(1 for part in parts if part) >= 2
        assert float(err[row]) > TOL


def test_merge_short_is_a_no_op_with_one_split(cuda):
    args = _inputs(cuda, "bf16", 48, 8, 128, FAULT_CTXS)
    good = _run(args, splits=1)
    assert torch.equal(_run(args, splits=1, merge_short=True), good)
