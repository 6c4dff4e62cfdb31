"""On-card checks of the paged span kernel (``csrc/paged_span_attention.cu``),
skipped without a GPU.

Run on a machine with an H100:
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_span_kernel.py

bf16 queries over bf16 or int8 pages go through the span kernel and are
held against ``paged_decode_span_attention_plain`` on the same card: max
|error| within 2e-2 and, row by row, within FLASH_ROW_C bf16 steps (2^-8)
of the row's largest |value|, as chip_smoke.py holds the flash kernel. The
kernel's probabilities enter the PV product in bf16 where the plain
version's stay in f32, and both round the output to bf16. The kernel run
with the window one key off (a planted fault) must fail the row limit."""

import pytest
import torch

from repro_torch.kernels import decode_attention as kern
from repro_torch.kernels import ref
from repro_torch.models.blocks import paged_quantize

pytestmark = pytest.mark.gpu

TOL = 2e-2
FLASH_ROW_C = ref.FLASH_ROW_C  # the row limit chip_smoke.py holds too
_row_steps = ref.row_steps


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, *, b, t, groups, d, p, pages, window=None, kv=2, pos=None,
            m=None, seed=0):
    """Pages of random keys behind random tables; row positions leave room
    for the span. With a window, the table entries of pages wholly behind
    the row's first query's window are 0 (the trash page), as the engine's
    trimming leaves them."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    h = groups * kv
    if m is None:
        m = (t + 300) // p + 1
    n = 1 + b * m
    q = torch.randn((b, t, h, d), generator=g).to(torch.bfloat16)
    k = torch.randn((n, p, kv, d), generator=g)
    v = torch.randn((n, p, kv, d), generator=g)
    ks = vs = None
    if pages == "int8":
        k, ks = paged_quantize(k, torch.int8)
        v, vs = paged_quantize(v, torch.int8)
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    table = (1 + torch.randperm(n - 1, generator=g)[:b * m]).reshape(b, m)
    if pos is None:
        pos = torch.randint(60, m * p - t + 1, (b,), generator=g)
    pos = torch.as_tensor(pos, dtype=torch.int32)
    if window is not None:
        keep = (pos.long() - window + 1).clamp(min=0) // p
        table[torch.arange(m)[None, :] < keep[:, None]] = 0
    table = table.to(torch.int32)
    to = lambda x: None if x is None else x.to(dev)
    return [to(x) for x in (q, k, v, table, pos, ks, vs)]


def _run(q, k, v, table, pos, ks, vs, window):
    before = dict(kern.span_launches)
    got = kern.paged_decode_span_attention(q, k, v, table, pos, k_scale=ks,
                                           v_scale=vs, window=window)
    want = kern.paged_decode_span_attention_plain(
        q, k, v, table, pos, k_scale=ks, v_scale=vs, window=window)
    torch.cuda.synchronize()
    # the span kernel's library ran, not paged_attention.cu's body
    assert kern.span_launches[kern.SPAN_SOURCE] == \
        before[kern.SPAN_SOURCE] + 1
    assert kern.span_launches[kern.SOURCE] == before[kern.SOURCE]
    return got, want


def _assert_close(got, want):
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    err = float((got.float() - want.float()).abs().max())
    steps = _row_steps(got, want)
    assert err <= TOL and steps <= FLASH_ROW_C, (err, steps)


# (pages, page size, window): windows of 40 keys straddle a 64-key tile
PAGE_CASES = [("bf16", 16, None), ("bf16", 8, 40), ("int8", 16, 40),
              ("int8", 8, None)]


@pytest.mark.parametrize("pages,p,window", PAGE_CASES)
@pytest.mark.parametrize("d", [16, 64, 112, 128, 256])
@pytest.mark.parametrize("groups", [1, 3, 6, 7])
@pytest.mark.parametrize("t", [2, 3, 9, 10, 11, 64, 65, 128, 129])
def test_span_kernel_matches_plain(cuda, t, groups, d, pages, p, window):
    ins = _inputs(cuda, b=3, t=t, groups=groups, d=d, p=p, pages=pages,
                  window=window, seed=t * 7 + groups)
    _assert_close(*_run(*ins, window))


@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_one_row_takes_the_split_path(cuda, pages):
    """B = 1 leaves fewer blocks than SMs: the key range is split and the
    partial states merged by the second kernel."""
    q, k, v, table, pos, ks, vs = _inputs(
        cuda, b=1, t=128, groups=7, d=128, p=16, pages=pages, window=None,
        kv=4, m=40)
    splits, _, _ = kern.span_plan(kern._DTYPE_CODE[k.dtype], 1, 128, 28, 4,
                               128, 16, 40, kern._num_sms(cuda.index))
    assert splits > 1
    _assert_close(*_run(q, k, v, table, pos, ks, vs, None))


def test_many_blocks_take_no_split(cuda):
    """Mixtral's heads at B = 8, T = 128: more blocks than SMs, one pass."""
    q, k, v, table, pos, ks, vs = _inputs(
        cuda, b=8, t=128, groups=6, d=128, p=16, pages="bf16", window=200,
        kv=8)
    splits, smem, _ = kern.span_plan(kern._DTYPE_CODE[k.dtype], 8, 128, 48, 8,
                                  128, 16, table.shape[1],
                                  kern._num_sms(cuda.index))
    assert splits == 1 and smem > 48 * 1024
    _assert_close(*_run(q, k, v, table, pos, ks, vs, 200))


@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_wide_table_streams_through_the_ring(cuda, pages):
    """A 128K-token window over 8-slot pages: a table row of 16,400 pages,
    wider than a block's shared memory could hold, whose page ids the
    kernel reads stage by stage."""
    m = 16400
    q, k, v, table, pos, ks, vs = _inputs(
        cuda, b=2, t=9, groups=6, d=128, p=8, pages=pages, window=131072,
        m=m, pos=[m * 8 - 9, 70001])
    _assert_close(*_run(q, k, v, table, pos, ks, vs, 131072))


@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_window_behind_the_table_is_the_uniform_mean(cuda, pages):
    """Every query's window lies wholly behind the end of its table row:
    no slot is valid, so each row is the mean of every slot of the row, as
    in the reference (the block streams all M pages)."""
    q, k, v, table, pos, ks, vs = _inputs(
        cuda, b=2, t=9, groups=6, d=128, p=8, pages=pages, m=6,
        pos=[100, 200])
    got, want = _run(q, k, v, table, pos, ks, vs, 4)
    _assert_close(got, want)
    vg = ref.paged_gather_dequant_ref(v, table, vs, torch.bfloat16)
    mean = vg.float().mean(1)  # (B, KV, D)
    expect = mean.repeat_interleave(6, dim=1)[:, None].expand_as(got)
    torch.testing.assert_close(got.float(), expect, atol=2e-2, rtol=0)


@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_window_off_by_one_fails_the_row_limit(cuda, pages):
    """A planted fault: the kernel run with the window one key short, and
    one key long, must fail the limit the right window passes."""
    q, k, v, table, pos, ks, vs = _inputs(
        cuda, b=3, t=64, groups=6, d=128, p=16, pages=pages, window=40)
    got, want = _run(q, k, v, table, pos, ks, vs, 40)
    _assert_close(got, want)
    for w in (39, 41):
        bad = kern.paged_decode_span_attention(
            q, k, v, table, pos, k_scale=ks, v_scale=vs, window=w)
        assert _row_steps(bad, want) > FLASH_ROW_C


def test_route_keeps_other_spans_on_the_first_body(cuda):
    """f32 queries and head dims the span kernel is not built for launch
    paged_attention.cu's body; the choice is made before the launch."""
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 8),
                     (torch.bfloat16, 32)):
        q, k, v, table, pos, _, _ = _inputs(
            cuda, b=2, t=5, groups=3, d=d, p=8, pages="bf16")
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        before = dict(kern.span_launches)
        got = kern.paged_decode_span_attention(q, k, v, table, pos)
        want = kern.paged_decode_span_attention_plain(q, k, v, table, pos)
        torch.cuda.synchronize()
        assert kern.span_launches[kern.SOURCE] == before[kern.SOURCE] + 1
        assert kern.span_launches[kern.SPAN_SOURCE] == \
            before[kern.SPAN_SOURCE]
        tol = 1e-4 if dtype == torch.float32 else TOL
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


def test_span_wrapper_rejects_bad_inputs(cuda):
    q, k, v, table, pos, ks, vs = _inputs(
        cuda, b=2, t=5, groups=3, d=128, p=8, pages="int8")
    with pytest.raises(ValueError):  # int8 pages without their scales
        kern.paged_decode_span_attention(q, k, v, table, pos)
    with pytest.raises(ValueError):
        kern.paged_decode_span_attention(q, k, v, table.long(), pos,
                                         k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError):
        kern.paged_decode_span_attention(q, k, v, table, pos, k_scale=ks,
                                         v_scale=vs, window=0)
