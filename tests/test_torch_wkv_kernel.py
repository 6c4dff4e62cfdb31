"""On-card checks of the chunked RWKV-6 WKV kernel's bodies
(``csrc/rwkv_wkv.cu``: the state pass plus the chunk-parallel output pass,
the one-pass body and the streaming decode body), skipped without a GPU.

Run on a machine with an H100:
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_wkv_kernel.py

Each body is forced through the plan (``rwkv_scan.make_plan``) and held
against ``rwkv_scan.chunked_wkv_plain`` on the same card, out and the final
state within WKV_LIMIT = 1e-5 of the case's largest |value| (at least 1):
f32 sums in another order, and the cumulative log decay's rounding, which
the factors exp(cum_excl) and exp(-cum) (up to e^64 at chunk 16) carry;
tests/test_torch_gpu.py holds the planned call to the same limit. The
split body runs at several G, groups not dividing the chunks included. A
multi-group span from a nonzero state written in place over it equals the
out-of-place call bit for bit; a repeat is bitwise equal; a zero front
pad keeps out and the state exactly 0; the kernel without the
current-token bonus, and the output pass started one group behind, fail
the limit. A call is one counted launch whatever it runs.
"""

import pytest
import torch

from repro_torch.kernels import rwkv_scan

pytestmark = pytest.mark.gpu

WKV_LIMIT = 1e-5
# (B, S, H, hd, chunk, nonzero s0): chip_smoke.py's shapes (rwkv6's 32
# heads x 64: a bucketed prefill, spans, decode; the smoke width hd 16),
# generate_pertoken's 97-token prompt at chunk 1, chunks 9, 10, 13 and 15,
# a 4096-token prompt, hd 16 over more than one group, and 8 rows of 2
# chunks (the plan's one pass where the split's G would take every chunk)
CASES = {
    "prefill_1024": (1, 1024, 32, 64, 16, False),
    "batch4_s16": (4, 16, 32, 64, 16, True),
    "s8_chunk8": (2, 8, 32, 64, 8, True),
    "s13_chunk13": (2, 13, 32, 64, 13, True),
    "decode": (4, 1, 32, 64, 1, True),
    "smoke_hd16": (2, 48, 4, 16, 16, True),
    "s97_chunk1": (1, 97, 32, 64, 1, True),
    "s200_chunk10": (1, 200, 32, 64, 10, True),
    "s270_chunk9": (2, 270, 4, 64, 9, True),
    "s150_chunk15": (1, 150, 4, 64, 15, True),
    "s4096": (1, 4096, 2, 64, 16, False),
    "hd16_groups": (2, 80, 4, 16, 16, True),
    "b8_two_chunks": (8, 32, 32, 64, 16, True),
}


def _plans(b, s, h, hd, chunk):
    """The plan's own choice, the one-pass body, the split body at G = 1,
    2, 3 and 8 (those with more than one group), and decode at S 1."""
    nc = s // chunk
    plans = {"planned": rwkv_scan.wkv_plan(b, s, h, hd, chunk),
             "onepass": rwkv_scan.make_plan("onepass", b, s, h, hd, chunk)}
    if s == 1:
        plans["decode"] = rwkv_scan.make_plan("decode", b, s, h, hd, chunk)
    for g in (1, 2, 3, 8):
        if g < nc or g == 1:
            plans[f"split{g}"] = rwkv_scan.make_plan(
                "split", b, s, h, hd, chunk, group=g)
    return plans


CASE_PLANS = [(case, name) for case in sorted(CASES)
              for name in _plans(*CASES[case][:5])]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, b, s, h, hd, with_s0, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    r, k, v = (torch.randn((b, s, h, hd), generator=g) for _ in range(3))
    lw = torch.clamp(-torch.exp(torch.randn((b, s, h, hd), generator=g)),
                     -4.0, 0.0)
    u = torch.randn((h, hd), generator=g) * 0.5
    s0 = (torch.randn((b, h, hd, hd), generator=g) * 0.3 if with_s0
          else None)
    return [None if x is None else x.to(dev) for x in (r, k, v, lw, u, s0)]


def _err(got, want):
    """max |got - want| over max(1, max |want|)."""
    return float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


def _run(plan, *args, chunk, **kw):
    before = rwkv_scan.launches["rwkv_wkv"]
    got = rwkv_scan.rwkv_wkv(*args, chunk=chunk, plan=plan, **kw)
    assert rwkv_scan.launches["rwkv_wkv"] == before + 1
    return got


@pytest.mark.parametrize("case,name", CASE_PLANS)
def test_body_matches_plain(cuda, case, name):
    b, s, h, hd, chunk, with_s0 = CASES[case]
    plan = _plans(b, s, h, hd, chunk)[name]
    r, k, v, lw, u, s0 = _inputs(cuda, b, s, h, hd, with_s0, seed=s + hd)
    out, sf = _run(plan, r, k, v, lw, u, s0, chunk=chunk)
    want, wsf = rwkv_scan.chunked_wkv_plain(r, k, v, lw, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert _err(out, want) <= WKV_LIMIT
    assert _err(sf, wsf) <= WKV_LIMIT
    again, sf2 = _run(plan, r, k, v, lw, u, s0, chunk=chunk)
    assert torch.equal(again, out) and torch.equal(sf2, sf)


@pytest.mark.parametrize("case,name", CASE_PLANS)
def test_planted_faults_fail(cuda, case, name):
    b, s, h, hd, chunk, with_s0 = CASES[case]
    plan = _plans(b, s, h, hd, chunk)[name]
    r, k, v, lw, u, s0 = _inputs(cuda, b, s, h, hd, with_s0, seed=s + hd)
    want, _ = rwkv_scan.chunked_wkv_plain(r, k, v, lw, u, s0, chunk=chunk)
    bad, _ = _run(plan, r, k, v, lw, u, s0, chunk=chunk, skip_bonus=True)
    assert _err(bad, want) > WKV_LIMIT
    stale, _ = _run(plan, r, k, v, lw, u, s0, chunk=chunk, stale_state=True)
    if plan.body == "split" and (plan.n_groups > 1 or s0 is not None):
        # a later group one behind; group 0 from zeros, not from s0
        assert _err(stale, want) > WKV_LIMIT
    else:  # one group from zeros, or one pass: a no-op
        good, _ = _run(plan, r, k, v, lw, u, s0, chunk=chunk)
        assert torch.equal(stale, good)


@pytest.mark.parametrize("group", [1, 3, 4])
def test_in_place_multi_group_span_is_bitwise_out_of_place(cuda, group):
    """A 256-token span from a nonzero state, the final state written over
    it (the serving cache row): the same bits as out of place."""
    b, s, h, hd, chunk = 4, 256, 32, 64, 16
    r, k, v, lw, u, s0 = _inputs(cuda, b, s, h, hd, True, seed=7)
    plan = rwkv_scan.make_plan("split", b, s, h, hd, chunk, group=group)
    assert plan.n_groups > 1
    out, sf = _run(plan, r, k, v, lw, u, s0, chunk=chunk)
    st = s0.clone()
    out2, sf2 = _run(plan, r, k, v, lw, u, st, chunk=chunk, state_out=st)
    torch.cuda.synchronize()
    assert sf2 is st and torch.equal(out2, out) and torch.equal(st, sf)
    want, wsf = rwkv_scan.chunked_wkv_plain(r, k, v, lw, u, s0, chunk=chunk)
    assert _err(out, want) <= WKV_LIMIT and _err(sf, wsf) <= WKV_LIMIT


@pytest.mark.parametrize("body", ["onepass", "decode"])
def test_in_place_one_group_is_bitwise_out_of_place(cuda, body):
    b, s, h, hd, chunk = (4, 1, 32, 64, 1) if body == "decode" else (
        4, 16, 32, 64, 16)
    r, k, v, lw, u, s0 = _inputs(cuda, b, s, h, hd, True, seed=8)
    plan = rwkv_scan.make_plan(body, b, s, h, hd, chunk)
    out, sf = _run(plan, r, k, v, lw, u, s0, chunk=chunk)
    st = s0.clone()
    out2, _ = _run(plan, r, k, v, lw, u, st, chunk=chunk, state_out=st)
    torch.cuda.synchronize()
    assert torch.equal(out2, out) and torch.equal(st, sf)


@pytest.mark.parametrize("body,group", [("split", 1), ("split", 4),
                                        ("onepass", None)])
def test_front_pad_keeps_zeros_exact(cuda, body, group):
    b, s, h, hd, chunk = 1, 256, 32, 64, 16
    r, k, v, lw, u, _ = _inputs(cuda, b, s, h, hd, False, seed=4)
    for x in (r, k, v):
        x[:, :s // 2] = 0.0
    plan = rwkv_scan.make_plan(body, b, s, h, hd, chunk, group=group)
    out, _ = _run(plan, r, k, v, lw, u, chunk=chunk)
    assert torch.all(out[:, :s // 2] == 0)
    head = [x[:, :s // 2].contiguous() for x in (r, k, v, lw)]
    hplan = rwkv_scan.make_plan(body, b, s // 2, h, hd, chunk, group=group)
    _, head_s = _run(hplan, *head, u, chunk=chunk)
    assert torch.all(head_s == 0)


@pytest.mark.parametrize("case,name", CASE_PLANS)
def test_built_grids_are_the_plans(cuda, case, name):
    b, s, h, hd, chunk, _ = CASES[case]
    plan = _plans(b, s, h, hd, chunk)[name]
    got = rwkv_scan.built_grids(plan, b, s, h, hd, chunk)
    assert tuple(got[4:7]) == plan.grid
    if plan.body == "split":  # the state pass on the output pass's grid
        assert tuple(got[:3]) == plan.grid
        assert tuple(got[9:12]) == plan.scan_grid
        # the scan's threads cover a head's state, a float4 each
        assert got[9] * got[12] * 4 == hd * hd
    else:
        assert tuple(got[:4]) == (0, 0, 0, 0) and tuple(got[9:]) == (0,) * 4
    assert got[8] <= 232448


def test_refused_plans_raise(cuda):
    r, k, v, lw, u, s0 = _inputs(cuda, 1, 64, 2, 64, True)
    bad = rwkv_scan.make_plan("split", 1, 64, 2, 64, 16, group=2)
    with pytest.raises(RuntimeError, match="cudaError"):
        _run(bad._replace(n_groups=1), r, k, v, lw, u, s0, chunk=16)
    with pytest.raises(RuntimeError, match="cudaError"):
        _run(rwkv_scan.make_plan("decode", 1, 1, 2, 64, 1), r, k, v, lw, u,
             s0, chunk=16)
    with pytest.raises(ValueError):
        rwkv_scan.make_plan("decode", 1, 64, 2, 64, 16)
