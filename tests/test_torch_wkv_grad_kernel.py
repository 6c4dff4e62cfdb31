"""On-card checks of the WKV backward kernel (``csrc/rwkv_wkv_bwd.cu``) and
of the autograd route through it, skipped without a GPU.

Run on a machine with an H100:
    PYTHONPATH=src python -m pytest -q -m gpu \\
        tests/test_torch_wkv_grad_kernel.py

After each forward body, forced through the plan (one pass, the split body
at G 1, 2 and 8, and the plan's own choice), ``rwkv_wkv_backward`` from
the forward's group states is held against ``wkv_backward_plain`` on the
same card: each of dr, dk, dv, dlogw, du and ds0 within WKV_GRAD_LIMIT of
its largest |value| (at least 1). A repeat is bitwise equal (no atomics);
the planted fault (every group's gradient walk started from zero) fails
the limit wherever there is a later group or a final-state cotangent.
The same checks run at groups of RING - 1, RING and RING + 1 chunks (the
kernels stage chunks in a cp.async ring of RING; the backward walk's first
chunk is the forward walk's last, still staged), after a split forward and
after a one-pass forward of that many chunks, at hd 16 and 64.
``ops.rwkv_wkv`` on CUDA inputs that need a gradient goes through
``WkvFunction``: an rwkv6 smoke model's loss gives its WKV leaves nonzero
gradients through one backward launch a layer, within the limit of the
plain route's. A failed launch raises.
"""

import pytest
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import rwkv_scan

pytestmark = pytest.mark.gpu

# of each result's largest |value| (at least 1): f32 sums in another order
# over up to 2048 tokens, and the cumulative log decay's rounding, which
# the factors exp(cum_excl) and exp(-cum) (up to e^64 at chunk 16) carry
WKV_GRAD_LIMIT = 1e-4
NAMES = ("dr", "dk", "dv", "dlogw", "du", "ds0")
# (B, S, H, hd, chunk, nonzero s0 and d_state): rwkv6's training shape at
# one row, the smoke width, chunks 1, 5 and 13, a span of one chunk, decode
CASES = {
    "train_row": (1, 2048, 32, 64, 16, False),
    "smoke_hd16": (2, 48, 4, 16, 16, True),
    "hd16_groups": (2, 80, 4, 16, 16, True),
    "s97_chunk1": (1, 97, 4, 64, 1, True),
    "s60_chunk5": (2, 60, 4, 64, 5, True),
    "s13_chunk13": (2, 13, 8, 64, 13, True),
    "s256": (4, 256, 8, 64, 16, True),
    "decode": (4, 1, 8, 64, 1, True),
}


def _plans(b, s, h, hd, chunk):
    nc = s // chunk
    plans = {"planned": rwkv_scan.wkv_plan(b, s, h, hd, chunk)}
    if s > 1:
        plans["onepass"] = rwkv_scan.make_plan("onepass", b, s, h, hd,
                                               chunk)
        for g in (1, 2, 8):
            if g < nc:
                plans[f"split{g}"] = rwkv_scan.make_plan(
                    "split", b, s, h, hd, chunk, group=g)
    return plans


CASE_PLANS = [(case, name) for case in sorted(CASES)
              for name in _plans(*CASES[case][:5])]


# the chunks the backward kernels' cp.async ring stages (kStages)
RING = 2
# (B, S, H, hd, chunk, body, G): groups of RING - 1, RING and RING + 1
# chunks at hd 16 and 64, split (7 chunks: groups that do and do not divide
# them) and one pass (a single group of that many chunks)
RING_CASES = [(2, s, 4, hd, 16, body, g)
              for hd in (16, 64) for g in (RING - 1, RING, RING + 1)
              for body, s in (("split", 112), ("onepass", 16 * g))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, b, s, h, hd, nonzero, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    shape = (b, s, h, hd)
    r, k, v = (torch.randn(shape, generator=g) for _ in range(3))
    lw = torch.clamp(-torch.exp(torch.randn(shape, generator=g)), -4.0, 0.0)
    u = torch.randn((h, hd), generator=g) * 0.5
    s0 = torch.randn((b, h, hd, hd), generator=g) * 0.3
    dout = torch.randn(shape, generator=g)
    dstate = torch.randn((b, h, hd, hd), generator=g) * 0.5
    if not nonzero:
        s0 = dstate = None
    return [None if x is None else x.to(dev)
            for x in (r, k, v, lw, u, s0, dout, dstate)]


def _err(got, want):
    """max |got - want| over max(1, max |want|)."""
    return float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


def _backward(plan, args, chunk, **kw):
    r, k, v, lw, u, s0, dout, dstate = args
    _, _, states, _ = rwkv_scan._forward(r, k, v, lw, u, s0, chunk=chunk,
                                         plan=plan)
    before = rwkv_scan.launches["rwkv_wkv_backward"]
    got = rwkv_scan.rwkv_wkv_backward(r, k, v, lw, u, s0, dout, dstate,
                                      chunk=chunk, states=states, plan=plan,
                                      **kw)
    assert rwkv_scan.launches["rwkv_wkv_backward"] == before + 1
    return got


@pytest.mark.parametrize("case,name", CASE_PLANS)
def test_backward_matches_plain(cuda, case, name):
    b, s, h, hd, chunk, nonzero = CASES[case]
    plan = _plans(b, s, h, hd, chunk)[name]
    args = _inputs(cuda, b, s, h, hd, nonzero, seed=s + hd)
    got = _backward(plan, args, chunk)
    want = rwkv_scan.wkv_backward_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    for n, g, w in zip(NAMES, got, want):
        assert bool(torch.isfinite(g).all()), n
        assert _err(g, w) <= WKV_GRAD_LIMIT, (n, _err(g, w))
    again = _backward(plan, args, chunk)
    for n, g, a in zip(NAMES, got, again):
        assert torch.equal(g, a), n


@pytest.mark.parametrize("case,name", CASE_PLANS)
def test_planted_fault_fails(cuda, case, name):
    b, s, h, hd, chunk, nonzero = CASES[case]
    plan = _plans(b, s, h, hd, chunk)[name]
    args = _inputs(cuda, b, s, h, hd, nonzero, seed=s + hd)
    want = rwkv_scan.wkv_backward_plain(*args, chunk=chunk)
    bad = _backward(plan, args, chunk, drop_carry=True)
    n_groups = plan.n_groups if plan.body == "split" else 1
    reading = max(_err(g, w) for g, w in zip(bad[:4], want[:4]))
    if n_groups > 1 or nonzero:
        assert reading > WKV_GRAD_LIMIT
    else:  # one group and no final-state cotangent: nothing to drop
        assert reading <= WKV_GRAD_LIMIT


@pytest.mark.parametrize("case", RING_CASES)
def test_backward_at_ring_depth(cuda, case):
    b, s, h, hd, chunk, body, group = case
    plan = rwkv_scan.make_plan(body, b, s, h, hd, chunk,
                               group=group if body == "split" else None)
    assert plan.group == group
    args = _inputs(cuda, b, s, h, hd, True, seed=s + hd + group)
    got = _backward(plan, args, chunk)
    want = rwkv_scan.wkv_backward_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    for n, g, w in zip(NAMES, got, want):
        assert bool(torch.isfinite(g).all()), n
        assert _err(g, w) <= WKV_GRAD_LIMIT, (n, _err(g, w))
    again = _backward(plan, args, chunk)
    for n, g, a in zip(NAMES, got, again):
        assert torch.equal(g, a), n
    bad = _backward(plan, args, chunk, drop_carry=True)
    assert max(_err(g, w) for g, w in zip(bad[:4], want[:4])) > \
        WKV_GRAD_LIMIT


def test_no_ds0(cuda):
    args = _inputs(cuda, 2, 32, 4, 16, True)
    want = rwkv_scan.rwkv_wkv_backward(*args, chunk=16)
    got = rwkv_scan.rwkv_wkv_backward(*args, chunk=16, need_ds0=False)
    assert got[5] is None
    for n, g, w in zip(NAMES, got[:5], want[:5]):
        assert torch.equal(g, w), n


def test_failed_launch_raises(cuda):
    """A plan the built source refuses (groups that do not cover the
    chunks) raises; so does a split plan without the forward's states."""
    args = _inputs(cuda, 1, 64, 4, 64, True)
    plan = rwkv_scan.make_plan("split", 1, 64, 4, 64, 16, group=2)
    with pytest.raises(ValueError, match="scratch"):
        rwkv_scan.rwkv_wkv_backward(*args, chunk=16, plan=plan)
    bogus = plan._replace(n_groups=3, scratch=(1, 4, 3, 65, 64))
    states = torch.zeros(bogus.scratch, device=cuda)
    with pytest.raises(RuntimeError, match="cudaError"):
        rwkv_scan.rwkv_wkv_backward(*args, chunk=16, plan=bogus,
                                    states=states)


def _smoke_grads(impl, dev):
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models import api
    from repro_torch.models.blocks import ModelContext
    from repro_torch.models.params import init_params, tree_items

    cfg = get_smoke("rwkv6_1_6b")
    params = init_params(api.model_specs(cfg), 0, torch.float32, dev)
    for _, leaf in tree_items(params):
        leaf.requires_grad_()
    ctx = ModelContext(compute_dtype=torch.float32, attn_impl=impl,
                       rwkv_chunk=16, device=dev)
    g = torch.Generator(device="cpu").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=g).to(dev)
    loss, _ = api.loss_fn(params, {"tokens": toks[:, :-1],
                                   "labels": toks[:, 1:]}, cfg, ctx)
    loss.backward()
    return {path: leaf.grad for path, leaf in tree_items(params)}


def test_route_goes_through_wkv_function(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    rwkv_scan.reset_launches()
    got = _smoke_grads("cuda", cuda)
    # forward and its recompute under the block checkpoint, one backward
    assert rwkv_scan.launches == {"rwkv_wkv": 4, "rwkv_wkv_backward": 2}
    want = _smoke_grads("ref", cuda)
    for path, w in want.items():
        if any(name in path for name in ("r_proj", "k_proj", "v_proj",
                                         "w_lora", "u_bonus")):
            assert float(got[path].abs().max()) > 0, path
        limit = WKV_GRAD_LIMIT * float(w.abs().max())
        assert float((got[path] - w).abs().max()) <= limit, path
    args = _inputs(cuda, 1, 16, 4, 16, True)
    leaves = [x.clone().requires_grad_() for x in args[:5]]
    with pytest.raises(ValueError, match="state_out"):
        kops.rwkv_wkv(*leaves, chunk=16, state_out=torch.empty_like(args[5]))
