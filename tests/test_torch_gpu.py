"""On-card checks of the port's CUDA kernels (skipped without a GPU).

Run on a machine with an H100:
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
Each kernel variant is held against its plain-torch version on the same
card; f32 at 1e-4 (summation order differs from the gather oracle), bf16
at 2e-2 (the plain version rounds the gathered view to bf16). The grouped
GEMM: f32 within 3 * sqrt(D) * eps32 * max|out| (summation order over the
contraction; a product of TF32- or bf16-rounded inputs fails it), bf16
outputs within one bf16 step (2^-7 relative). The flash kernel: f32 at
1e-4, bf16 at 2e-2 (its probabilities round to bf16 at other points than
the plain version's) and, row by row, within FLASH_ROW_C bf16 steps
(2^-8) of the row's largest |value| (most rows average many keys to
small values); its autograd route's gradients equal the plain route's
exactly (the same plain backward at the same inputs), and the route
launches the kernel at any sequence length. The matmul kernel: f32
outputs within 4 * sqrt(K) * eps32 * max|out| (summation order; TF32
inputs fail it), bf16 outputs within one bf16 step (2^-7 relative) of
max|out|; the startup self-test passes through it and fails on planted
faults, and a chaos serve's survivors keep the fault-free tokens. The
dense ring decode kernel: f32 within 1e-5 (summation order), bf16 within
one bf16 step of each row's largest |value|; the kernel run at pos - 1
(one key dropped) fails the same limit; on the dense backend the kernel
route's greedy tokens equal the plain route's (f32), and a decode chunk
never waits for the device. The chunked RWKV-6 WKV kernel: out and the
final state within 1e-5 of each case's largest |value| (summation order,
and the cumulative decay's rounding carried by exp(+-cum)); the kernel
without the current-token bonus fails that limit; a zero front pad keeps
the state exactly 0; the state families' greedy tokens through the
kernels equal the plain route's (f32). The embedding-bag kernel: f32
within 1e-5 of the case's largest |value| (an fmaf against the plain
version's product and sum), bf16 within one bf16 step of each row's
largest |value|; a bag of one index with weight 1 is the row exactly; the
kernel without the bag's last position fails the limit; the DLRM
example's losses through the kernel match the plain route's within rel
1e-5. The flash kernel with S_k != S_q (Whisper's cross-attention) holds
the flash limits, and told S_k - 1 keys it fails them; Whisper and
Qwen2-VL (explicit M-RoPE rows) serve the same greedy tokens through the
kernels as through the plain route (f32)."""

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.core.sdc import FaultModel, faulty_wrap
from repro_torch.kernels import decode_attention as kern
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import matmul as mm
from repro_torch.examples import dlrm_sparsecore as dlrm
from repro_torch.kernels import moe_gemm, ref, rwkv_scan
from repro_torch.kernels import sparse_gather as sg
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.train import make_optimizer
from repro_torch.models import api
from repro_torch.models import attention as attn
from repro_torch.models.blocks import ModelContext, paged_quantize
from repro_torch.models.params import init_params
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.faults import FaultInjector, FaultPlan, startup_bist
from repro_torch.serve.scheduler import Request
from repro_torch.train.step import init_train_state, make_train_step

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the row limit chip_smoke.py holds bf16 flash outputs to
FLASH_ROW_C = ref.FLASH_ROW_C
_row_steps = ref.row_steps


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, *, b, t, h, kv, d, p, m, pages, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = 1 + b * m
    q = torch.randn((b, t, h, d), generator=g).to(dtype)
    k = torch.randn((n, p, kv, d), generator=g)
    v = torch.randn((n, p, kv, d), generator=g)
    ks = vs = None
    if pages == "int8":
        k, ks = paged_quantize(k, torch.int8)
        v, vs = paged_quantize(v, torch.int8)
    else:
        k, v = k.to(dtype), v.to(dtype)
    table = (1 + torch.randperm(n - 1, generator=g)[:b * m]).reshape(b, m)
    table[0, -1] = 0  # a padded entry: the trash page
    table = table.to(torch.int32)
    pos = torch.randint(1, m * p - t + 1, (b,), generator=g,
                        dtype=torch.int32)
    to = lambda x: None if x is None else x.to(dev)
    return [to(x) for x in (q, k, v, table, pos, ks, vs)]


@pytest.mark.parametrize("pages", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("d,window", [(8, None), (64, None), (64, 5),
                                      (128, 33), (256, None)])
@pytest.mark.parametrize("t", [1, 5, 128])
def test_kernel_matches_plain(cuda, pages, d, window, t):
    dtype = torch.float32 if pages == "f32" else torch.bfloat16
    q, k, v, table, pos, ks, vs = _inputs(
        cuda, b=3, t=t, h=14, kv=2, d=d, p=16, m=12, pages=pages,
        dtype=dtype)
    if t == 1:
        before = kern.launches["paged_decode_attention"]
        got = kern.paged_decode_attention(q[:, 0], k, v, table, pos,
                                          k_scale=ks, v_scale=vs,
                                          window=window)
        want = kern.paged_decode_attention_plain(
            q[:, 0], k, v, table, pos, k_scale=ks, v_scale=vs,
            window=window)
        assert kern.launches["paged_decode_attention"] == before + 1
    else:
        before = kern.launches["paged_decode_span_attention"]
        got = kern.paged_decode_span_attention(q, k, v, table, pos,
                                               k_scale=ks, v_scale=vs,
                                               window=window)
        want = kern.paged_decode_span_attention_plain(
            q, k, v, table, pos, k_scale=ks, v_scale=vs, window=window)
        assert kern.launches["paged_decode_span_attention"] == before + 1
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == want.shape
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


def test_row_without_valid_key_is_uniform_mean(cuda):
    """pos = 0 leaves a decode row no valid key: like the reference, the
    kernel returns the mean over every slot of the table row."""
    q, k, v, table, pos, _, _ = _inputs(
        cuda, b=2, t=1, h=6, kv=2, d=8, p=8, m=4, pages="f32",
        dtype=torch.float32)
    pos = torch.tensor([0, 5], dtype=torch.int32, device=cuda)
    got = kern.paged_decode_attention(q[:, 0], k, v, table, pos)
    want = kern.paged_decode_attention_plain(q[:, 0], k, v, table, pos)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    mean = v[table[0].long()].reshape(-1, 2, 8).mean(0)  # (KV, D)
    torch.testing.assert_close(got[0], mean.repeat_interleave(3, 0),
                               atol=1e-5, rtol=1e-5)


def test_wrapper_rejects_bad_inputs(cuda):
    q, k, v, table, pos, _, _ = _inputs(
        cuda, b=2, t=1, h=6, kv=2, d=8, p=8, m=4, pages="f32",
        dtype=torch.float32)
    with pytest.raises(ValueError):
        kern.paged_decode_attention(q[:, 0], k, v, table.long(), pos)
    with pytest.raises(ValueError):
        kern.paged_decode_attention(q[:, 0], k.transpose(1, 2), v, table,
                                    pos)


@pytest.mark.parametrize("cache", [None, torch.int8])
@pytest.mark.parametrize("draft_k", [0, 2])
def test_engine_cuda_matches_ref(cuda, cache, draft_k):
    """Greedy tokens through the kernels equal the gather path's (f32)."""
    cfg = get_smoke("qwen2_0_5b")
    params = init_params(api.model_specs(cfg), seed=0, device=cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(8, 15)))
               for _ in range(5)]
    outs = []
    for impl in ("cuda", "ref"):
        ctx = ModelContext(compute_dtype=torch.float32, attn_impl=impl,
                           decode_cache_dtype=cache, device=cuda)
        eng = ServeEngine(cfg, ctx, window=64, max_batch=3, chunk=4,
                          page_size=8, num_pages=12, draft_k=draft_k)
        kern.reset_launches()
        outs.append(eng.run(params, [Request(rid=i, prompt=p, max_new=14)
                                     for i, p in enumerate(prompts)]))
        launched = sum(kern.launches.values())
        assert (launched > 0) == (impl == "cuda")
    for i in range(len(prompts)):
        np.testing.assert_array_equal(outs[0][i], outs[1][i])


def test_launcher_profile_reads_device_time(cuda, capsys):
    launch_serve.main(["--arch", "qwen2_0_5b", "--smoke", "--trace", "3",
                       "--dtype", "bfloat16", "--profile"])
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("profile:")][0]
    events = int(line.split(",")[-1].split()[0])
    assert events > 0, line


# (block_m, tile ids, D, F): ragged smoke widths, runs longer than a
# block's rows, block_m above them, unaligned rows (scalar loads), an
# all -1 plan
GEMM_CASES = [
    (8, [0, 0, 1, -1, 2, 3, 3, -1], 64, 96),
    (8, [1] * 20 + [0, -1], 96, 32),
    (1, [2, 2, 0, 3, 3, 3, -1, 1], 36, 100),
    (128, [3, 1, -1], 200, 256),
    (64, [0, 0, 0, 2], 128, 130),
    (8, [-1, -1, -1], 64, 96),
]
GEMM_DTYPES = [("f32", "f32"), ("bf16", "bf16"), ("bf16", "int8"),
               ("f32", "int8")]


@pytest.mark.parametrize("xw", GEMM_DTYPES)
@pytest.mark.parametrize("bm,gids,d,f", GEMM_CASES)
def test_grouped_matmul_matches_plain(cuda, xw, bm, gids, d, f):
    g = torch.Generator(device="cpu").manual_seed(len(gids) * d + f)
    e = 4
    xdt = torch.float32 if xw[0] == "f32" else torch.bfloat16
    x = torch.randn((bm * len(gids), d), generator=g).to(xdt)
    if xw[1] == "int8":
        w = torch.randint(-127, 128, (e, d, f), generator=g,
                          dtype=torch.int8)
        scale = torch.rand((e,), generator=g) * 0.01 + 1e-3
    else:
        w, scale = torch.randn((e, d, f), generator=g).to(xdt), None
    x, w, gids_t = x.to(cuda), w.to(cuda), torch.tensor(
        gids, dtype=torch.int32, device=cuda)
    scale = None if scale is None else scale.to(cuda)
    before = moe_gemm.launches["grouped_matmul"]
    got = moe_gemm.grouped_matmul(x, w, gids_t, w_scale=scale)
    assert moe_gemm.launches["grouped_matmul"] == before + 1
    want = ref.grouped_matmul_ref(x, w, gids_t, w_scale=scale)
    torch.cuda.synchronize()
    assert got.dtype == xdt and got.shape == want.shape
    big = float(want.float().abs().max()) if want.numel() else 0.0
    if xdt == torch.bfloat16:
        tol = dict(rtol=2 ** -7, atol=2 ** -7 * big + 1e-6)
    else:
        tol = dict(rtol=0, atol=3 * d ** 0.5 * 1.2e-7 * big + 1e-6)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    rows = got.reshape(len(gids), bm, f)[torch.tensor(gids) < 0]
    assert bool((rows == 0).all())


def test_grouped_matmul_rejects_bad_inputs(cuda):
    x = torch.randn((16, 8), device=cuda)
    w = torch.randn((2, 8, 4), device=cuda)
    gids = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        moe_gemm.grouped_matmul(x, w, gids.long())
    with pytest.raises(ValueError):
        moe_gemm.grouped_matmul(x, w.to(torch.bfloat16), gids)
    with pytest.raises(ValueError):
        moe_gemm.grouped_matmul(x[:15], w, gids)


@pytest.mark.parametrize("cache", [None, torch.int8])
@pytest.mark.parametrize("draft_k", [0, 2])
def test_moe_engine_cuda_matches_ref(cuda, cache, draft_k):
    """Mixtral smoke: greedy tokens through the grouped-GEMM and paged
    kernels equal the plain path's (f32), with pages trimmed."""
    cfg = get_smoke("mixtral_8x22b")
    params = init_params(api.model_specs(cfg), seed=0, device=cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(8, 15)))
               for _ in range(5)]
    outs = []
    for impl in ("cuda", "ref"):
        ctx = ModelContext(compute_dtype=torch.float32, attn_impl=impl,
                           decode_cache_dtype=cache, device=cuda)
        eng = ServeEngine(cfg, ctx, window=64, max_batch=3, chunk=4,
                          page_size=8, num_pages=12, draft_k=draft_k)
        moe_gemm.reset_launches()
        outs.append(eng.run(params, [Request(rid=i, prompt=p, max_new=14)
                                     for i, p in enumerate(prompts)]))
        assert (moe_gemm.launches["grouped_matmul"] > 0) == (impl == "cuda")
        assert eng.counters["pages_trimmed"] > 0
    for i in range(len(prompts)):
        np.testing.assert_array_equal(outs[0][i], outs[1][i])


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "mixtral_8x22b"])
@pytest.mark.parametrize("draft_k", [0, 2])
def test_decode_chunk_never_waits_for_the_device(cuda, arch, draft_k,
                                                 monkeypatch):
    """A decode chunk (paged attention, the MoE dispatch plan, the grouped
    GEMM, sampling) queues its work without one host sync: the engine's
    drain after the chunk is its only wait."""
    cfg = get_smoke(arch)
    params = init_params(api.model_specs(cfg), seed=0, device=cuda)
    chunks = []
    for name in ("_run_chunk", "_run_chunk_spec"):
        inner = getattr(ServeEngine, name)

        def strict(self, *a, _inner=inner, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = _inner(self, *a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            chunks.append(out.shape)
            return out
        monkeypatch.setattr(ServeEngine, name, strict)
    ctx = ModelContext(compute_dtype=torch.bfloat16, device=cuda)
    eng = ServeEngine(cfg, ctx, window=64, max_batch=3, chunk=4, page_size=8,
                      draft_k=draft_k)
    rng = np.random.default_rng(2)
    eng.run(params, [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                        12), max_new=9)
                     for i in range(4)])
    assert chunks


FLASH_MASKS = {"causal": (True, None), "window": (True, 37),
               "bidirectional": (False, None)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", sorted(FLASH_MASKS))
@pytest.mark.parametrize("bh,s,d", [(3, 128, 8), (2, 200, 12), (2, 256, 128),
                                    (2, 192, 256), (56, 2048, 64)])
def test_flash_kernel_matches_plain(cuda, dtype, mask, bh, s, d):
    """Smoke widths (D=8), ragged S and D (scalar loads), D up to 256,
    and qwen2-0.5B's training shape (4 x 14 heads, S=2048, D=64)."""
    causal, window = FLASH_MASKS[mask]
    g = torch.Generator(device="cpu").manual_seed(s + d)
    q, k, v = (torch.randn((bh, s, d), generator=g).to(dtype).to(cuda)
               for _ in range(3))
    before = flash.launches["flash_attention"]
    got = flash.flash_attention(q, k, v, causal=causal, window=window)
    assert flash.launches["flash_attention"] == before + 1
    want = flash.flash_attention_plain(q, k, v, causal=causal,
                                       window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)
    if dtype == torch.bfloat16:
        assert _row_steps(got, want) <= FLASH_ROW_C
    again = flash.flash_attention(q, k, v, causal=causal, window=window)
    assert torch.equal(got, again)  # one summation order: reproducible


def test_flash_wrapper_rejects_bad_inputs(cuda):
    q = torch.randn((2, 128, 64), device=cuda)
    with pytest.raises(ValueError):
        flash.flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError):
        flash.flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError):
        flash.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        flash.flash_attention(q, q, q, window=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("atype,window", [("causal", None), ("causal", 100),
                                          ("bidirectional", None)])
def test_kernel_route_grads_equal_plain_route(cuda, dtype, atype, window):
    """full_attention(impl="cuda") forwards through the kernel; its
    gradient is the plain route's, computed at the same inputs."""
    cfg = get_smoke("qwen2_0_5b")
    g = torch.Generator(device="cpu").manual_seed(3)
    q = torch.randn((2, 256, 6, 64), generator=g).to(dtype).to(cuda)
    k, v = (torch.randn((2, 256, 2, 64), generator=g).to(dtype).to(cuda)
            for _ in range(2))
    cot = torch.randn(q.shape, generator=g).to(dtype).to(cuda)
    outs, grads = {}, {}
    for impl in ("cuda", "ref"):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        flash.reset_launches()
        out = attn.full_attention(*leaves, cfg, q_chunk=128,
                                  attn_type=atype, window=window, impl=impl)
        (out.float() * cot.float()).sum().backward()
        assert flash.launches["flash_attention"] == (impl == "cuda")
        outs[impl], grads[impl] = out.detach(), [x.grad for x in leaves]
    tol = TOL[dtype]
    torch.testing.assert_close(outs["cuda"].float(), outs["ref"].float(),
                               atol=tol, rtol=tol)
    for a, b in zip(grads["cuda"], grads["ref"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [64, 200])
def test_kernel_route_launches_at_any_length(cuda, dtype, s):
    """Lengths that are no multiple of 128 (the train launcher's default
    --seq 64 among them) still go through the kernel."""
    cfg = get_smoke("qwen2_0_5b")
    g = torch.Generator(device="cpu").manual_seed(s)
    q = torch.randn((2, s, 6, 64), generator=g).to(dtype).to(cuda)
    k, v = (torch.randn((2, s, 2, 64), generator=g).to(dtype).to(cuda)
            for _ in range(2))
    flash.reset_launches()
    got = attn.full_attention(q, k, v, cfg, impl="cuda")
    assert flash.launches["flash_attention"] == 1
    want = attn.full_attention(q, k, v, cfg, impl="ref")
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


def test_full_width_train_steps_never_wait_for_the_device(cuda):
    """Two steps of full-width, full-depth qwen2-0.5B (bf16 compute)
    queue all their work without a host sync; the trainer's float(loss)
    after each step is the only wait, as in the reference. Under
    activation checkpointing each layer's forward runs twice, so the
    flash kernel launches 2 * 24 times per step."""
    cfg = get_arch("qwen2_0_5b")
    ctx = ModelContext(compute_dtype=torch.bfloat16, device=cuda)
    opt = make_optimizer("adamw")
    step = make_train_step(cfg, ctx, opt)
    state = init_train_state(0, cfg, opt, device=cuda)
    pipe = DataPipeline(DataConfig(global_batch=1, seq_len=256,
                                   vocab_size=cfg.vocab_size))
    losses = []
    for i in range(2):
        batch = pipe.batch_for_step(i)
        flash.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, metrics = step(state, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        losses.append(float(metrics["loss"]))
        assert flash.launches["flash_attention"] == 2 * cfg.n_layers
    assert all(np.isfinite(losses)) and int(state["step"]) == 2


# --------------------------------------------------------------- matmul

EPS32 = 1.1920929e-07


def _mm_limit(want, k, out_dtype):
    big = float(want.float().abs().max())
    if out_dtype == torch.bfloat16:
        return 2.0 ** -7 * big + 1e-6
    return 4 * k ** 0.5 * EPS32 * big + 1e-6


# (M, K, N): the self-test's 128^3, the JAX test shapes, ragged edges
# (K and N not multiples of 8: plain loads), tiny and K = 1
MM_SHAPES = [(128, 128, 128), (256, 512, 256), (512, 1024, 128),
             (200, 300, 136), (1, 7, 3), (130, 1, 250), (67, 96, 40)]


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("in_dt,out_dt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)])
def test_matmul_kernel_matches_plain(cuda, m, k, n, in_dt, out_dt):
    g = torch.Generator(device="cpu").manual_seed(m * k + n)
    a = torch.randn((m, k), generator=g).to(in_dt).to(cuda)
    b = torch.randn((k, n), generator=g).to(in_dt).to(cuda)
    before = mm.launches["matmul"]
    got = mm.matmul(a, b, out_dtype=out_dt)
    assert mm.launches["matmul"] == before + 1
    want = ref.matmul_ref(a, b, out_dt)
    torch.cuda.synchronize()
    assert got.dtype == out_dt and got.shape == (m, n)
    err = float((got.float() - want.float()).abs().max())
    assert err <= _mm_limit(want, k, out_dt), err
    # one fixed summation order: bit-reproducible
    assert torch.equal(mm.matmul(a, b, out_dtype=out_dt), got)


def test_matmul_kernel_skipping_a_k_tile_fails_the_limit(cuda):
    g = torch.Generator(device="cpu").manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        a = torch.randn((200, 300), generator=g).to(dt).to(cuda)
        b = torch.randn((300, 136), generator=g).to(dt).to(cuda)
        want = ref.matmul_ref(a, b, torch.float32)
        kt = mm.K_TILE[dt]
        cut = 300 - (300 % kt or kt)
        bad = mm.matmul(a[:, :cut].contiguous(), b[:cut].contiguous(),
                        out_dtype=torch.float32)
        err = float((bad - want).abs().max())
        assert err > _mm_limit(want, 300, torch.float32), err


def test_matmul_wrapper_rejects_bad_inputs(cuda):
    a = torch.randn((8, 16), device=cuda)
    with pytest.raises(ValueError):
        mm.matmul(a, torch.randn((8, 16), device=cuda))  # contraction
    with pytest.raises(ValueError):
        mm.matmul(a, torch.randn((16, 4), device=cuda).bfloat16())
    with pytest.raises(ValueError):
        mm.matmul(a, torch.randn((4, 16), device=cuda).t())  # strides
    with pytest.raises(ValueError):
        mm.matmul(a.half(), torch.randn((16, 4), device=cuda).half())


def test_startup_bist_on_the_card(cuda):
    mm.reset_launches()
    kern.reset_launches()
    res = startup_bist()
    assert res.passed, res
    assert mm.launches["matmul"] == 8
    assert kern.launches["paged_decode_attention"] == 1
    bad_mm = faulty_wrap(lambda a, b: mm.matmul(a, b),
                         FaultModel(rate=1.0, magnitude=0.5, seed=1))
    res = startup_bist(matmul_fn=bad_mm)
    assert not res.passed and not res.matmul_report.passed
    res = startup_bist(decode_fn=lambda q, *a: torch.zeros_like(q))
    assert not res.passed and not res.paged_decode_ok


@pytest.mark.parametrize("draft_k", [0, 2])
def test_chaos_serve_survivors_keep_fault_free_tokens(cuda, draft_k):
    cfg = get_smoke("qwen2_0_5b")
    params = init_params(api.model_specs(cfg), seed=0, device=cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(9, 15)))
               for _ in range(3)]
    plan = FaultPlan(seed=7, worker_fail_rate=0.25, page_flip_rate=0.25,
                     transfer_drop_rate=0.2, straggler_rate=0.2)
    outs = []
    for faults in (None, FaultInjector(plan)):
        ctx = ModelContext(compute_dtype=torch.float32, device=cuda)
        eng = ServeEngine(cfg, ctx, window=32, max_batch=2, chunk=2,
                          page_size=8, draft_k=draft_k, faults=faults)
        outs.append(eng.run(params, [Request(rid=i, prompt=p, max_new=16)
                                     for i, p in enumerate(prompts)]))
    assert eng.fault_stats["fault_detections"] > 0
    assert eng.fault_stats["fault_page_corruptions"] > 0
    assert outs[1]
    for rid, toks in outs[1].items():
        np.testing.assert_array_equal(toks, outs[0][rid])


# (H, KV, D, W, pos of each row, window): phi4-mini's heads on a wrapped
# 4096-slot ring with a pos-0 row, a ragged ring width, a window below the
# width, smoke widths
DENSE_SHAPES = {
    "phi4_wrapped": (24, 8, 128, 4096, (0, 1000, 4096, 6000), None),
    "ragged_w": (16, 2, 128, 1000, (1, 999, 2345), None),
    "window": (48, 8, 128, 4096, (300, 4500, 9000), 512),
    "smoke": (4, 2, 16, 24, (0, 5, 24, 50), 8),
}


def _dense_reading(got, want, dtype):
    """f32: max |error|; bf16: max |error| in bf16 steps of its row's
    largest |want|."""
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        return float(err.max())
    top = want.float().abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    return float((err / torch.exp2(torch.floor(torch.log2(top)) - 7)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(DENSE_SHAPES))
def test_dense_decode_kernel_matches_plain(cuda, case, dtype):
    h, kv, d, w, pos, window = DENSE_SHAPES[case]
    g = torch.Generator(device="cpu").manual_seed(3)
    b = len(pos)
    q, kc, vc = (torch.randn(shape, generator=g).to(dtype).to(cuda)
                 for shape in ((b, h, d), (b, w, kv, d), (b, w, kv, d)))
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    before = kern.launches["decode_attention"]
    got = kern.decode_attention(q, kc, vc, p, window=window)
    want = kern.decode_attention_plain(q, kc, vc, p, window=window)
    torch.cuda.synchronize()
    assert kern.launches["decode_attention"] == before + 1
    assert got.dtype == dtype and got.shape == (b, h, d)
    limit = 1e-5 if dtype == torch.float32 else 1.0
    assert _dense_reading(got, want, dtype) <= limit
    bad = kern.decode_attention(q, kc, vc, p - 1, window=window)
    assert _dense_reading(bad, want, dtype) > limit


def test_dense_decode_wrapper_rejects_bad_inputs(cuda):
    q = torch.zeros((2, 4, 16), device=cuda)
    kc = torch.zeros((2, 8, 2, 16), device=cuda)
    p = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kern.decode_attention(q, kc.bfloat16(), kc.bfloat16(), p)
    with pytest.raises(ValueError):
        kern.decode_attention(q, kc.transpose(1, 2), kc, p)
    with pytest.raises(ValueError):
        kern.decode_attention(q, kc, kc, p.long())
    with pytest.raises(ValueError):
        kern.decode_attention(q, kc, kc, p, window=0)


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "phi4_mini_3_8b"])
def test_dense_engine_cuda_matches_ref(cuda, arch):
    """Greedy tokens on the dense backend through the kernels equal the
    plain route's (f32): mixtral smoke's 8-slot ring, phi4 smoke's chunked
    span prefill; run and generate_pertoken."""
    cfg = get_smoke(arch)
    params = init_params(api.model_specs(cfg), seed=0, device=cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(6, 15)))
               for _ in range(5)]
    batch = rng.integers(0, cfg.vocab_size, (2, 11))
    outs, pert = [], []
    for impl in ("cuda", "ref"):
        ctx = ModelContext(compute_dtype=torch.float32, attn_impl=impl,
                           device=cuda)
        eng = ServeEngine(cfg, ctx, window=40, max_batch=3, chunk=4,
                          prefill_chunk=8, paged=False)
        kern.reset_launches()
        outs.append(eng.run(params, [Request(rid=i, prompt=p, max_new=14)
                                     for i, p in enumerate(prompts)]))
        pert.append(eng.generate_pertoken(params, {"tokens": batch},
                                          max_new=9))
        assert (kern.launches["decode_attention"] > 0) == (impl == "cuda")
    for i in range(len(prompts)):
        np.testing.assert_array_equal(outs[0][i], outs[1][i])
    assert torch.equal(pert[0], pert[1])


def test_dense_decode_chunk_never_waits_for_the_device(cuda, monkeypatch):
    """The dense backend's decode chunk (ring write, the dense kernel,
    sampling) queues its work without one host sync."""
    cfg = get_smoke("mixtral_8x22b")
    params = init_params(api.model_specs(cfg), seed=0, device=cuda)
    chunks = []
    inner = ServeEngine._run_chunk

    def strict(self, *a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = inner(self, *a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        chunks.append(out.shape)
        return out
    monkeypatch.setattr(ServeEngine, "_run_chunk", strict)
    ctx = ModelContext(compute_dtype=torch.bfloat16, device=cuda)
    eng = ServeEngine(cfg, ctx, window=40, max_batch=3, chunk=4,
                      paged=False)
    rng = np.random.default_rng(2)
    eng.run(params, [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                        12), max_new=9)
                     for i in range(4)])
    assert chunks


# (B, S, H, hd, chunk, nonzero s0): chip_smoke.py's cases at rwkv6's
# widths (a bucketed prefill, decode shapes, chunks 8 and 13) and the smoke
# width hd 16
WKV_CASES = {
    "prefill_1024": (1, 1024, 32, 64, 16, False),
    "batch4_s16": (4, 16, 32, 64, 16, True),
    "s8_chunk8": (2, 8, 32, 64, 8, True),
    "s13_chunk13": (2, 13, 32, 64, 13, True),
    "decode": (4, 1, 32, 64, 1, True),
    "smoke_hd16": (2, 48, 4, 16, 16, True),
}
WKV_LIMIT = 1e-5


def _wkv_inputs(dev, b, s, h, hd, with_s0, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    r, k, v = (torch.randn((b, s, h, hd), generator=g) for _ in range(3))
    lw = torch.clamp(-torch.exp(torch.randn((b, s, h, hd), generator=g)),
                     -4.0, 0.0)
    u = torch.randn((h, hd), generator=g) * 0.5
    s0 = (torch.randn((b, h, hd, hd), generator=g) * 0.3 if with_s0
          else None)
    return [None if x is None else x.to(dev) for x in (r, k, v, lw, u, s0)]


def _wkv_err(got, want):
    """max |got - want| over max(1, max |want|)."""
    err = float((got - want).abs().max())
    return err / max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("case", sorted(WKV_CASES))
def test_rwkv_wkv_kernel_matches_plain(cuda, case):
    b, s, h, hd, chunk, with_s0 = WKV_CASES[case]
    r, k, v, lw, u, s0 = _wkv_inputs(cuda, b, s, h, hd, with_s0)
    before = rwkv_scan.launches["rwkv_wkv"]
    out, sf = rwkv_scan.rwkv_wkv(r, k, v, lw, u, s0, chunk=chunk)
    want, wsf = rwkv_scan.chunked_wkv_plain(r, k, v, lw, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert rwkv_scan.launches["rwkv_wkv"] == before + 1
    assert _wkv_err(out, want) <= WKV_LIMIT
    assert _wkv_err(sf, wsf) <= WKV_LIMIT
    bad, _ = rwkv_scan.rwkv_wkv(r, k, v, lw, u, s0, chunk=chunk,
                                skip_bonus=True)
    assert _wkv_err(bad, want) > WKV_LIMIT
    if s0 is not None:  # in place: the final state over the initial one
        st = s0.clone()
        out2, sf2 = rwkv_scan.rwkv_wkv(r, k, v, lw, u, st, chunk=chunk,
                                       state_out=st)
        assert sf2 is st and torch.equal(out2, out) and torch.equal(st, sf)


def test_rwkv_wkv_front_pad_keeps_zeros_exact(cuda):
    r, k, v, lw, u, _ = _wkv_inputs(cuda, 2, 64, 32, 64, False, seed=4)
    for x in (r, k, v):
        x[:, :32] = 0.0
    out, sf = rwkv_scan.rwkv_wkv(r, k, v, lw, u, chunk=16)
    assert torch.all(out[:, :32] == 0)
    head = [x[:, :32].contiguous() for x in (r, k, v, lw)]
    _, head = rwkv_scan.rwkv_wkv(*head, u, chunk=16)
    assert torch.all(head == 0)


def test_rwkv_wkv_wrapper_rejects_bad_inputs(cuda):
    r, k, v, lw, u, s0 = _wkv_inputs(cuda, 1, 32, 2, 16, True)
    with pytest.raises(ValueError, match="chunk"):
        rwkv_scan.rwkv_wkv(r, k, v, lw, u, s0, chunk=32)
    with pytest.raises(ValueError):
        rwkv_scan.rwkv_wkv(r, k, v, lw, u, s0, chunk=5)
    with pytest.raises(ValueError):
        rwkv_scan.rwkv_wkv(r.bfloat16(), k, v, lw, u, s0, chunk=16)
    with pytest.raises(ValueError):
        rwkv_scan.rwkv_wkv(r.transpose(1, 2), k, v, lw, u, s0, chunk=16)
    with pytest.raises(ValueError):
        rwkv_scan.rwkv_wkv(r, k, v, lw, u[:1], s0, chunk=16)
    r8, k8, v8, lw8, u8, _ = _wkv_inputs(cuda, 1, 16, 2, 8, False)
    with pytest.raises(ValueError, match="head dim"):
        rwkv_scan.rwkv_wkv(r8, k8, v8, lw8, u8, chunk=16)


@pytest.mark.parametrize("arch", ["rwkv6_1_6b", "jamba_v01_52b"])
def test_state_engine_cuda_matches_ref(cuda, arch):
    """Greedy tokens of the state families through the kernels equal the
    plain route's (f32): rwkv6 smoke's bucketed prefill through the WKV
    kernel, jamba smoke's span prefill, dense decode and grouped GEMM;
    run and generate_pertoken (prime-length prompts: WKV chunk 1)."""
    cfg = get_smoke(arch)
    params = init_params(api.model_specs(cfg), seed=0, device=cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 30)))
               for _ in range(5)]
    batch = rng.integers(0, cfg.vocab_size, (2, 13))
    need = ("rwkv_wkv",) if arch == "rwkv6_1_6b" else (
        "decode_attention", "grouped_matmul")
    mods = {"rwkv_wkv": rwkv_scan, "decode_attention": kern,
            "grouped_matmul": moe_gemm}
    outs, pert = [], []
    for impl in ("cuda", "ref"):
        ctx = ModelContext(compute_dtype=torch.float32, attn_impl=impl,
                           mamba_chunk=16, rwkv_chunk=8, device=cuda)
        eng = ServeEngine(cfg, ctx, window=48, max_batch=3, chunk=4,
                          prefill_chunk=8)
        assert not eng.paged
        for mod in mods.values():
            mod.reset_launches()
        outs.append(eng.run(params, [Request(rid=i, prompt=p, max_new=14)
                                     for i, p in enumerate(prompts)]))
        pert.append(eng.generate_pertoken(params, {"tokens": batch},
                                          max_new=9))
        for name in need:
            assert (mods[name].launches[name] > 0) == (impl == "cuda")
    for i in range(len(prompts)):
        np.testing.assert_array_equal(outs[0][i], outs[1][i])
    assert torch.equal(pert[0], pert[1])


# ------------------------------------------------------------ embedding bag

GATHER_CASES = {  # V, D, N, bag
    "dlrm_user": (5000, 32, 256, 4),
    "dlrm_cat": (200, 16, 256, 4),
    "jax_512x128": (512, 128, 8, 8),
    "ragged_d37": (1000, 37, 64, 5),
    "long_bag": (4096, 128, 300, 100),
}


def _gather_inputs(dev, v, d, n, bag, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    table = torch.randn((v, d), generator=g).to(dtype).to(dev)
    idx = torch.randint(0, v, (n, bag), generator=g,
                        dtype=torch.int32).to(dev)
    w = torch.randn((n, bag), generator=g).to(dev)
    return table, idx, w


def _gather_reading(got, want, dtype):
    if dtype == torch.bfloat16:  # bf16 steps of each row's largest |want|
        err = (got.float() - want.float()).abs()
        top = want.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
        return float((err / torch.exp2(torch.floor(torch.log2(top)) - 7))
                     .max())
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_sparse_gather_kernel_matches_plain(cuda, dtype, case):
    v, d, n, bag = GATHER_CASES[case]
    table, idx, w = _gather_inputs(cuda, v, d, n, bag, dtype)
    idx[:, -1] = idx[:, 0]  # a repeated row in every bag
    idx[0, 1], idx[1, 1], idx[2, 1] = -1, v + 2, -v - 4  # wrap, clamp
    before = sg.launches["sparse_gather_sum"]
    got = sg.sparse_gather_sum(table, idx, w)
    want = sg.sparse_gather_sum_plain(table, idx, w)
    torch.cuda.synchronize()
    assert sg.launches["sparse_gather_sum"] == before + 1
    assert got.dtype == dtype and got.shape == (n, d)
    limit = 1.0 if dtype == torch.bfloat16 else 1e-5
    assert _gather_reading(got, want, dtype) <= limit
    bad = sg.sparse_gather_sum(table, idx, w, skip_last=True)
    assert _gather_reading(bad, want, dtype) > limit
    assert torch.equal(got, sg.sparse_gather_sum(table, idx, w))


def test_sparse_gather_bag_of_one_is_the_row(cuda):
    for dtype in (torch.float32, torch.bfloat16):
        table, _, _ = _gather_inputs(cuda, 127, 48, 1, 1, dtype)
        idx = torch.arange(127, device=cuda,
                           dtype=torch.int32)[:, None].contiguous()
        w = torch.ones((127, 1), device=cuda)
        assert torch.equal(sg.sparse_gather_sum(table, idx, w), table)


def test_sparse_gather_bf16_at_dlrm_width(cuda):
    """bf16 rows 128 wide and bags of 100, as MLPerf's DLRM-DCNv2, on a
    1M-row table that fits a test."""
    table, idx, w = _gather_inputs(cuda, 1_000_000, 128, 2048, 100,
                                   torch.bfloat16, seed=3)
    got = sg.sparse_gather_sum(table, idx, w)
    want = sg.sparse_gather_sum_plain(table, idx, w)
    assert _gather_reading(got, want, torch.bfloat16) <= 1.0


def test_sparse_gather_wrapper_rejects_bad_inputs(cuda):
    table, idx, w = _gather_inputs(cuda, 64, 16, 8, 4, torch.float32)
    with pytest.raises(ValueError, match="int32"):
        sg.sparse_gather_sum(table, idx.long(), w)
    with pytest.raises(ValueError, match="float32"):
        sg.sparse_gather_sum(table, idx, w.double())
    with pytest.raises(ValueError, match="dtype"):
        sg.sparse_gather_sum(table.half(), idx, w)
    with pytest.raises(ValueError, match="contiguous"):
        sg.sparse_gather_sum(table.t().contiguous().t(), idx, w)
    with pytest.raises(ValueError):
        sg.sparse_gather_sum(table, idx.cpu(), w)


def test_dlrm_example_kernel_route_matches_plain_route(cuda):
    steps = 6
    losses, final = {}, {}
    for impl in ("cuda", "ref"):
        sg.reset_launches()
        params = dlrm.init(torch.Generator().manual_seed(0), cuda)
        final[impl], losses[impl] = dlrm.train(params, steps, impl=impl,
                                               device=cuda)
        assert sg.launches["sparse_gather_sum"] == \
            (3 * steps if impl == "cuda" else 0)
    for a, b in zip(losses["cuda"], losses["ref"]):
        assert abs(a - b) <= 1e-5 * abs(b)
    for k, p in final["ref"].items():
        assert float((final["cuda"][k] - p).abs().max()) \
            <= 1e-5 * float(p.abs().max()), k


def test_dlrm_gradient_matches_one_hot_products(cuda):
    """The kernel route's backward on the card: a negative index wraps
    once, an index still out of range adds nothing to the table gradient,
    and the weight gradient reads the clamped row; held against f64
    one-hot products built without index_add_."""
    v, d, n, bag = 300, 16, 64, 4
    g = torch.Generator().manual_seed(5)
    table = torch.randn((v, d), generator=g)
    idx = torch.randint(0, v, (n, bag), generator=g, dtype=torch.int32)
    idx[:, -1] = idx[:, 0]
    idx[0, 1], idx[1, 1], idx[2, 1] = -1, v + 2, -v - 4
    w, up = torch.randn((n, bag), generator=g), torch.randn((n, d),
                                                           generator=g)
    leaves = [t.to(cuda).requires_grad_() for t in (table, w)]
    out = dlrm._EmbeddingBag.apply(leaves[0], idx.to(cuda), leaves[1],
                                   "cuda")
    got_t, got_w = (x.cpu().double()
                    for x in torch.autograd.grad(out, leaves, up.to(cuda)))
    flat = idx.long().flatten()
    wrapped = torch.where(flat < 0, flat + v, flat)
    keep = (wrapped >= 0) & (wrapped < v)
    rows = torch.arange(n * bag)
    drop = torch.zeros((n * bag, v), dtype=torch.float64)
    drop[rows[keep], wrapped[keep]] = 1
    clamp = torch.zeros((n * bag, v), dtype=torch.float64)
    clamp[rows, wrapped.clamp(0, v - 1)] = 1
    g_rows = up.double().repeat_interleave(bag, 0)
    want_t = drop.T @ (w.double().flatten()[:, None] * g_rows)
    want_w = ((clamp @ table.double()) * g_rows).sum(-1).view(n, bag)
    assert float((got_t - want_t).abs().max()) \
        <= 1e-5 * float(want_t.abs().max())
    assert float((got_w - want_w).abs().max()) \
        <= 1e-5 * float(want_w.abs().max())


# ------------------------------------------------ cross-attention, enc-dec


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk", [(64, 1500), (448, 1500), (5, 77)])
def test_flash_kernel_with_another_key_length(cuda, dtype, sq, sk):
    g = torch.Generator(device="cpu").manual_seed(sq + sk)
    q = torch.randn((12, sq, 64), generator=g).to(dtype).to(cuda)
    k, v = (torch.randn((12, sk, 64), generator=g).to(dtype).to(cuda)
            for _ in range(2))
    got = flash.flash_attention(q, k, v, causal=False)
    want = flash.flash_attention_plain(q, k, v, causal=False)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)
    if dtype == torch.bfloat16:
        assert _row_steps(got, want) <= FLASH_ROW_C
    bad = flash.flash_attention(q, k, v, causal=False, drop_last_key=True)
    err = float((bad.float() - want.float()).abs().max())
    assert err > tol or (dtype == torch.bfloat16
                         and _row_steps(bad, want) > FLASH_ROW_C)
    with pytest.raises(ValueError, match="one sequence"):
        flash.flash_attention(q, k, v, causal=True)


def test_encdec_and_mrope_engines_cuda_match_ref(cuda):
    """Whisper smoke (enc_feats) on the dense backend and Qwen2-VL smoke
    (half the requests with explicit M-RoPE rows) on the paged backend:
    greedy tokens through the kernels equal the plain route's (f32)."""
    rng = np.random.default_rng(2)
    for arch in ("whisper_small", "qwen2_vl_7b"):
        cfg = get_smoke(arch)
        params = init_params(api.model_specs(cfg), seed=0, device=cuda)
        prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 20)))
                   for _ in range(4)]
        outs = []
        for impl in ("cuda", "ref"):
            ctx = ModelContext(compute_dtype=torch.float32, attn_impl=impl,
                               device=cuda)
            eng = ServeEngine(cfg, ctx, window=40, max_batch=2, chunk=4,
                              page_size=4, prefill_chunk=8)
            reqs = []
            for i, p in enumerate(prompts):
                r = Request(rid=i, prompt=p, max_new=9)
                if cfg.is_encoder_decoder:
                    r.extras["enc_feats"] = np.random.default_rng(i).normal(
                        size=(1, cfg.encoder_seq, cfg.d_model)).astype(
                            np.float32) * 0.1
                elif i % 2:
                    t = np.arange(len(p))
                    r.extras["positions"] = np.stack(
                        [t, t // 2, t % 3])[:, None, :].astype(np.int32)
                reqs.append(r)
            for mod in (flash, kern):
                mod.reset_launches()
            outs.append(eng.run(params, reqs))
            launched = (flash.launches["flash_attention"]
                        + sum(kern.launches.values()))
            assert (launched > 0) == (impl == "cuda")
        for i in range(len(prompts)):
            np.testing.assert_array_equal(outs[0][i], outs[1][i])
