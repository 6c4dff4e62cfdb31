"""On-card checks of the dense ring decode kernel's bf16 body
(``csrc/decode_attention.cu``: mma.sync over a cp.async ring, a row's
key-range splits merged in one thread-block cluster), skipped without a GPU.

Run on a machine with an H100:
    PYTHONPATH=src python -m pytest -q -m gpu \
        tests/test_torch_dense_decode_kernel.py

Each call is held against ``decode_attention_plain`` as chip_smoke.py holds
the dense cases: within one bf16 step of each row's largest |value| (both
sides round an fp32 result to bf16; the kernel also rounds the
probabilities to bf16 for the P V product). Shapes: every chip_smoke.py
dense case (GQA groups of 2, 3, 6 and 8 at D 128, rings of 1000-4096 slots,
pos 0, pos past W, a window of 512), Whisper-small's decoder self and cross
attention (12 heads, g = 1, D 64), the smoke configs' head dims (8, 16), a
group of 16 and a call with one split. A repeat is bitwise equal; the
kernel at pos - 1 fails the limit; a call is one kernel launch and
allocates only its output; a row with no valid key gets the uniform mean.
"""

import pytest
import torch

from repro_torch.kernels import decode_attention as kern

pytestmark = pytest.mark.gpu


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


# (H, KV, D, W, pos of each row, window)
CASES = {
    "phi4_serve": (24, 8, 128, 1056, (211, 530, 817, 1050), None),
    "phi4_ring": (24, 8, 128, 4096, (0, 1000, 4096, 6000), None),
    "phi4_ragged": (24, 8, 128, 1000, (1, 999, 1000, 2345), None),
    "qwen2_5_3b": (16, 2, 128, 4096, (64, 1024, 4095, 4500), None),
    "internlm2": (16, 8, 128, 1000, (0, 500, 1000, 1001), None),
    "mixtral_ring": (48, 8, 128, 4096, (1000, 4096, 4400, 9000), 4096),
    "mixtral_window": (48, 8, 128, 4096, (300, 2000, 4500, 9000), 512),
    "whisper_self": (12, 12, 64, 448, (5, 40, 97, 128), None),
    "whisper_cross": (12, 12, 64, 1500, (1500, 1500, 1500, 1500), None),
    "smoke_d8": (8, 2, 8, 24, (0, 5, 24, 50), 8),
    "smoke_d16": (4, 2, 16, 40, (1, 13, 40, 77), None),
    "group16": (32, 2, 64, 300, (3, 150, 300, 700), None),
    "one_split": (8, 8, 64, 64, tuple(range(1, 240, 6)), None),
    "w1": (4, 2, 16, 1, (0, 1, 2, 9), None),
}


def _inputs(dev, h, kv, d, w, pos, seed=3):
    g = torch.Generator(device="cpu").manual_seed(seed)
    b = len(pos)
    q, kc, vc = (torch.randn(shape, generator=g).to(torch.bfloat16).to(dev)
                 for shape in ((b, h, d), (b, w, kv, d), (b, w, kv, d)))
    return q, kc, vc, torch.tensor(pos, dtype=torch.int32, device=dev)


def test_built_ring_is_the_wrappers(cuda):
    for dp in (16, 32, 64, 128, 256):
        keys, stages, most, smem = kern.dense_bf16_ring(dp)
        assert keys == kern.DENSE_KEYS
        assert most == kern.DENSE_MAX_SPLITS
        assert stages >= 3 and smem <= 232448


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_body_matches_plain(cuda, case):
    h, kv, d, w, pos, window = CASES[case]
    q, kc, vc, p = _inputs(cuda, h, kv, d, w, pos)
    before = kern.launches["decode_attention"]
    got = kern.decode_attention(q, kc, vc, p, window=window)
    want = kern.decode_attention_plain(q, kc, vc, p, window=window)
    torch.cuda.synchronize()
    assert kern.launches["decode_attention"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool(torch.isfinite(got.float()).all())
    assert _steps(got, want) <= 1.0
    # one fixed order of every sum: bit-reproducible
    assert torch.equal(kern.decode_attention(q, kc, vc, p, window=window),
                       got)
    if case not in ("w1", "one_split"):
        bad = kern.decode_attention(q, kc, vc, p - 1, window=window)
        assert _steps(bad, want) > 1.0


def test_one_split_case_runs_one_split(cuda):
    h, kv, d, w, pos, _ = CASES["one_split"]
    assert kern.dense_plan(torch.bfloat16, len(pos), kv, w,
                           kern._num_sms(cuda.index)) == 1


def test_a_call_is_one_kernel_and_allocates_only_its_output(cuda):
    h, kv, d, w, pos, window = CASES["mixtral_ring"]
    q, kc, vc, p = _inputs(cuda, h, kv, d, w, pos)
    kern.decode_attention(q, kc, vc, p, window=window)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    kern.decode_attention(q, kc, vc, p, window=window)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == \
        allocs + 1
    names = _kernels_of(lambda: kern.decode_attention(q, kc, vc, p,
                                                      window=window))
    assert set(names) == {n for n in names if "decode_mma_kernel" in n}
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


def test_rows_with_no_valid_key_get_the_uniform_mean(cuda):
    h, kv, d, w = 24, 8, 128, 1000
    q, kc, vc, p = _inputs(cuda, h, kv, d, w, (0, 0, 0))
    got = kern.decode_attention(q, kc, vc, p)
    mean = vc.float().mean(dim=1).repeat_interleave(h // kv, dim=1)
    assert _steps(got, mean.to(torch.bfloat16)) <= 1.0
