"""On-card checks of the matmul kernel's bf16 body (``csrc/matmul.cu``,
warpgroup MMA over a TMA ring in persistent blocks), skipped without a GPU.

Run on a machine with an H100:
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_matmul_kernel.py

Each call is held against ``ref.matmul_ref`` with the limit that
tests/test_torch_gpu.py and chip_smoke.py hold the matmul to (bf16 out: one
bf16 step of the largest |value|; f32 out: 4 sqrt(K) f32 steps of it, the
summation order): the self-test's and the JAX tests' shapes, ragged edges
(rows of K or N that TMA cannot take and the wrapper pads), K = 0, tiles
at every edge, more tiles than SMs (the persistent walk) and qwen2-0.5B's
MLP up projection. A repeat is bitwise equal; the kernel with its last K
tile dropped fails the limit; an aligned call is one kernel launch.
"""

import pytest
import torch

from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ref

pytestmark = pytest.mark.gpu

EPS32 = 1.1920929e-07


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _limit(want, k, out_dtype):
    big = float(want.float().abs().max())
    if out_dtype == torch.bfloat16:
        return 2.0 ** -7 * big + 1e-6
    return 4 * k ** 0.5 * EPS32 * big + 1e-6


def _operands(dev, m, k, n, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randn((m, k), generator=g).to(torch.bfloat16)
    b = torch.randn((k, n), generator=g).to(torch.bfloat16)
    return a.to(dev), b.to(dev)


# (M, K, N): the self-test's 128^3 and the JAX test shapes; ragged K and N
# (padded copies); K = 1 and K = 0; partial tiles at both edges; 256 tiles
# on 132 SMs; qwen2-0.5B's MLP up projection of a 4096-token prefill
SHAPES = [(128, 128, 128), (256, 512, 256), (512, 1024, 128),
          (200, 300, 136), (1, 7, 3), (130, 1, 250), (67, 96, 40),
          (7, 0, 9), (300, 200, 520), (2048, 512, 4096),
          (4096, 896, 4864)]


def test_built_tile_is_the_wrappers(cuda):
    bm, bn, bk, stages, group, smem = mm.bf16_tile()
    assert (bm, bn, bk, stages, group) == mm.BF16_TILE
    assert mm.K_TILE[torch.bfloat16] == bk
    assert smem <= 232448


@pytest.mark.parametrize("out_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_bf16_body_matches_plain(cuda, m, k, n, out_dt):
    a, b = _operands(cuda, m, k, n, seed=m + k + n)
    before = mm.launches["matmul"]
    got = mm.matmul(a, b, out_dtype=out_dt)
    assert mm.launches["matmul"] == before + 1
    want = ref.matmul_ref(a, b, out_dt)
    torch.cuda.synchronize()
    assert got.dtype == out_dt and got.shape == (m, n)
    assert bool(torch.isfinite(got).all())
    err = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    assert err <= _limit(want, k, out_dt), err
    # one fixed summation order: bit-reproducible
    assert torch.equal(mm.matmul(a, b, out_dtype=out_dt), got)


def test_misaligned_operands_are_copied(cuda):
    """A contiguous operand whose base is not on 16 bytes goes through a
    padded copy, with the same result."""
    m, k, n = 96, 64, 80
    a, b = _operands(cuda, m, k, n, seed=5)
    flat = torch.empty(m * k + 1, dtype=torch.bfloat16, device=cuda)
    a_off = flat[1:].view(m, k)
    a_off.copy_(a)
    assert a_off.data_ptr() % 16 != 0
    assert torch.equal(mm.matmul(a_off, b, out_dtype=torch.float32),
                       mm.matmul(a, b, out_dtype=torch.float32))


def test_dropping_the_last_k_tile_fails_the_limit(cuda):
    for m, k, n in ((200, 300, 136), (4096, 896, 4864)):
        a, b = _operands(cuda, m, k, n, seed=1)
        want = ref.matmul_ref(a, b, torch.float32)
        kt = mm.K_TILE[torch.bfloat16]
        cut = k - (k % kt or kt)
        bad = mm.matmul(a[:, :cut].contiguous(), b[:cut].contiguous(),
                        out_dtype=torch.float32)
        err = float((bad - want).abs().max())
        assert err > _limit(want, k, torch.float32), err


def test_aligned_call_is_one_kernel(cuda):
    """CALLS calls under torch.profiler record only the body's kernel, at
    most once a call (a session may lose a device event, most often its
    first: it opens with a marker fill of its own, which is left out)."""
    a, b = _operands(cuda, 512, 896, 1024)
    mm.matmul(a, b)
    marker = torch.empty(4096, dtype=torch.uint8, device=cuda)
    torch.cuda.synchronize()
    calls = 5
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        marker.zero_()
        torch.cuda.synchronize()
        for _ in range(calls):
            mm.matmul(a, b)
        torch.cuda.synchronize()
    names = []
    for e in prof.key_averages():
        if ("CUDA" in str(getattr(e, "device_type", ""))
                and "FillFunctor<unsigned char>" not in e.key):
            names += [e.key] * e.count
    assert set(names) == {n for n in names if "matmul_wgmma_kernel" in n}
    assert 1 <= len(names) <= calls, names
