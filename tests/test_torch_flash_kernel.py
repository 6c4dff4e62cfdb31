"""On-card checks of the bf16 flash kernel (``csrc/flash_attention.cu``,
warpgroup MMA over a TMA key/value ring), skipped without a GPU.

Run on a machine with an H100:
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_flash_kernel.py

In the order the kernel was built:
1. its two products alone (``wgmma_probe``): scores x . y^T from swizzled
   shared memory and x . y with x in registers, on small integers, where
   every product and sum is exact in fp32 whatever the order: equal to
   torch's product exactly;
2. one query tile over one key tile;
3. the ring, the masks (windows whose edge falls on and beside a tile
   edge), ragged key lengths, the key-range split and its merge, and every
   tile width of D.
Each call is held against ``flash_attention_plain`` as chip_smoke.py holds
the flash cases: max |error| within 2e-2 and, row by row, within FLASH_ROW_C
bf16 steps (2^-8) of the row's largest |value| (the kernel rounds the
probabilities to bf16 at other points than the plain version); a repeat
is bitwise equal. The kernel told a window one key off fails the row limit.
"""

import pytest
import torch

from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ref

pytestmark = pytest.mark.gpu

TOL = 2e-2
FLASH_ROW_C = ref.FLASH_ROW_C  # the row limit chip_smoke.py holds too


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, bh, sq, sk, d, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((bh, sq, d), generator=g).to(torch.bfloat16)
    k, v = (torch.randn((bh, sk, d), generator=g).to(torch.bfloat16)
            for _ in range(2))
    return q.to(dev), k.to(dev), v.to(dev)


def _held(q, k, v, *, causal, window=None):
    """The kernel against the plain version; returns the plan it ran. At
    D = 1 a row is one value, which cancellation between keys may bring
    near 0, where a bf16 rounding of the probabilities at another point is
    many steps of it: the row limit holds from D = 2 on, the absolute one
    everywhere."""
    before = flash.launches["flash_attention"]
    got = flash.flash_attention(q, k, v, causal=causal, window=window)
    assert flash.launches["flash_attention"] == before + 1
    want = flash.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL, err
    if q.shape[2] > 1:
        assert ref.row_steps(got, want) <= FLASH_ROW_C
    again = flash.flash_attention(q, k, v, causal=causal, window=window)
    assert torch.equal(got, again)  # one summation order, split or not
    bh, sq, d = q.shape
    return flash.flash_plan(bh, sq, k.shape[1], d, causal=causal,
                            window=window,
                            num_sms=flash._num_sms(q.device.index))


@pytest.mark.parametrize("d_tile", sorted(flash.TILES))
def test_plan_is_the_built_tile(cuda, d_tile):
    plan = flash.flash_plan(1, 64, 64, d_tile, causal=True, window=None)
    assert flash.bf16_tile(d_tile) == (plan.rows, plan.keys, plan.stages,
                                       plan.smem)


@pytest.mark.parametrize("k", [16, 32, 64])
def test_score_product_from_swizzled_shared_memory(cuda, k):
    """Build step 1: one warpgroup's wgmma m64n64k16 (k / 16 steps) of x
    (64, k) and y (64, k), both loaded by TMA in the 128-byte swizzle."""
    g = torch.Generator(device="cpu").manual_seed(k)
    x, y = (torch.randint(-4, 5, (64, k), generator=g).to(torch.bfloat16)
            .to(cuda) for _ in range(2))
    got = flash.wgmma_probe(0, x, y)
    torch.cuda.synchronize()
    assert torch.equal(got, x.float() @ y.float().T)


@pytest.mark.parametrize("k", [16, 32, 64])
def test_value_product_from_registers(cuda, k):
    """Build step 1, second product: x (64, k) in the score accumulator's
    layout converted to bf16 words in registers, times y (k, 64) through
    the transposed shared-memory descriptor."""
    g = torch.Generator(device="cpu").manual_seed(100 + k)
    x = torch.randint(-4, 5, (64, k), generator=g).to(torch.bfloat16)
    y = torch.randint(-4, 5, (k, 64), generator=g).to(torch.bfloat16)
    got = flash.wgmma_probe(1, x.to(cuda), y.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), x.float() @ y.float())


@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, None)])
@pytest.mark.parametrize("s", [1, 64, 128])
def test_one_query_tile_over_one_key_tile(cuda, s, causal, window):
    """Build step 2: the block's 128 rows over one 128-key tile."""
    q, k, v = _qkv(cuda, 2, s, s, 64, seed=s)
    plan = _held(q, k, v, causal=causal, window=window)
    assert plan.splits == 1


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("edge", [-1, 0, 1])
@pytest.mark.parametrize("tiles", [1, 2])
def test_window_edge_on_and_beside_a_tile_edge(cuda, d, edge, tiles):
    keys = flash.TILES[d][0]
    window = tiles * keys + edge
    q, k, v = _qkv(cuda, 3, 4 * keys + 37, 4 * keys + 37, d, seed=window)
    _held(q, k, v, causal=True, window=window)


@pytest.mark.parametrize("d", [64, 128])
def test_window_one_key_off_fails_the_row_limit(cuda, d):
    q, k, v = _qkv(cuda, 4, 700, 700, d, seed=d)
    want = flash.flash_attention_plain(q, k, v, causal=True, window=256)
    for w in (255, 257):
        bad = flash.flash_attention(q, k, v, causal=True, window=w)
        assert ref.row_steps(bad, want) > FLASH_ROW_C


@pytest.mark.parametrize("sq,sk", [(100, 129), (100, 300), (7, 1000),
                                   (300, 1)])
def test_key_lengths_that_are_no_multiple_of_the_tile(cuda, sq, sk):
    q, k, v = _qkv(cuda, 3, sq, sk, 64, seed=sq + sk)
    _held(q, k, v, causal=False)


@pytest.mark.parametrize("s", [130, 333, 1000])
def test_causal_lengths_that_are_no_multiple_of_the_tile(cuda, s):
    q, k, v = _qkv(cuda, 3, s, s, 64, seed=s)
    _held(q, k, v, causal=True)


@pytest.mark.parametrize("bh,sq,sk,d,causal,window", [
    (12, 64, 1500, 64, False, None),   # Whisper's cross-attention
    (12, 448, 1500, 64, False, None),
    (2, 200, 200, 12, True, None),     # causal: late splits hold no tile
    (2, 300, 300, 128, True, 150),
    (1, 100, 4000, 256, False, None),
    (3, 64, 700, 128, False, None),
])
def test_key_range_split_and_merge(cuda, bh, sq, sk, d, causal, window):
    q, k, v = _qkv(cuda, bh, sq, sk, d, seed=sq + d)
    plan = _held(q, k, v, causal=causal, window=window)
    assert plan.splits > 1


def test_split_told_one_key_less_fails_the_limits(cuda):
    q, k, v = _qkv(cuda, 12, 64, 1500, 64, seed=5)
    want = flash.flash_attention_plain(q, k, v, causal=False)
    bad = flash.flash_attention(q, k, v, causal=False, drop_last_key=True)
    err = float((bad.float() - want.float()).abs().max())
    assert err > TOL or ref.row_steps(bad, want) > FLASH_ROW_C


@pytest.mark.parametrize("d", [1, 8, 12, 16, 40, 64, 72, 100, 128, 136,
                               200, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_every_tile_width(cuda, d, causal):
    q, k, v = _qkv(cuda, 4, 300, 300, d, seed=d)
    _held(q, k, v, causal=causal)


def test_unaligned_rows_are_copied_not_refused(cuda):
    q, k, v = _qkv(cuda, 2, 65, 65, 64, seed=9)
    # contiguous views that start 2 bytes into their storage
    qo, ko, vo = (torch.cat([t.flatten(), t.flatten()[:1]])[1:]
                  .view(t.shape) for t in (q, k, v))
    assert qo.data_ptr() % 16 != 0
    got = flash.flash_attention(qo, ko, vo, causal=True)
    want = flash.flash_attention(qo.clone(), ko.clone(), vo.clone(),
                                 causal=True)
    assert torch.equal(got, want)
