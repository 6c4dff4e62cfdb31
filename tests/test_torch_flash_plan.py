"""The bf16 flash kernel's launch plan (``flash_plan``), on the CPU.

The plan is a pure function of the shape, computed on the host before a
launch: the row width the kernel reads (D padded to a multiple of 8, as
TMA's 16-byte strides need), the tile width, the keys and stages of the
shared-memory ring, the key-range splits for short query blocks and the
workspace of their partial states. The kernel itself runs only on the card
(tests/test_torch_flash_kernel.py); these tests pin what the host decides.
"""

import pytest
import torch

from repro_torch.kernels import flash_attention as flash

SMS = flash.H100_SMS

# (bh, sq, sk, d, causal, window, splits): the shapes chip_smoke.py and the
# serving paths give the kernel, with the split each must take
SHAPES = {
    "train causal": (56, 2048, 2048, 64, True, None, 1),
    "train window 512": (56, 2048, 2048, 64, True, 512, 1),
    "train bidirectional": (56, 2048, 2048, 64, False, None, 1),
    "mixtral ring prefill": (48, 4500, 4500, 128, True, 4096, 1),
    "whisper encoder": (12, 1500, 1500, 64, False, None, 1),
    "whisper cross s_q 64": (12, 64, 1500, 64, False, None, 6),
    "whisper cross s_q 448": (12, 448, 1500, 64, False, None, 2),
    "whisper decoder prompt": (12, 64, 64, 64, True, None, 1),
    "smoke d 8": (12, 128, 128, 8, True, None, 1),
    "ragged s and d": (2, 200, 200, 12, True, None, 2),
    "d 256 window": (2, 192, 192, 256, True, 37, 3),
}


def _items(bh, sq):
    return -(-sq // flash.BLOCK_ROWS) * bh


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_splits_only_where_items_leave_sms_idle(name):
    bh, sq, sk, d, causal, window, want = SHAPES[name]
    plan = flash.flash_plan(bh, sq, sk, d, causal=causal, window=window)
    assert plan.splits == want
    items = _items(bh, sq)
    tiles = -(-sk // plan.keys)
    if 2 * items > SMS or tiles == 1:
        assert plan.splits == 1 and plan.workspace is None
    else:
        # one wave: no more work items than SMs, and no split left empty
        # on the item with the most key tiles
        assert items * plan.splits <= SMS
        assert plan.splits <= tiles
        assert plan.workspace == (plan.splits, bh, sq, plan.d_pad + 2)


@pytest.mark.parametrize("sq", [1, 64, 128, 129, 256, 448, 2048])
@pytest.mark.parametrize("bh", [1, 12, 66, 67])
def test_a_split_needs_idle_sms_and_more_than_one_tile(bh, sq):
    plan = flash.flash_plan(bh, sq, 1500, 64, causal=False, window=None)
    items = _items(bh, sq)
    assert (plan.splits > 1) == (2 * items <= SMS)
    assert flash.flash_plan(bh, sq, 100, 64, causal=False,
                            window=None).splits == 1  # one key tile


def test_one_sm_never_splits():
    plan = flash.flash_plan(1, 64, 4096, 64, causal=False, window=None,
                            num_sms=1)
    assert plan.splits == 1 and plan.workspace is None


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_same_shape_same_plan(name):
    bh, sq, sk, d, causal, window, _ = SHAPES[name]
    first = flash.flash_plan(bh, sq, sk, d, causal=causal, window=window)
    flash.flash_plan.cache_clear()
    again = flash.flash_plan(bh, sq, sk, d, causal=causal, window=window)
    assert again == first


@pytest.mark.parametrize("d", range(1, 257))
def test_every_head_dim_has_a_plan_within_shared_memory(d):
    plan = flash.flash_plan(4, 300, 300, d, causal=True, window=None)
    assert plan.smem <= 232448
    assert plan.d_pad % 8 == 0 and d <= plan.d_pad < d + 8
    assert plan.d_tile in flash.TILES and plan.d_pad <= plan.d_tile
    assert plan.d_tile == min(t for t in flash.TILES if t >= plan.d_pad)
    assert (plan.keys, plan.stages) == flash.TILES[plan.d_tile][:2]
    assert plan.rows == flash.BLOCK_ROWS


@pytest.mark.parametrize("d,d_pad", [(1, 8), (8, 8), (12, 16), (63, 64),
                                     (65, 72), (112, 112), (250, 256)])
def test_head_dims_pad_to_a_multiple_of_eight(d, d_pad):
    plan = flash.flash_plan(2, 64, 64, d, causal=True, window=None)
    assert plan.d_pad == d_pad


@pytest.mark.parametrize("bad", [dict(d=0), dict(d=257), dict(bh=0),
                                 dict(sq=0), dict(sk=0)])
def test_no_plan_raises(bad):
    args = dict(bh=2, sq=64, sk=64, d=64)
    args.update(bad)
    with pytest.raises(ValueError, match="flash plan"):
        flash.flash_plan(args["bh"], args["sq"], args["sk"], args["d"],
                         causal=False, window=None)


def test_cpu_tensors_take_the_plain_version_without_a_plan():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 40, 12), generator=g).to(torch.bfloat16)
               for _ in range(3))
    flash.flash_plan.cache_clear()
    before = flash.launches["flash_attention"]
    got = flash.flash_attention(q, k, v, causal=True)
    assert flash.launches["flash_attention"] == before
    assert flash.flash_plan.cache_info().currsize == 0
    assert torch.equal(got, flash.flash_attention_plain(q, k, v))
