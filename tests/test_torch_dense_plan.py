"""CPU checks of the dense ring decode kernel's launch plan
(kernels/decode_attention.py): how many blocks (key-range splits) a row's
keys go to, and which ring slots each of them streams. Every valid key of
every row, as the plain version's mask defines it, falls in exactly one
split; a row with no valid key streams all W slots (the uniform mean). The
bf16 body's splits are the blocks of one thread-block cluster, at most 8;
the f32 body keeps the plan it had. The kernels themselves run only on the
card (tests/test_torch_dense_decode_kernel.py)."""

import pytest
import torch

from repro_torch.kernels import decode_attention as kern

# (W, window, rows' pos): a ring that wraps, windows below W, pos 0 (no
# valid key), pos past W, W = 1, the serving shapes' widths
RINGS = [
    (4096, None, (0, 1000, 4096, 6000)),
    (1000, None, (1, 999, 1000, 2345)),
    (4096, 512, (300, 2000, 4500, 9000)),
    (4096, 4096, (1000, 4096, 4400, 9000)),
    (1056, None, (211, 530, 817, 1050)),
    (448, None, (5, 40, 97, 128)),
    (1500, None, (1500,)),
    (24, 8, (0, 5, 24, 50)),
    (1, None, (0, 1, 2, 9)),
    (1, 1, (0, 1, 5)),
    (64, 3, (0, 1, 2, 3, 64, 65, 200)),
]


def _valid_slots(pos, w, window):
    """The slots the plain version (ref.decode_attention_ref) weighs."""
    slot = torch.arange(w)
    abs_pos = slot + torch.clamp(pos - 1 - slot, min=0) // w * w
    valid = abs_pos < pos
    if window is not None:
        valid &= abs_pos >= pos - window
    return set(torch.nonzero(valid).flatten().tolist())


@pytest.mark.parametrize("keys", [kern.DENSE_KEYS, kern.DENSE_F32_KEYS])
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("w,window,rows", RINGS)
def test_every_valid_key_is_in_exactly_one_split(w, window, rows, splits,
                                                 keys):
    for pos in rows:
        parts = kern.dense_split_slots(pos, w, window, splits, keys)
        assert len(parts) == splits
        flat = [s for part in parts for s in part]
        want = _valid_slots(pos, w, window) or set(range(w))
        assert len(flat) == len(set(flat)) == len(want)
        assert set(flat) == want
        # a split streams whole stages of consecutive keys; the first
        # split is never empty
        assert parts[0]


@pytest.mark.parametrize("w,window,rows", RINGS)
def test_row_keys_mark_the_rows_with_no_valid_key(w, window, rows):
    for pos in rows:
        start, n, masked = kern.dense_row_keys(pos, w, window)
        assert masked == (not _valid_slots(pos, w, window))
        assert 0 <= start < w and 1 <= n <= w


@pytest.mark.parametrize("b", [1, 2, 4, 8, 33, 300])
@pytest.mark.parametrize("kv", [1, 2, 8, 12])
@pytest.mark.parametrize("w", [1, 24, 448, 1056, 4096])
def test_bf16_splits_keep_one_block_an_sm_in_one_cluster(b, kv, w):
    sms = 132
    s = kern.dense_plan(torch.bfloat16, b, kv, w, sms)
    assert 1 <= s <= kern.DENSE_MAX_SPLITS
    assert s <= -(-w // kern.DENSE_KEYS)  # no split without a stage
    if s > 1:
        assert b * kv * s <= sms  # at most one block an SM
    if s < kern.DENSE_MAX_SPLITS and s < -(-w // kern.DENSE_KEYS):
        assert s & (s - 1) == 0 and b * kv * 2 * s > sms  # no room to double


def test_serving_shapes_plan():
    # phi4's dense serve (B 4, KV 8, W 1056), Mixtral's ring (B 4, KV 8,
    # W 4096), Whisper's self and cross attention at max_batch 4 and at one
    # request (KV 12; the self attention's 448 slots are 7 stages),
    # qwen2.5-3B's 2 KV heads at B 4, and a batch past the SM count
    assert kern.dense_plan(torch.bfloat16, 4, 8, 1056, 132) == 4
    assert kern.dense_plan(torch.bfloat16, 4, 8, 4096, 132) == 4
    assert kern.dense_plan(torch.bfloat16, 4, 12, 448, 132) == 2
    assert kern.dense_plan(torch.bfloat16, 4, 12, 1500, 132) == 2
    assert kern.dense_plan(torch.bfloat16, 1, 12, 448, 132) == 7
    assert kern.dense_plan(torch.bfloat16, 1, 12, 1500, 132) == 8
    assert kern.dense_plan(torch.bfloat16, 4, 2, 4096, 132) == 8
    assert kern.dense_plan(torch.bfloat16, 40, 8, 64, 132) == 1


@pytest.mark.parametrize("b,kv,w,sms,want", [
    (4, 8, 1056, 132, 9), (4, 8, 4096, 132, 9), (1, 2, 24, 132, 1),
    (20, 8, 4096, 132, 1), (3, 2, 2000, 132, 32), (4, 2, 4096, 132, 32),
    (4, 12, 1500, 132, 6), (2, 2, 100, 132, 4), (0, 8, 64, 132, 1)])
def test_f32_route_keeps_its_plan(b, kv, w, sms, want):
    """The f32 body's splits, as its C entry computed them before the plan
    moved to the wrapper: ceil(2 SMs / (B KV)) capped by W's 32-key tiles
    and 32, and 1 once B KV reaches the SM count."""
    assert kern.dense_plan(torch.float32, b, kv, w, sms) == want


def test_cpu_tensors_take_the_plain_version():
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 6, 16), generator=g).bfloat16()
    kc = torch.randn((2, 40, 2, 16), generator=g).bfloat16()
    vc = torch.randn((2, 40, 2, 16), generator=g).bfloat16()
    pos = torch.tensor([0, 57], dtype=torch.int32)
    before = kern.launches["decode_attention"]
    got = kern.decode_attention(q, kc, vc, pos)
    assert kern.launches["decode_attention"] == before
    assert torch.equal(got, kern.decode_attention_plain(q, kc, vc, pos))
