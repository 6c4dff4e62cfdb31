"""CPU checks of the matmul kernel's launch plan (kernels/matmul.py): the
padding rule that gives the bf16 body's TMA loads rows of whole 16-byte
chunks, and the order in which its persistent blocks walk the output
tiles. The kernel itself runs only on the card
(tests/test_torch_matmul_kernel.py)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ref

# (M, K, N) of tests/test_torch_gpu.py's matmul cases and qwen2-0.5B's MLP
# up projection
SHAPES = [(128, 128, 128), (256, 512, 256), (512, 1024, 128),
          (200, 300, 136), (1, 7, 3), (130, 1, 250), (67, 96, 40),
          (4096, 896, 4864)]


def _bf16(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(torch.bfloat16)


@pytest.mark.parametrize("cols", [8, 16, 64, 136, 896, 4864])
def test_aligned_operands_are_never_copied(cols):
    x = _bf16((5, cols), cols)
    assert mm.tma_operand(x) is x


@pytest.mark.parametrize("cols", [1, 3, 7, 9, 250, 300])
def test_ragged_operands_get_zero_columns(cols):
    x = _bf16((6, cols), cols)
    y = mm.tma_operand(x)
    assert y.is_contiguous() and y.shape == (6, -(-cols // 8) * 8)
    assert torch.equal(y[:, :cols], x)
    assert not bool(y[:, cols:].any())


def test_a_misaligned_base_is_copied():
    flat = torch.zeros(4 * 16 + 1, dtype=torch.bfloat16)
    x = flat[1:].view(4, 16)
    assert x.data_ptr() % 16
    y = mm.tma_operand(x)
    assert y is not x and y.data_ptr() % 16 == 0 and torch.equal(y, x)


@pytest.mark.parametrize("m,k,n", SHAPES[:-1])
def test_padded_operands_give_the_plain_product(m, k, n):
    """What the bf16 body multiplies (the padded operands; B's rows past K
    read as zeros) is the plain product, in float64 exactly: every bf16
    product and its sum over K <= 1024 terms is exact there."""
    a, b = _bf16((m, k), m), _bf16((k, n), n)
    a2, b2 = mm.tma_operand(a), mm.tma_operand(b)
    assert a2.shape[1] % 8 == 0 and b2.shape[1] % 8 == 0
    b2 = F.pad(b2, (0, 0, 0, a2.shape[1] - k))  # rows K.. read as zeros
    got = (a2.double() @ b2.double())[:, :n]
    assert torch.equal(got, a.double() @ b.double())
    assert torch.equal(mm.matmul(a, b, out_dtype=torch.float32),
                       ref.matmul_ref(a, b, torch.float32))


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("sms", [1, 4, 132])
def test_every_tile_is_visited_once(m, k, n, sms):
    bm, bn, _, _, _ = mm.BF16_TILE
    walk = mm.tile_walk(m, n, sms)
    tiles = -(-m // bm) * -(-n // bn)
    assert len(walk) == min(tiles, sms)
    seen = [t for block in walk for t in block]
    assert sorted(seen) == [(i, j) for i in range(-(-m // bm))
                            for j in range(-(-n // bn))]
    # as even as a round robin: block loads differ by at most one tile
    assert max(map(len, walk)) - min(map(len, walk)) <= 1


def test_the_walk_is_fixed_and_grouped():
    """Walk position t is blockIdx + round * blocks; positions go down
    groups of 8 tile rows, column by column, so the 132 blocks of one
    round at qwen's shape share 8 row panels of A."""
    assert mm.tile_walk(3 * 128, 2 * 256, 4) == [
        [(0, 0), (1, 1)], [(1, 0), (2, 1)], [(2, 0)], [(0, 1)]]
    assert mm.tile_walk(4096, 4864, 132) == mm.tile_walk(4096, 4864, 132)
    walk = mm.tile_walk(4096, 4864, 132)
    first_round = [block[0] for block in walk]
    group = mm.BF16_TILE[4]
    assert {tm for tm, _ in first_round} == set(range(group))
    assert first_round[:group + 1] == [(i, 0) for i in range(group)] + [
        (0, 1)]


def test_k_tile_is_the_bodies_own():
    assert mm.K_TILE[torch.bfloat16] == mm.BF16_TILE[2] == 64
    assert mm.K_TILE[torch.float32] == 16
