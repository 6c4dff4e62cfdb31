"""The dense ring decode-attention oracle of the port against the JAX
package's two entries on the same seeded numpy inputs: the Pallas kernel
in interpret mode (``ops.decode_attention(impl="interpret")``, as
tests/test_kernels.py runs it) and its jnp oracle (``impl="ref"``).

The port's sides are ``ref.decode_attention_ref``, the CUDA wrapper given
CPU tensors (which computes its plain version) and
``ops.decode_attention(impl="ref")``. Cases: GQA groups 1, 2, 3 and 8;
rows whose ``pos`` is below the cache width W (one of them 0, which
averages every slot), equal to it, and past it (the ring has wrapped);
with and without a sliding window; f32 and bf16. Tolerance: f32 within
1e-5 (summation order); bf16 within one bf16 step of each row's largest
|value| (both sides round an fp32 result to bf16)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import decode_attention as kern
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

W, D = 64, 32
GROUPS = {1: (4, 4), 2: (4, 2), 3: (6, 2), 8: (8, 1)}  # group: (H, KV)
POS = {"below": (0, 37), "equal": (64, 64), "past": (65, 150)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _check(got: torch.Tensor, want, dtype: str) -> None:
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape
    if dtype == "f32":
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        return
    row_max = np.abs(w).max(axis=-1, keepdims=True)
    step = 2.0 ** (np.floor(np.log2(np.maximum(row_max, 1e-30))) - 7)
    assert (np.abs(g - w) <= step).all(), np.abs(g - w).max()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("pos", sorted(POS))
@pytest.mark.parametrize("groups", sorted(GROUPS))
def test_decode_attention_oracle_matches_jax(groups, pos, window, dtype):
    h, kv = GROUPS[groups]
    rng = np.random.default_rng(100 * groups + len(pos))
    q = rng.standard_normal((2, h, D)).astype(np.float32)
    kc = rng.standard_normal((2, W, kv, D)).astype(np.float32)
    vc = rng.standard_normal((2, W, kv, D)).astype(np.float32)
    p = np.asarray(POS[pos], np.int32)
    jdt, tdt = DTYPES[dtype]
    jargs = (jnp.asarray(q, jdt), jnp.asarray(kc, jdt), jnp.asarray(vc, jdt),
             jnp.asarray(p))
    wants = [jops.decode_attention(*jargs, impl="interpret", window=window,
                                   block_k=32),
             jops.decode_attention(*jargs, impl="ref", window=window)]
    targs = (torch.from_numpy(q).to(tdt), torch.from_numpy(kc).to(tdt),
             torch.from_numpy(vc).to(tdt), torch.from_numpy(p))
    before = kern.launches["decode_attention"]
    gots = [tref.decode_attention_ref(*targs, window=window),
            kern.decode_attention(*targs, window=window),
            tops.decode_attention(*targs, impl="ref", window=window)]
    assert kern.launches["decode_attention"] == before  # CPU: no launch
    for got in gots:
        assert got.dtype == tdt
        for want in wants:
            _check(got, want, dtype)


def test_wrapper_refuses_bad_inputs():
    q = torch.zeros((2, 4, 8))
    kc = torch.zeros((2, 16, 2, 8))
    with pytest.raises(ValueError, match="impl"):
        tops.decode_attention(q, kc, kc, torch.zeros(2, dtype=torch.int32),
                              impl="triton")
    with pytest.raises(ValueError, match="CUDA"):
        tops.decode_attention(q, kc, kc, torch.zeros(2, dtype=torch.int32),
                              impl="cuda")
    # the kernel's own checks, reached only with CUDA tensors
    with pytest.raises(ValueError, match="CUDA"):
        kern._check_dense(q, kc, kc, torch.zeros(2, dtype=torch.int32),
                          None)
