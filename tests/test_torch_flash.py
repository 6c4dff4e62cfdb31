"""Flash attention of the port against the JAX package on the CPU.

* ``ref.flash_attention_ref`` against JAX's oracle, and the kernel's
  plain version (what the wrapper computes for CPU tensors) against the
  Pallas kernel in interpret mode, over causal, windowed and
  bidirectional masks, S in {128, 256}, D in {8, 64}: atol 1e-5 (fp32
  summation order).
* ``full_attention`` on its plain, q-chunked route against JAX's "xla"
  and "pallas_interpret" routes on GQA shapes: atol 1e-5.
* The autograd function of the kernel route (forward through
  ``kernels.ops.flash_attention``, here with ``impl="ref"``, the oracle
  standing in for the kernel; backward the gradient of the q-chunked
  plain path) against ``jax.grad`` of JAX's
  "xla" ``full_attention``: rtol 1e-5, with an absolute floor of 1e-6 of
  the largest gradient for entries near zero.

All in fp32 with ``jax_default_matmul_precision="highest"``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

jax.config.update("jax_default_matmul_precision", "highest")

MASKS = {"causal": (True, None), "window": (True, 48),
         "bidirectional": (False, None)}


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("d", [8, 64])
def test_flash_matches_jax(mask, s, d):
    causal, window = MASKS[mask]
    q, k, v = _qkv((3, s, d), seed=s + d)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    want_ref = np.asarray(jref.flash_attention_ref(
        jq, jk, jv, causal=causal, window=window))
    want_kernel = np.asarray(jops.flash_attention(
        jq, jk, jv, impl="interpret", causal=causal, window=window))
    got_ref = tref.flash_attention_ref(tq, tk, tv, causal=causal,
                                       window=window)
    assert torch.equal(got_ref, tops.flash_attention(
        tq, tk, tv, impl="ref", causal=causal, window=window))
    before = tflash.launches["flash_attention"]
    got_plain = tflash.flash_attention(tq, tk, tv, causal=causal,
                                       window=window)
    assert tflash.launches["flash_attention"] == before  # CPU: no launch
    np.testing.assert_allclose(got_ref.numpy(), want_ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_plain.numpy(), want_kernel, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got_plain.numpy(), want_ref, rtol=0,
                               atol=1e-5)


def test_cuda_route_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _qkv((2, 128, 8), seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tflash._check(q, k, v, None)
    cfg = get_smoke("qwen2_0_5b")
    q4 = q.reshape(1, 2, 128, 8).transpose(1, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.full_attention(q4, q4, q4, cfg, impl="cuda")


def _gqa(b, s, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kv, d)).astype(np.float32),
            rng.standard_normal((b, s, kv, d)).astype(np.float32))


CASES = {
    # name: (attn_type, window, s, q_chunk)
    "causal": ("causal", None, 256, 64),
    "window": ("causal", 40, 128, 32),
    "bidirectional": ("bidirectional", None, 128, 48),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_full_attention_matches_jax(case):
    atype, window, s, q_chunk = CASES[case]
    cfg = dataclasses.replace(get_smoke("qwen2_0_5b"), attn_type=atype,
                              sliding_window=window)
    q, k, v = _gqa(2, s, 6, 2, 8, seed=s)
    jin = [jnp.asarray(x) for x in (q, k, v)]
    got = tattn.full_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               cfg, q_chunk=q_chunk, impl="ref").numpy()
    for impl in ("xla", "pallas_interpret"):
        want = np.asarray(jattn.full_attention(*jin, cfg, q_chunk=q_chunk,
                                               impl=impl))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                   err_msg=impl)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_route_gradient_matches_jax(case):
    atype, window, s, q_chunk = CASES[case]
    cfg = dataclasses.replace(get_smoke("qwen2_0_5b"), attn_type=atype,
                              sliding_window=window)
    q, k, v = _gqa(2, s, 6, 2, 8, seed=s + 1)
    cot = np.random.default_rng(7).standard_normal(q.shape).astype(
        np.float32)

    def jloss(q, k, v):
        out = jattn.full_attention(q, k, v, cfg, q_chunk=q_chunk, impl="xla")
        return jnp.sum(out * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tattn._FlashAttention.apply(*leaves, atype, window, q_chunk,
                                      "ref")
    # the forward is the flash kernel's (here the oracle stands in)
    plain = tattn._chunked_attention(*(x.detach() for x in leaves), atype,
                                     window, q_chunk)
    np.testing.assert_allclose(out.detach().numpy(), plain.numpy(), rtol=0,
                               atol=1e-5)
    (out * torch.from_numpy(cot)).sum().backward()
    for name, leaf, w in zip("qkv", leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max(),
                                   err_msg=f"d{name}")
