"""Paged-attention kernels of the port, CPU side: the plain-torch versions
(what the CUDA kernels are held to on the card) against the JAX package's
oracle (``repro.kernels.ref``) and its Pallas kernels in interpret mode,
on the same numpy inputs.

Tolerances: f32 at 1e-5 (only summation order differs); bf16 at 2e-2,
because the gather oracle rounds the gathered view to bf16 while the
Pallas body dequantizes in f32."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jdec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.blocks import paged_quantize as j_paged_quantize
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import matmul as tmatmul
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

B, H, KV, P, M = 3, 6, 2, 8, 4
N = 1 + B * M
TOL = {"f32": 1e-5, "bf16": 2e-2, "int8": 1e-5}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.float32}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.float32}


def _case(d, t, pages, seed=0):
    """Numpy inputs for both sides; int8 scales come from JAX's own
    ``paged_quantize``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, t, H, d)).astype(np.float32)
    k = rng.standard_normal((N, P, KV, d)).astype(np.float32)
    v = rng.standard_normal((N, P, KV, d)).astype(np.float32)
    table = (1 + rng.permutation(N - 1)[:B * M]).reshape(B, M)
    table[0, -1] = 0  # a padded entry: the trash page
    table = table.astype(np.int32)
    # mixed per-row positions: decode needs pos >= 1, a span fits the row
    pos = (np.array([1, 13, M * P], np.int32) if t == 1
           else np.array([0, 9, M * P - t], np.int32))
    jq = jnp.asarray(q, JDT[pages])
    if pages == "int8":
        jk, jks = j_paged_quantize(jnp.asarray(k), jnp.int8)
        jv, jvs = j_paged_quantize(jnp.asarray(v), jnp.int8)
    else:
        jk, jv = jnp.asarray(k, JDT[pages]), jnp.asarray(v, JDT[pages])
        jks = jvs = None
    jside = (jq, jk, jv, jnp.asarray(table), jnp.asarray(pos), jks, jvs)

    def to_torch(x):
        if x is None:
            return None
        if x.dtype == jnp.bfloat16:
            return torch.from_numpy(np.asarray(x, np.float32)).to(
                torch.bfloat16)
        return torch.from_numpy(np.array(x))

    return jside, tuple(to_torch(x) for x in jside)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


CASES = list(itertools.product([8, 64], [None, 5], [1, 5],
                               ["f32", "bf16", "int8"]))


@pytest.mark.parametrize("d,window,t,pages", CASES)
def test_plain_matches_jax_ref_and_interpret(d, window, t, pages):
    (jq, jk, jv, jtab, jpos, jks, jvs), (q, k, v, tab, pos, ks, vs) = \
        _case(d, t, pages)
    if t == 1:
        want_ref = jops.paged_decode_attention(
            jq[:, 0], jk, jv, jtab, jpos, k_scale=jks, v_scale=jvs,
            impl="ref", window=window)
        want_pl = jdec.paged_decode_attention(
            jq[:, 0], jk, jv, jtab, jpos, k_scale=jks, v_scale=jvs,
            window=window, interpret=True)
        got = tdec.paged_decode_attention(
            q[:, 0], k, v, tab, pos, k_scale=ks, v_scale=vs, window=window)
        got_ops = tops.paged_decode_attention(
            q[:, 0], k, v, tab, pos, k_scale=ks, v_scale=vs, impl="ref",
            window=window)
    else:
        want_ref = jops.paged_decode_span_attention(
            jq, jk, jv, jtab, jpos, k_scale=jks, v_scale=jvs, impl="ref",
            window=window)
        want_pl = jdec.paged_decode_span_attention(
            jq, jk, jv, jtab, jpos, k_scale=jks, v_scale=jvs,
            window=window, interpret=True)
        got = tdec.paged_decode_span_attention(
            q, k, v, tab, pos, k_scale=ks, v_scale=vs, window=window)
        got_ops = tops.paged_decode_span_attention(
            q, k, v, tab, pos, k_scale=ks, v_scale=vs, impl="ref",
            window=window)
    assert got.dtype == TDT[pages] and got.shape == tuple(want_ref.shape)
    tol = TOL[pages]
    np.testing.assert_allclose(_f32(got), _f32(want_ref), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(_f32(got), _f32(want_pl), atol=tol, rtol=tol)
    np.testing.assert_array_equal(_f32(got_ops), _f32(got))


def test_gather_dequant_matches_jax():
    (_, jk, _, jtab, _, jks, _), (_, k, _, tab, _, ks, _) = \
        _case(8, 1, "int8")
    want = jref.paged_gather_dequant_ref(jk, jtab, jks, jnp.float32)
    got = tref.paged_gather_dequant_ref(k, tab, ks, torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_row_without_valid_key_is_uniform_mean():
    """pos = 0 leaves a decode row no valid key. The reference softmax
    over all -1e30 scores is uniform, so the row is the mean of every slot
    of its table row; the port (plain here, the kernel on the card) keeps
    that behaviour instead of raising."""
    (jq, jk, jv, jtab, _, _, _), (q, k, v, tab, _, _, _) = \
        _case(8, 1, "f32")
    pos = np.array([0, 5, 9], np.int32)
    got = tdec.paged_decode_attention(q[:, 0], k, v, tab,
                                      torch.from_numpy(pos))
    want = jdec.paged_decode_attention(jq[:, 0], jk, jv, jtab,
                                       jnp.asarray(pos), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    mean = v[tab[0].long()].reshape(-1, KV, 8).mean(0)
    np.testing.assert_allclose(got[0].numpy(),
                               mean.repeat_interleave(H // KV, 0).numpy(),
                               atol=1e-6)


def test_cuda_impl_refuses_cpu_tensors():
    _, (q, k, v, tab, pos, _, _) = _case(8, 1, "f32")
    with pytest.raises(ValueError, match="CUDA"):
        tops.paged_decode_attention(q[:, 0], k, v, tab, pos, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tops.paged_decode_span_attention(q, k, v, tab, pos, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        tops.paged_decode_attention(q[:, 0], k, v, tab, pos, impl="xla")


# ---------------------------------------------------------------- matmul


def _mm_inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


@pytest.mark.parametrize("m,k,n", [(256, 512, 256), (512, 1024, 128),
                                   (128, 128, 128)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_matmul_ref_matches_jax_interpret(m, k, n, dtype):
    """The plain twin (what the CUDA kernel is held to on the card)
    against the Pallas kernel in interpret mode and the jnp oracle, with
    the JAX test's tolerances (tests/test_kernels.py)."""
    a, b = _mm_inputs(m, k, n, seed=m + k + n)
    ja, jb = jnp.asarray(a, JDT[dtype]), jnp.asarray(b, JDT[dtype])
    ta = torch.from_numpy(np.array(ja, np.float32)).to(TDT[dtype])
    tb = torch.from_numpy(np.array(jb, np.float32)).to(TDT[dtype])
    want = jops.matmul(ja, jb, impl="interpret", out_dtype=jnp.float32,
                       block_m=128, block_n=128, block_k=128)
    got = tops.matmul(ta, tb, impl="ref", out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    tol = 2e-2 if dtype == "bf16" else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol * 8)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.matmul_ref(ja, jb, jnp.float32)),
        rtol=tol, atol=tol * 8)
    # default out dtype: the inputs'
    assert tref.matmul_ref(ta, tb).dtype == TDT[dtype]


def test_matmul_ref_fp8_storage_matches_jax():
    a, b = _mm_inputs(128, 256, 128, seed=3)
    ja = jnp.asarray(a).astype(jnp.float8_e4m3fn).astype(jnp.bfloat16)
    jb = jnp.asarray(b).astype(jnp.float8_e4m3fn).astype(jnp.bfloat16)
    ta = torch.from_numpy(a).to(torch.float8_e4m3fn).to(torch.bfloat16)
    tb = torch.from_numpy(b).to(torch.float8_e4m3fn).to(torch.bfloat16)
    # the fp8 round trip is the same in both frameworks, bit for bit
    np.testing.assert_array_equal(ta.float().numpy(),
                                  np.asarray(ja, np.float32))
    want = jops.matmul(ja, jb, impl="interpret", out_dtype=jnp.float32,
                       block_m=128, block_n=128, block_k=128)
    got = tops.matmul(ta, tb, impl="ref", out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-2,
                               atol=0.5)


def test_matmul_wrapper_on_the_cpu_and_its_checks():
    a, b = _mm_inputs(5, 7, 3, seed=0)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    before = tmatmul.launches["matmul"]
    got = tmatmul.matmul(ta, tb, out_dtype=torch.bfloat16)  # plain on CPU
    assert tmatmul.launches["matmul"] == before  # no kernel, no count
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(),
        torch.from_numpy(a.astype(np.float32) @ b).to(
            torch.bfloat16).float().numpy())
    with pytest.raises(ValueError, match="contraction"):
        tmatmul.matmul(ta, ta)
    with pytest.raises(ValueError, match="CUDA"):
        tops.matmul(ta, tb, impl="cuda")
