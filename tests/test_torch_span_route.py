"""The span route of the port, CPU side: which CUDA source a span call on the
card launches, and the plain span version (what the span kernel of
``csrc/paged_span_attention.cu`` is held to on the card) against the JAX
package's oracle and its Pallas kernel in interpret mode at the kernel's
shape families: head dim 112, page size 8, GQA groups 6 and 7 with spans
that leave a ragged last tile, a window that straddles the span, and int8
pages under bf16 queries.

Tolerance 2e-2, as tests/test_torch_kernels.py holds bf16: the gather
oracle rounds the gathered view to bf16 while the Pallas body dequantizes
in f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jdec
from repro.kernels import ops as jops
from repro.models.blocks import paged_quantize as j_paged_quantize
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import ops as tops

TOL = 2e-2


@pytest.mark.parametrize("q_dtype,page_dtype,d,source", [
    (torch.bfloat16, torch.bfloat16, 128, tdec.SPAN_SOURCE),
    (torch.bfloat16, torch.int8, 128, tdec.SPAN_SOURCE),
    (torch.bfloat16, torch.bfloat16, 64, tdec.SPAN_SOURCE),
    (torch.bfloat16, torch.int8, 112, tdec.SPAN_SOURCE),
    (torch.bfloat16, torch.bfloat16, 256, tdec.SPAN_SOURCE),
    (torch.float32, torch.float32, 128, tdec.SOURCE),
    (torch.float32, torch.bfloat16, 128, tdec.SOURCE),
    (torch.float32, torch.int8, 64, tdec.SOURCE),
    (torch.bfloat16, torch.float32, 128, tdec.SOURCE),
    (torch.bfloat16, torch.bfloat16, 8, tdec.SOURCE),
    (torch.bfloat16, torch.int8, 16, tdec.SPAN_SOURCE),
    (torch.bfloat16, torch.bfloat16, 16, tdec.SPAN_SOURCE),
    (torch.bfloat16, torch.bfloat16, 96, tdec.SOURCE),
])
def test_span_source_is_fixed_by_dtypes_and_head_dim(q_dtype, page_dtype,
                                                      d, source):
    assert tdec.span_source(q_dtype, page_dtype, d) == source


def test_span_kernel_is_built_with_the_others():
    assert tdec.SPAN_SOURCE in build.SOURCES
    assert (build.CSRC / tdec.SPAN_SOURCE).is_file()
    # paged decode (T = 1) and the f32 span keep their own source
    assert tdec.SOURCE in build.SOURCES


def _case(b, t, groups, kv, d, p, m, pages, pos, seed):
    """Numpy inputs for both sides, bf16 queries; int8 scales come from
    JAX's own ``paged_quantize``."""
    rng = np.random.default_rng(seed)
    h = groups * kv
    n = 1 + b * m
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((n, p, kv, d)).astype(np.float32)
    v = rng.standard_normal((n, p, kv, d)).astype(np.float32)
    table = (1 + rng.permutation(n - 1)[:b * m]).reshape(b, m)
    table[0, -1] = 0  # a padded entry: the trash page
    table = table.astype(np.int32)
    jq = jnp.asarray(q, jnp.bfloat16)
    if pages == "int8":
        jk, jks = j_paged_quantize(jnp.asarray(k), jnp.int8)
        jv, jvs = j_paged_quantize(jnp.asarray(v), jnp.int8)
    else:
        jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
        jks = jvs = None
    jside = (jq, jk, jv, jnp.asarray(table),
             jnp.asarray(np.asarray(pos, np.int32)), jks, jvs)

    def to_torch(x):
        if x is None:
            return None
        if x.dtype == jnp.bfloat16:
            return torch.from_numpy(np.asarray(x, np.float32)).to(
                torch.bfloat16)
        return torch.from_numpy(np.array(x))

    return jside, tuple(to_torch(x) for x in jside)


# (B, T, groups, KV, D, P, M, pages, window, pos): groups 6 and 7 with T
# not a multiple of the tokens a 64-row tile holds (10 and 9); the span at
# pos 30 .. 40 against a window of 20 straddles the window's edge
SHAPES = [
    (2, 11, 6, 2, 112, 8, 8, "bf16", None, (0, 50)),
    (2, 10, 7, 2, 112, 8, 8, "bf16", 20, (30, 53)),
    (2, 11, 6, 2, 64, 8, 8, "int8", 20, (30, 7)),
    (1, 19, 7, 1, 112, 8, 6, "int8", None, (27,)),
    (2, 22, 3, 2, 128, 8, 6, "bf16", 33, (20, 26)),
]


@pytest.mark.parametrize("b,t,groups,kv,d,p,m,pages,window,pos", SHAPES)
def test_plain_span_matches_jax_at_the_kernel_shapes(b, t, groups, kv, d, p,
                                                     m, pages, window, pos):
    (jq, jk, jv, jtab, jpos, jks, jvs), (q, k, v, tab, tpos, ks, vs) = \
        _case(b, t, groups, kv, d, p, m, pages, pos, seed=d + t)
    want_ref = jops.paged_decode_span_attention(
        jq, jk, jv, jtab, jpos, k_scale=jks, v_scale=jvs, impl="ref",
        window=window)
    want_pl = jdec.paged_decode_span_attention(
        jq, jk, jv, jtab, jpos, k_scale=jks, v_scale=jvs, window=window,
        interpret=True)
    before = dict(tdec.span_launches)
    got = tdec.paged_decode_span_attention(q, k, v, tab, tpos, k_scale=ks,
                                           v_scale=vs, window=window)
    # CPU tensors take the plain version: no kernel, no count
    assert tdec.span_launches == before
    got_ops = tops.paged_decode_span_attention(
        q, k, v, tab, tpos, k_scale=ks, v_scale=vs, impl="ref",
        window=window)
    assert got.dtype == torch.bfloat16 and got.shape == tuple(want_ref.shape)
    g = got.float().numpy()
    np.testing.assert_allclose(g, np.asarray(want_ref, np.float32),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(g, np.asarray(want_pl, np.float32), atol=TOL,
                               rtol=TOL)
    np.testing.assert_array_equal(got_ops.float().numpy(), g)


def test_reset_launches_clears_the_span_counts():
    tdec.span_launches[tdec.SPAN_SOURCE] += 3
    tdec.launches["paged_decode_span_attention"] += 3
    tdec.reset_launches()
    assert set(tdec.span_launches.values()) == {0}
    assert tdec.launches["paged_decode_span_attention"] == 0
