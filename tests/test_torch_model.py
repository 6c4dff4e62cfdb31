"""Paged decode datapath of the port against the JAX package on qwen2
smoke: ``decode_span_paged_fn`` (a span prefill) then ``decode_paged_fn``
(one decode step), logits and written pages, for f32, bf16 and int8 pools;
and the same on mixtral smoke (MoE FFN through the grouped dispatch,
sliding window 8, untied head) for f32 and int8 pools.

Tolerances: f32 at 1e-4, the JAX serve tests' tolerance; bf16 logits at
2e-2 and bf16 pages within one bf16 step (2^-8 absolute for values
below 1, 2^-7 relative above), since the two frameworks round
intermediate bf16 values at different places; int8 at
1e-4 with the int8 pages and their bf16 scales equal, except values that
sit on a rounding boundary may flip by one step (at most 1% of them)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models.blocks import ModelContext as JCtx
from repro.models.params import init_params as j_init_params
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models.blocks import ModelContext as TCtx
from repro_torch.models.params import params_from_numpy

jax.config.update("jax_default_matmul_precision", "highest")

N, P, B, M = 14, 8, 3, 4
POOLS = {
    # name: (jax compute, jax cache, torch compute, torch cache, logit tol)
    "f32": (jnp.float32, None, torch.float32, None, 1e-4),
    "bf16": (jnp.bfloat16, None, torch.bfloat16, None, 2e-2),
    "int8": (jnp.float32, jnp.int8, torch.float32, torch.int8, 1e-4),
}


def _model(arch):
    cfg = get_smoke(arch)
    jp = j_init_params(jax.random.key(0), japi.model_specs(cfg))
    return cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")


@pytest.fixture(scope="module")
def qwen():
    return _model("qwen2_0_5b")


@pytest.fixture(scope="module")
def mixtral():
    return _model("mixtral_8x22b")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _check_pages(jpages, tpages, pool):
    """The pools equal the reference's page for page, apart from the
    trash page 0: the port stores zeros there (the order of its duplicate
    writes is undefined on the card), where the reference keeps the
    garbage row that wrote last."""
    for sl, sub in jpages.items():
        for name, jarr in sub.items():
            want, got = _np(jarr), _np(tpages[sl][name])
            assert want.shape == got.shape
            if name in ("k", "v"):
                assert not got[:, 0].any(), (sl, name)
            want, got = want[:, 1:], got[:, 1:]  # (n_blocks, pages, ...)
            if pool == "f32":
                np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
            elif pool == "bf16":
                np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                           atol=2 ** -8)
            else:
                diff = got != want
                assert diff.mean() <= 0.01, (sl, name, diff.mean())
                if name in ("k", "v"):
                    assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("pool", list(POOLS))
def test_span_then_decode_matches_reference(qwen, pool):
    _span_then_decode(qwen, pool)


@pytest.mark.parametrize("pool", ["f32", "int8"])
def test_moe_span_then_decode_matches_reference(mixtral, pool):
    """Positions up to 23 against a window of 8: the window masks keys."""
    assert mixtral[0].sliding_window == 8
    assert "lm_head" in mixtral[2]
    _span_then_decode(mixtral, pool)


def _span_then_decode(model, pool):
    cfg, jp, tp = model
    jdt, jcache, tdt, tcache, tol = POOLS[pool]
    jctx = JCtx(compute_dtype=jdt, decode_cache_dtype=jcache)
    tctx = TCtx(compute_dtype=tdt, decode_cache_dtype=tcache, device="cpu")
    rng = np.random.default_rng(0)
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9]], np.int32)
    pos = np.array([0, 4, 17], np.int32)
    spec = japi.paged_state_spec(cfg, N, P, B, M, jctx)
    jstate = {"pages": jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                                    spec["pages"]),
              "page_table": jnp.asarray(table), "pos": jnp.asarray(pos)}
    tspec = tapi.paged_state_spec(cfg, N, P, B, M, tctx)
    tstate = {"pages": {sl: {n: torch.zeros(s.shape, dtype=s.dtype)
                             for n, s in sub.items()}
                        for sl, sub in tspec["pages"].items()},
              "page_table": torch.from_numpy(table),
              "pos": torch.from_numpy(pos)}
    # a 6-token span with a padded tail on row 1 (valid 4)
    toks = rng.integers(0, cfg.vocab_size, (B, 6)).astype(np.int32)
    valid = np.array([6, 4, 6], np.int32)
    jl, js = japi.decode_span_paged_fn(jp, jnp.asarray(toks), jstate, cfg,
                                       jctx, valid=jnp.asarray(valid))
    tl, ts = tapi.decode_span_paged_fn(tp, torch.from_numpy(toks), tstate,
                                       cfg, tctx,
                                       valid=torch.from_numpy(valid))
    assert tl.dtype == tdt and tuple(tl.shape) == jl.shape
    live = np.arange(6)[None] < valid[:, None]  # padded logits: garbage
    np.testing.assert_allclose(_np(tl)[live], _np(jl)[live], atol=tol,
                               rtol=tol)
    assert torch.equal(ts["pos"], tstate["pos"])  # caller owns pos
    # logits_at gathers one position before the lm head
    at = np.array([5, 3, 0], np.int32)
    tl1, _ = tapi.decode_span_paged_fn(tp, torch.from_numpy(toks), tstate,
                                       cfg, tctx,
                                       valid=torch.from_numpy(valid),
                                       logits_at=torch.from_numpy(at))
    np.testing.assert_allclose(_np(tl1)[:, 0], _np(tl)[np.arange(B), at],
                               atol=tol, rtol=tol)
    # one decode step at the next position of each row
    npos = pos + valid
    jstate = dict(js, pos=jnp.asarray(npos))
    tstate = dict(ts, pos=torch.from_numpy(npos))
    tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    jl, js = japi.decode_paged_fn(jp, jnp.asarray(tok), jstate, cfg, jctx)
    tl, ts = tapi.decode_paged_fn(tp, torch.from_numpy(tok), tstate, cfg,
                                  tctx)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=tol, rtol=tol)
    np.testing.assert_array_equal(ts["pos"].numpy(), np.asarray(js["pos"]))
    _check_pages(js["pages"], ts["pages"], pool)


@pytest.mark.parametrize("window", [None, 3])
def test_gather_attention_matches_reference(qwen, window):
    """The gather path (attn_impl="ref") attends like the reference's."""
    cfg = qwen[0]
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 6, 8)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    pos = np.array([3, 12], np.int32)
    t = lambda x: torch.from_numpy(x)
    j = lambda x: jnp.asarray(x)
    got = tattn.decode_span_attention(t(q), t(k), t(v), t(pos), cfg,
                                      window=window)
    want = jattn.decode_span_attention(j(q), j(k), j(v), j(pos), cfg,
                                       window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    got = tattn.decode_attention(t(q[:, :1]), t(k), t(v), t(pos + 20), cfg,
                                 window=window)  # ring-wrapped slots
    want = jattn.decode_attention(j(q[:, :1]), j(k), j(v), j(pos + 20), cfg,
                                  window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
