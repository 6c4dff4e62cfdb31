"""M-RoPE serving (Qwen2-VL) of the port against the JAX package.

* ``apply_mrope`` and ``layer_norm`` against JAX's on the same inputs
  (rtol 1e-6: the same fp32 operations); text-only rows (no explicit
  positions) reduce M-RoPE to RoPE.
* ``prefill_fn`` with explicit (3,B,S) rows, then the dense and paged
  span paths with explicit rows, against JAX (logits rtol 2e-5, caches
  1e-5), on qwen2-vl smoke with JAX-initialised params.
* ``ServeEngine`` on the paged and the dense backend against the JAX
  engine: half the requests carry vision-style explicit rows (a patch
  grid, then text from max + 1), half are text; greedy tokens, scheduler
  stats, every counter and the KV counters equal. Explicit-position
  requests neither publish nor adopt prefix pages: the text half shares a
  prefix and hits, the explicit half (the same tokens) never does.
* ``generate`` and ``generate_pertoken`` with a ``positions`` batch key.
* The training loss with explicit rows (loss rtol 2e-5).

fp32 with ``jax_default_matmul_precision="highest"``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as j_get_smoke
from repro.models import api as japi
from repro.models import ops as jops
from repro.models.attention import apply_positional as j_apply_positional
from repro.models.blocks import ModelContext as JCtx
from repro.models.params import init_params as j_init_params
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import Request as JRequest
from repro_torch.models import api as tapi
from repro_torch.models import ops as tops
from repro_torch.models.attention import apply_positional
from repro_torch.models.blocks import ModelContext as TCtx
from repro_torch.models.blocks import init_cache
from repro_torch.models.params import params_from_numpy
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.scheduler import Request as TRequest

jax.config.update("jax_default_matmul_precision", "highest")

COUNTERS = ("prefills", "chunks", "decode_steps", "host_syncs",
            "pertoken_steps", "pages_trimmed", "suffix_prefills",
            "prompt_tokens", "cached_prompt_tokens", "spec_steps",
            "spec_tokens", "prefill_span_calls", "span_prefill_compiles",
            "span_prefill_dense_compiles")


@pytest.fixture(scope="module")
def vl():
    cfg = j_get_smoke("qwen2_vl_7b")
    jp = j_init_params(jax.random.key(0), japi.model_specs(cfg))
    return cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")


def _ctxs():
    return (JCtx(compute_dtype=jnp.float32),
            TCtx(compute_dtype=torch.float32, device="cpu"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def vl_positions(s, prefix=3, grid=2, b=1):
    """Qwen2-VL-shaped (3, B, S) rows: ``prefix`` text tokens, a
    grid x grid merged image (t fixed, h and w in raster order), then text
    from max + 1."""
    rows = [[i] * 3 for i in range(prefix)]
    for hh in range(grid):
        for ww in range(grid):
            rows.append([prefix, prefix + hh, prefix + ww])
    nxt = max(max(r) for r in rows) + 1
    while len(rows) < s:
        rows.append([nxt] * 3)
        nxt += 1
    pos = np.asarray(rows[:s], np.int32).T  # (3, S)
    return np.broadcast_to(pos[:, None, :], (3, b, s)).copy()


# ------------------------------------------------------------------ ops


def test_apply_mrope_and_layer_norm_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 50, (3, 2, 9)).astype(np.int32)
    want = np.asarray(jops.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                       1e4, (4, 2, 2)))
    got = tops.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e4,
                           (4, 2, 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="sections"):
        tops.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e4,
                         (4, 2, 1))
    h = rng.standard_normal((2, 5, 24)).astype(np.float32) * 3 + 1
    sc = rng.standard_normal(24).astype(np.float32)
    bi = rng.standard_normal(24).astype(np.float32)
    for eps in (1e-6, 1e-5):
        want = np.asarray(jops.layer_norm(jnp.asarray(h), jnp.asarray(sc),
                                          jnp.asarray(bi), eps))
        got = tops.layer_norm(torch.from_numpy(h), torch.from_numpy(sc),
                              torch.from_numpy(bi), eps)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    bf = tops.layer_norm(torch.from_numpy(h).bfloat16(),
                         torch.from_numpy(sc), torch.from_numpy(bi))
    assert bf.dtype == torch.bfloat16


def test_text_rows_reduce_mrope_to_rope(vl):
    cfg = vl[0]
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, 16)).astype(np.float32)
    posn = np.broadcast_to(np.arange(3, 10, dtype=np.int32), (2, 7)).copy()
    mp = vl_positions(7, b=2)
    for explicit in (None, mp):
        jq, jk = j_apply_positional(
            jnp.asarray(q), jnp.asarray(k), cfg, jnp.asarray(posn),
            None if explicit is None else jnp.asarray(explicit))
        tq, tk = apply_positional(
            torch.from_numpy(q), torch.from_numpy(k), cfg,
            torch.from_numpy(posn),
            None if explicit is None else torch.from_numpy(explicit))
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6,
                                   atol=1e-6)
    text = tops.apply_mrope(torch.from_numpy(q), torch.from_numpy(
        np.broadcast_to(posn, (3, 2, 7)).copy()), cfg.rope_theta,
        cfg.mrope_sections)
    rope = tops.apply_rope(torch.from_numpy(q), torch.from_numpy(posn),
                           cfg.rope_theta)
    np.testing.assert_allclose(text.numpy(), rope.numpy(), rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------------- model functions


def test_prefill_and_span_paths_with_explicit_rows_match_jax(vl):
    cfg, jp, tp = vl
    jctx, tctx = _ctxs()
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    mp = vl_positions(11, b=2)
    jlog, jcache = japi.prefill_fn(
        jp, {"tokens": jnp.asarray(tokens), "positions": jnp.asarray(mp)},
        cfg, jctx, window=24)
    tlog, tcache = tapi.prefill_fn(
        tp, {"tokens": torch.from_numpy(tokens),
             "positions": torch.from_numpy(mp)}, cfg, tctx, window=24)
    np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=2e-5, atol=2e-5)
    for sl, sub in jcache["blocks"].items():
        for name, arr in sub.items():
            np.testing.assert_allclose(_np(tcache["blocks"][sl][name]),
                                       _np(arr), rtol=1e-5, atol=1e-5)
    # without the rows the logits differ: the rows reach attention
    plain, _ = tapi.prefill_fn(tp, {"tokens": torch.from_numpy(tokens)},
                               cfg, tctx, window=24)
    assert np.abs(_np(plain) - _np(tlog)).max() > 1e-6

    # dense span decode: two 8-token spans, the second at explicit rows
    jc = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                      japi.cache_spec(cfg, 2, 24, jctx))
    tc = {"blocks": init_cache(tapi.cache_spec(cfg, 2, 24, tctx)["blocks"],
                               torch.device("cpu"))}
    full = vl_positions(16, b=2)
    for i in range(2):
        span = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
        rows = full[:, :, 8 * i:8 * i + 8].copy()
        pos = np.full((2,), 8 * i, np.int32)
        jc = dict(jc, pos=jnp.asarray(pos))
        tc = dict(tc, pos=torch.from_numpy(pos))
        jl, jc = japi.decode_span_fn(jp, jnp.asarray(span), jc, cfg, jctx,
                                     mrope_positions=jnp.asarray(rows))
        tl, tc = tapi.decode_span_fn(tp, torch.from_numpy(span), tc, cfg,
                                     tctx,
                                     mrope_positions=torch.from_numpy(rows))
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=2e-5, atol=2e-5,
                                   err_msg=f"dense span {i}")


def test_paged_span_with_explicit_rows_matches_jax(vl):
    cfg, jp, tp = vl
    jctx, tctx = _ctxs()
    rng = np.random.default_rng(3)
    npages, psize, m = 9, 4, 4
    jst = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                       japi.paged_state_spec(cfg, npages, psize, 2, m, jctx))
    tspec = tapi.paged_state_spec(cfg, npages, psize, 2, m, tctx)
    tst = {"pages": init_cache(tspec["pages"], torch.device("cpu"))}
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    rows = vl_positions(10, b=2)
    valid = np.asarray([10, 7], np.int32)
    pos = np.zeros((2,), np.int32)
    jst = dict(jst, page_table=jnp.asarray(table), pos=jnp.asarray(pos))
    tst = dict(tst, page_table=torch.from_numpy(table),
               pos=torch.from_numpy(pos))
    jl, _ = japi.decode_span_paged_fn(jp, jnp.asarray(tokens), jst, cfg,
                                      jctx, valid=jnp.asarray(valid),
                                      mrope_positions=jnp.asarray(rows))
    tl, _ = tapi.decode_span_paged_fn(tp, torch.from_numpy(tokens), tst,
                                      cfg, tctx,
                                      valid=torch.from_numpy(valid),
                                      mrope_positions=torch.from_numpy(rows))
    for b, n in enumerate(valid):  # padded tail slots are garbage
        np.testing.assert_allclose(_np(tl)[b, :n], _np(jl)[b, :n],
                                   rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------- engine


def _requests(cfg, cls, seed):
    """Six requests: the text half shares a 12-token prefix (prefix-cache
    hits), the explicit half repeats the same prompts with vision rows."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, 12)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size,
                                                    int(n))])
               for n in (3, 7, 5)]
    reqs = []
    for i, p in enumerate(prompts + prompts):
        r = cls(rid=i, prompt=p, max_new=7)
        if i >= 3:
            r.extras["positions"] = vl_positions(len(p), prefix=2, grid=3)
        reqs.append(r)
    return reqs


@pytest.mark.parametrize("paged", [True, False])
def test_engine_with_explicit_positions_matches_jax(vl, paged):
    cfg, jp, tp = vl
    jctx, tctx = _ctxs()
    kw = dict(window=40, max_batch=2, chunk=3, page_size=4, paged=paged,
              prefill_chunk=8)
    je, te = JEngine(cfg, jctx, **kw), TEngine(cfg, tctx, **kw)
    assert te.chunk_prefill == je.chunk_prefill == (not paged)
    jout = je.run(jp, _requests(cfg, JRequest, 4))
    tout = te.run(tp, _requests(cfg, TRequest, 4))
    assert sorted(tout) == sorted(jout) == list(range(6))
    for rid in jout:
        np.testing.assert_array_equal(tout[rid], jout[rid],
                                      err_msg=f"rid {rid}")
    assert te.scheduler.stats == je.scheduler.stats
    for name in COUNTERS:
        assert te.counters[name] == je.counters[name], name
    if paged:
        assert te.kv.counters == je.kv.counters
        # lookups and hits come from the text half only
        assert te.kv.counters["prefix_lookups"] == 3
        assert te.kv.counters["prefix_hit_tokens"] > 0
        assert te.counters["cached_prompt_tokens"] == \
            te.kv.counters["prefix_hit_tokens"]


def test_explicit_position_requests_bypass_the_prefix_cache(vl):
    cfg, jp, tp = vl
    jctx, tctx = _ctxs()
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (1, 12)).astype(np.int32)
    batch = {"tokens": toks, "positions": vl_positions(12)}
    text = {"tokens": toks,
            "positions": np.broadcast_to(np.arange(12, dtype=np.int32),
                                         (3, 1, 12)).copy()}
    kw = dict(window=32, max_batch=1, chunk=4, page_size=4)
    je, te = JEngine(cfg, jctx, **kw), TEngine(cfg, tctx, **kw)
    for b in (batch, text):
        want = np.asarray(je.generate(jp, {k: jnp.asarray(v)
                                           for k, v in b.items()},
                                      max_new=6))
        got = te.generate(tp, b, max_new=6)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            te.generate_pertoken(tp, b, max_new=6).numpy(), want)
    assert te.kv.counters["prefix_hit_tokens"] == 0
    assert te.kv.counters["pages_published"] == 0
    assert te.kv.counters == je.kv.counters


def test_generate_with_positions_on_two_rows_matches_jax(vl):
    cfg, jp, tp = vl
    jctx, tctx = _ctxs()
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    batch = {"tokens": toks, "positions": vl_positions(10, b=2)}
    for paged in (True, False):
        kw = dict(window=24, max_batch=2, chunk=4, paged=paged,
                  prefill_chunk=4)
        je, te = JEngine(cfg, jctx, **kw), TEngine(cfg, tctx, **kw)
        want = np.asarray(je.generate_pertoken(
            jp, {k: jnp.asarray(v) for k, v in batch.items()}, max_new=5))
        np.testing.assert_array_equal(
            te.generate(tp, batch, max_new=5).numpy(), want)
        np.testing.assert_array_equal(
            te.generate_pertoken(tp, batch, max_new=5).numpy(), want)


def test_training_with_position_rows_matches_jax(vl):
    """The training loss honours explicit (3,B,S) rows as the reference's
    does (gradients: tests/test_torch_encdec_train.py)."""
    cfg, jp, tp = vl
    jctx, tctx = _ctxs()
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 13)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "positions": vl_positions(12, b=2)}
    jl, jm = japi.loss_fn(jp, {k: jnp.asarray(v)
                               for k, v in batch.items()}, cfg, jctx)
    tl, tm = tapi.loss_fn(tp, {k: torch.from_numpy(v)
                               for k, v in batch.items()}, cfg, tctx)
    assert set(tm) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=2e-5, atol=1e-7, err_msg=key)
