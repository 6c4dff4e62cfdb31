"""Serving the state families (rwkv6: attention-free; Jamba: Mamba +
attention + MoE) on the port's dense backend, against the JAX package.

* ``ServeEngine`` with the backend left to the family (dense: no paged
  KV for recurrent state) against the JAX engine on rwkv6 smoke (the
  front-padded power-of-two bucketed prefill) and jamba smoke (the chunked
  dense-span prefill, its recurrent state threaded through the spans):
  greedy tokens, scheduler stats, every counter and
  ``prefill_bucket_sizes`` equal.
* ``generate`` against ``generate_pertoken``, and bucketed prompts against
  their per-token runs (the JAX serve tests' state-family checks).
* ``prefill_fn`` with ``pad_left`` (logits and every cache leaf), decode
  steps, and span decodes from a negative position against JAX.
* The serve launcher on both archs at smoke size.

Logits within 1e-4, as the JAX serve tests; cache leaves within 1e-5 of
the larger of 1 and the leaf's largest |value| (fp32 rounding of the
same sums in another order). fp32 with
``jax_default_matmul_precision="highest"``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as j_get_smoke
from repro.models import api as japi
from repro.models.blocks import ModelContext as JCtx
from repro.models.params import init_params as j_init_params
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import Request as JRequest
from repro_torch.launch import serve as launch_serve
from repro_torch.models import api as tapi
from repro_torch.models.blocks import ModelContext as TCtx
from repro_torch.models.blocks import init_cache
from repro_torch.models.params import params_from_numpy
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.scheduler import Request as TRequest

jax.config.update("jax_default_matmul_precision", "highest")

ARCHS = ("rwkv6_1_6b", "jamba_v01_52b")
COUNTERS = ("prefills", "chunks", "decode_steps", "host_syncs",
            "pertoken_steps", "pages_trimmed", "suffix_prefills",
            "prompt_tokens", "cached_prompt_tokens", "spec_steps",
            "spec_tokens", "prefill_span_calls", "span_prefill_compiles",
            "span_prefill_dense_compiles")
# the JAX serve tests' context
CHUNKS = dict(q_chunk=64, mamba_chunk=8, rwkv_chunk=4)

_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        cfg = j_get_smoke(arch)
        jp = j_init_params(jax.random.key(0), japi.model_specs(cfg))
        _MODELS[arch] = (cfg, jp, params_from_numpy(
            jax.tree.map(np.asarray, jp), device="cpu"))
    return _MODELS[arch]


def _ctxs():
    return (JCtx(compute_dtype=jnp.float32, **CHUNKS),
            TCtx(compute_dtype=torch.float32, device="cpu", **CHUNKS))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _check_caches(jcache, tcache):
    for sl, sub in jcache["blocks"].items():
        assert sorted(sub) == sorted(tcache["blocks"][sl]), sl
        for name, jarr in sub.items():
            want, got = _np(jarr), _np(tcache["blocks"][sl][name])
            assert want.shape == got.shape, (sl, name)
            assert tcache["blocks"][sl][name].dtype == \
                getattr(torch, str(jarr.dtype)), (sl, name)
            err = float(np.abs(got - want).max()) if want.size else 0.0
            assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), \
                (sl, name, err)


# --------------------------------------------------------------------- engine

ENGINE_CASES = {
    # arch, engine kwargs, prompt lengths
    "rwkv6_bucketed": ("rwkv6_1_6b",
                       dict(window=40, max_batch=2, chunk=4),
                       (9, 5, 13, 21, 16, 3)),
    "jamba_chunked_span": ("jamba_v01_52b",
                           dict(window=40, max_batch=3, chunk=4,
                                prefill_chunk=8),
                           (9, 5, 13, 21, 16, 3)),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_state_engine_matches_jax(case):
    arch, kw, lens = ENGINE_CASES[case]
    cfg, jp, tp = _model(arch)
    jctx, tctx = _ctxs()
    je = JEngine(cfg, jctx, **kw)
    te = TEngine(cfg, tctx, **kw)
    assert not te.paged and not je.paged
    assert (te.chunk_prefill, te.bucket_prefill) == \
        (je.chunk_prefill, je.bucket_prefill)
    assert te.bucket_prefill == (arch == "rwkv6_1_6b")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    jout = je.run(jp, [JRequest(rid=i, prompt=p, max_new=9, arrival=i)
                       for i, p in enumerate(prompts)])
    tout = te.run(tp, [TRequest(rid=i, prompt=p, max_new=9, arrival=i)
                       for i, p in enumerate(prompts)])
    assert sorted(jout) == sorted(tout) == list(range(len(lens)))
    for rid in jout:
        np.testing.assert_array_equal(tout[rid], jout[rid],
                                      err_msg=f"rid {rid}")
    assert te.scheduler.stats == je.scheduler.stats
    assert te.prefill_bucket_sizes == je.prefill_bucket_sizes
    if te.bucket_prefill:
        assert te.prefill_bucket_sizes == {8, 16, 32}
    else:
        assert te.counters["span_prefill_dense_compiles"] > 0

    batch = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    want = np.asarray(je.generate_pertoken(
        jp, {"tokens": jnp.asarray(batch)}, max_new=7))
    got = te.generate_pertoken(tp, {"tokens": batch}, max_new=7)
    np.testing.assert_array_equal(got.numpy(), want)
    for name in COUNTERS:
        assert te.counters[name] == je.counters[name], name


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_pertoken_loop(arch):
    """The JAX serve test of the dense families: generate() rides the
    engine and equals the per-token loop."""
    cfg, _, tp = _model(arch)
    eng = TEngine(cfg, _ctxs()[1], window=32, max_batch=2, chunk=4)
    assert not eng.paged
    batch = {"tokens": np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 7)).astype(np.int32)}
    ref = eng.generate_pertoken(tp, batch, max_new=6)
    out = eng.generate(tp, batch, max_new=6)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


def test_bucketed_prompts_share_a_bucket_and_match_pertoken():
    """The JAX serve test of prefill bucketing: prompts of 9-15 tokens
    share the 16-token bucket and equal their per-token runs (prime
    lengths prefill with a WKV chunk of 1 there)."""
    cfg, _, tp = _model("rwkv6_1_6b")
    eng = TEngine(cfg, _ctxs()[1], window=32, max_batch=2, chunk=4)
    assert eng.bucket_prefill
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (9, 11, 13, 15)]
    out = eng.run(tp, [TRequest(rid=i, prompt=p, max_new=6)
                       for i, p in enumerate(prompts)])
    assert eng.prefill_bucket_sizes == {16}
    for i, p in enumerate(prompts):
        ref = eng.generate_pertoken(tp, {"tokens": p[None, :]}, max_new=6)
        np.testing.assert_array_equal(out[i], ref.numpy()[0])


# ------------------------------------------------------------ model functions


def test_pad_left_prefill_and_decode_match_jax():
    """rwkv6: rows front-padded by 5 and 0 positions, then 4 decode
    steps; the padded row's logits and state equal its unpadded run."""
    cfg, jp, tp = _model("rwkv6_1_6b")
    jctx, tctx = _ctxs()
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    pad = np.asarray([5, 0], np.int32)
    tokens[0, :5] = 0
    jlog, jcache = japi.prefill_fn(jp, {"tokens": jnp.asarray(tokens)}, cfg,
                                   jctx, window=32, pad_left=jnp.asarray(pad))
    tlog, tcache = tapi.prefill_fn(tp, {"tokens": torch.from_numpy(tokens)},
                                   cfg, tctx, window=32,
                                   pad_left=torch.from_numpy(pad))
    np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    _check_caches(jcache, tcache)
    solo_log, solo = tapi.prefill_fn(
        tp, {"tokens": torch.from_numpy(tokens[:1, 5:])}, cfg, tctx,
        window=32)
    np.testing.assert_allclose(_np(tlog[:1]), _np(solo_log), rtol=1e-5,
                               atol=1e-5)
    wkv = tcache["blocks"]["sl0"]["wkv"][:, :1]
    np.testing.assert_allclose(_np(wkv), _np(solo["blocks"]["sl0"]["wkv"]),
                               rtol=1e-5, atol=1e-5)
    for step in range(4):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jlog, jcache = japi.decode_fn(jp, jnp.asarray(tok), jcache, cfg,
                                      jctx)
        tlog, tcache = tapi.decode_fn(tp, torch.from_numpy(tok), tcache,
                                      cfg, tctx)
        np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {step}")
    _check_caches(jcache, tcache)


def test_pad_left_refused_on_attention_sublayers():
    cfg, _, tp = _model("jamba_v01_52b")
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="front padding"):
        tapi.prefill_fn(tp, {"tokens": tokens}, cfg, _ctxs()[1], window=16,
                        pad_left=torch.tensor([2], dtype=torch.int32))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_span_match_jax(arch):
    """A full prefill with ``logits_at`` and decode steps; then two
    8-token span decodes into fresh caches, row 0 from position -3 (three
    dead front-pad positions), row 1 from 0."""
    cfg, jp, tp = _model(arch)
    jctx, tctx = _ctxs()
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    at = np.asarray([12, 9], np.int32)
    jlog, jcache = japi.prefill_fn(jp, {"tokens": jnp.asarray(tokens)}, cfg,
                                   jctx, window=24,
                                   logits_at=jnp.asarray(at))
    tlog, tcache = tapi.prefill_fn(tp, {"tokens": torch.from_numpy(tokens)},
                                   cfg, tctx, window=24,
                                   logits_at=torch.from_numpy(at))
    np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=1e-4, atol=1e-4)
    _check_caches(jcache, tcache)
    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jlog, jcache = japi.decode_fn(jp, jnp.asarray(tok), jcache, cfg,
                                      jctx)
        tlog, tcache = tapi.decode_fn(tp, torch.from_numpy(tok), tcache,
                                      cfg, tctx)
        np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {step}")
    _check_caches(jcache, tcache)

    jspan = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                         japi.cache_spec(cfg, 2, 24, jctx))
    tspan = {"blocks": init_cache(tapi.cache_spec(cfg, 2, 24, tctx)
                                  ["blocks"], torch.device("cpu"))}
    pos = np.asarray([-3, 0], np.int32)
    for chunk in range(2):
        toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
        at = np.asarray([7, 6 - chunk], np.int32)
        jspan = dict(jspan, pos=jnp.asarray(pos + 8 * chunk))
        tspan = dict(tspan, pos=torch.from_numpy(pos + 8 * chunk))
        jlog, jspan = japi.decode_span_fn(jp, jnp.asarray(toks), jspan, cfg,
                                          jctx, logits_at=jnp.asarray(at))
        tlog, tspan = tapi.decode_span_fn(tp, torch.from_numpy(toks), tspan,
                                          cfg, tctx,
                                          logits_at=torch.from_numpy(at))
        np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=1e-4,
                                   atol=1e-4, err_msg=f"span {chunk}")
    _check_caches(jspan, tspan)


# ------------------------------------------------------------------ launcher


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_smoke(arch, capsys):
    launch_serve.main(["--arch", arch, "--smoke", "--trace", "4",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[dense on cpu] 4 requests" in out
    assert "'completions': 4" in out
    assert ("prefill_bucket_sizes=" in out) == (arch == "rwkv6_1_6b")

