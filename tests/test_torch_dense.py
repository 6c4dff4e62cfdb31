"""Serving on the dense KV backend: the port against the JAX package.

* Model functions on qwen2 smoke and mixtral smoke (MoE through the
  grouped dispatch; sliding window 8, so a serve window past 8 makes the
  cache a ring that wraps): ``prefill_fn`` (with and without
  ``logits_at``) then decode steps through ``decode_fn``, and two chunks of
  ``decode_span_fn`` whose first row starts at a negative position (dead
  front padding). Logits within 1e-4, the JAX serve tests' tolerance; the
  caches within 1e-5 (fp32 rounding of the same projections).
* ``ServeEngine(paged=False)`` against the JAX engine on the same requests:
  qwen2 smoke on the chunked dense-span prefill, mixtral smoke on the
  full-prompt prefill into a ring, and phi4-mini smoke (GQA group 2):
  greedy tokens, scheduler stats and every counter equal.
  ``generate_pertoken`` tokens equal the JAX engine's and the port's own
  ``generate`` tokens. Under the chaos fault plan (on the dense backend
  only its stragglers fire: page flips target the paged pool) and TTFT
  shedding, tokens, ``fault_stats`` and the shed ids equal too.
* The three dense configs the port copied (internlm2, phi4-mini,
  qwen2.5-3b): full and smoke configs equal the reference's, and the smoke
  loss equals the JAX loss on the same params and batch (rtol 2e-5, as
  test_torch_train.py holds it).

fp32 with ``jax_default_matmul_precision="highest"``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.configs.registry import get_smoke as j_get_smoke
from repro.models import api as japi
from repro.models.blocks import ModelContext as JCtx
from repro.models.params import init_params as j_init_params
from repro.serve import admission as jadm
from repro.serve import faults as jfaults
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs import registry
from repro_torch.models import api as tapi
from repro_torch.models.blocks import ModelContext as TCtx
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import admission as tadm
from repro_torch.serve import faults as tfaults
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.scheduler import Request as TRequest

jax.config.update("jax_default_matmul_precision", "highest")

COUNTERS = ("prefills", "chunks", "decode_steps", "host_syncs",
            "pertoken_steps", "pages_trimmed", "suffix_prefills",
            "prompt_tokens", "cached_prompt_tokens", "spec_steps",
            "spec_tokens", "prefill_span_calls", "span_prefill_compiles",
            "span_prefill_dense_compiles")
NEW_CONFIGS = ("internlm2_1_8b", "phi4_mini_3_8b", "qwen2_5_3b")

_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        cfg = j_get_smoke(arch)
        jp = j_init_params(jax.random.key(0), japi.model_specs(cfg))
        _MODELS[arch] = (cfg, jp, params_from_numpy(
            jax.tree.map(np.asarray, jp), device="cpu"))
    return _MODELS[arch]


def _ctxs(**kw):
    return (JCtx(compute_dtype=jnp.float32, **kw),
            TCtx(compute_dtype=torch.float32, device="cpu", **kw))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _check_caches(jcache, tcache):
    for sl, sub in jcache["blocks"].items():
        for name, jarr in sub.items():
            want, got = _np(jarr), _np(tcache["blocks"][sl][name])
            assert want.shape == got.shape, (sl, name)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{sl}/{name}")


# ------------------------------------------------------------ model functions


@pytest.mark.parametrize("logits_at", [False, True])
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "mixtral_8x22b"])
def test_prefill_then_decode_matches_jax(arch, logits_at):
    """13-token prompts into a 20-slot window: mixtral's cache is an
    8-slot ring the prefill rolls into, and 6 decode steps wrap it again.
    With ``logits_at`` the rows stop at different positions."""
    cfg, jp, tp = _model(arch)
    jctx, tctx = _ctxs()
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    at = np.asarray([12, 9], np.int32) if logits_at else None
    jlog, jcache = japi.prefill_fn(
        jp, {"tokens": jnp.asarray(tokens)}, cfg, jctx, window=20,
        logits_at=None if at is None else jnp.asarray(at))
    tlog, tcache = tapi.prefill_fn(
        tp, {"tokens": torch.from_numpy(tokens)}, cfg, tctx, window=20,
        logits_at=None if at is None else torch.from_numpy(at))
    w = 8 if arch == "mixtral_8x22b" else 20
    assert tcache["blocks"]["sl0"]["k"].shape[2] == w
    np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    _check_caches(jcache, tcache)
    for step in range(6):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jlog, jcache = japi.decode_fn(jp, jnp.asarray(tok), jcache, cfg,
                                      jctx)
        tlog, tcache = tapi.decode_fn(tp, torch.from_numpy(tok), tcache,
                                      cfg, tctx)
        np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {step}")
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    _check_caches(jcache, tcache)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "mixtral_8x22b"])
def test_decode_span_matches_jax(arch):
    """Two 8-token spans against absolute-slot caches; row 0 starts at
    position -3 (three dead front-pad positions), row 1 at 2. Mixtral
    keeps absolute slots through ``full_cache_window``."""
    cfg, jp, tp = _model(arch)
    full = arch == "mixtral_8x22b"
    jctx, tctx = _ctxs(full_cache_window=full)
    rng = np.random.default_rng(6)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          japi.cache_spec(cfg, 2, 24, jctx))
    tspec = tapi.cache_spec(cfg, 2, 24, tctx)
    assert tspec["blocks"]["sl0"]["k"].shape[2] == 24
    tcache = {"blocks": {sl: {n: torch.zeros(s.shape, dtype=s.dtype)
                              for n, s in sub.items()}
                         for sl, sub in tspec["blocks"].items()}}
    pos = np.asarray([-3, 2], np.int32)
    for chunk in range(2):
        tokens = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
        at = np.asarray([7, 5 - chunk], np.int32)
        jcache = dict(jcache, pos=jnp.asarray(pos + 8 * chunk))
        tcache = dict(tcache, pos=torch.from_numpy(pos + 8 * chunk))
        jlog, jcache = japi.decode_span_fn(jp, jnp.asarray(tokens), jcache,
                                           cfg, jctx,
                                           logits_at=jnp.asarray(at))
        tlog, tcache = tapi.decode_span_fn(tp, torch.from_numpy(tokens),
                                           tcache, cfg, tctx,
                                           logits_at=torch.from_numpy(at))
        assert tlog.shape == (2, 1, cfg.vocab_size)
        np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=1e-4,
                                   atol=1e-4, err_msg=f"chunk {chunk}")
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      pos + 8 * chunk)
    _check_caches(jcache, tcache)
    # row 0 wrote its 13 live positions and nothing past them
    assert not tcache["blocks"]["sl0"]["k"][:, 0, 13:].any()


# --------------------------------------------------------------------- engine

ENGINE_CASES = {
    # arch, engine kwargs, prompt length range
    "qwen_chunked_span": ("qwen2_0_5b",
                          dict(window=48, max_batch=3, chunk=4,
                               prefill_chunk=8), (5, 20)),
    "mixtral_ring": ("mixtral_8x22b",
                     dict(window=40, max_batch=3, chunk=4), (6, 14)),
    "phi4_chunked_span": ("phi4_mini_3_8b",
                          dict(window=40, max_batch=2, chunk=5,
                               prefill_chunk=8), (3, 17)),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_dense_engine_matches_jax(case):
    arch, kw, (lo, hi) = ENGINE_CASES[case]
    cfg, jp, tp = _model(arch)
    jctx, tctx = _ctxs()
    je = JEngine(cfg, jctx, paged=False, **kw)
    te = TEngine(cfg, tctx, paged=False, **kw)
    assert (te.chunk_prefill, te.bucket_prefill) == \
        (je.chunk_prefill, je.bucket_prefill)
    assert te.chunk_prefill == (case != "mixtral_ring")
    rng = np.random.default_rng(2)
    lens = rng.integers(lo, hi + 1, 5)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in lens]
    jout = je.run(jp, [JRequest(rid=i, prompt=p, max_new=9)
                       for i, p in enumerate(prompts)])
    tout = te.run(tp, [TRequest(rid=i, prompt=p, max_new=9)
                       for i, p in enumerate(prompts)])
    assert sorted(jout) == sorted(tout) == list(range(5))
    for rid in jout:
        np.testing.assert_array_equal(tout[rid], jout[rid],
                                      err_msg=f"rid {rid}")
    assert te.scheduler.stats == je.scheduler.stats
    assert te.scheduler.stats["completions"] == 5

    batch = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    want = np.asarray(je.generate_pertoken(
        jp, {"tokens": jnp.asarray(batch)}, max_new=7))
    got = te.generate_pertoken(tp, {"tokens": batch}, max_new=7)
    assert got.shape == (2, 7) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for name in COUNTERS:
        assert te.counters[name] == je.counters[name], name
    assert te.counters["pertoken_steps"] == 7
    if te.chunk_prefill:
        assert te.counters["span_prefill_dense_compiles"] > 0
    np.testing.assert_array_equal(
        te.generate(tp, {"tokens": batch}, max_new=7).numpy(), want)


CHAOS = dict(seed=7, worker_fail_rate=0.25, page_flip_rate=0.25,
             transfer_drop_rate=0.2, straggler_rate=0.2)


@pytest.mark.parametrize("scenario", ["chaos", "ttft_shedding"])
def test_dense_engine_under_faults_and_admission_matches_jax(scenario):
    cfg, jp, tp = _model("qwen2_0_5b")
    jctx, tctx = _ctxs()
    kw = dict(window=32, max_batch=2, chunk=2, prefill_chunk=8,
              paged=False)
    if scenario == "chaos":
        je = JEngine(cfg, jctx, faults=jfaults.FaultInjector(
            jfaults.FaultPlan(**CHAOS)), **kw)
        te = TEngine(cfg, tctx, faults=tfaults.FaultInjector(
            tfaults.FaultPlan(**CHAOS)), **kw)
    else:
        policy = dict(ttft_deadline_steps=3)
        je = JEngine(cfg, jctx, admission=jadm.AdmissionController(
            jadm.AdmissionPolicy(**policy)), **kw)
        te = TEngine(cfg, tctx, admission=tadm.AdmissionController(
            tadm.AdmissionPolicy(**policy)), **kw)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(9, 15)))
               for _ in range(4)]
    arrival = [0, 0, 1, 1] if scenario == "ttft_shedding" else [0] * 4
    jout = je.run(jp, [JRequest(rid=i, prompt=p, max_new=12, arrival=a)
                       for i, (p, a) in enumerate(zip(prompts, arrival))])
    tout = te.run(tp, [TRequest(rid=i, prompt=p, max_new=12, arrival=a)
                       for i, (p, a) in enumerate(zip(prompts, arrival))])
    assert sorted(tout) == sorted(jout)
    for rid in jout:
        np.testing.assert_array_equal(tout[rid], jout[rid],
                                      err_msg=f"rid {rid}")
    assert dict(te.fault_stats.items()) == dict(je.fault_stats.items())
    assert te.scheduler.stats == je.scheduler.stats
    assert [r.rid for r in te.scheduler.shed] == \
        [r.rid for r in je.scheduler.shed]
    fs = te.fault_stats
    if scenario == "chaos":
        assert fs["fault_stragglers"] > 0
        assert fs["fault_page_corruptions"] == fs["fault_detections"] == 0
        assert len(tout) == 4
    else:
        assert fs["shed_requests"] > 0


# -------------------------------------------------------------- new configs


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    return {"tokens": tokens,
            "labels": np.roll(tokens, -1, axis=1).astype(np.int32)}


@pytest.mark.parametrize("arch", NEW_CONFIGS)
def test_new_config_matches_reference(arch):
    for mine, ref in ((registry.get_arch(arch), j_get_arch(arch)),
                      (registry.get_smoke(arch), j_get_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    dims = {"internlm2_1_8b": (24, 2048, 16, 8, 128, 8192, 92544),
            "phi4_mini_3_8b": (32, 3072, 24, 8, 128, 8192, 200064),
            "qwen2_5_3b": (36, 2048, 16, 2, 128, 11008, 151936)}[arch]
    cfg = registry.get_arch(arch)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size) == dims
    assert tapi.supports_paged_decode(cfg)
    cfg, jp, tp = _model(arch)
    batch = _batch(cfg)
    jctx, tctx = _ctxs()
    jl, jm = japi.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                          cfg, jctx)
    tl, tm = tapi.loss_fn(tp, {k: torch.from_numpy(v)
                               for k, v in batch.items()}, cfg, tctx)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=2e-5, atol=1e-7, err_msg=key)
