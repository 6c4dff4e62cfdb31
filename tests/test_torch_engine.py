"""ServeEngine of the port against the JAX package's ServeEngine (default
gather path) on qwen2 smoke with the same weights and requests: greedy
tokens must be identical, and so must the scheduler's decisions and the
engine's counters (host syncs, span-prefill calls, speculative tokens,
prefix-cache hits). The same holds on mixtral smoke, whose MoE FFN runs
the grouped dispatch and whose 8-token window trims pages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke
from repro.models import api as japi
from repro.models.blocks import ModelContext as JCtx
from repro.models.params import init_params as j_init_params
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import Request as JRequest
from repro_torch.models.blocks import ModelContext as TCtx
from repro_torch.models.params import params_from_numpy
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.scheduler import Request as TRequest

jax.config.update("jax_default_matmul_precision", "highest")

COUNTERS = ("host_syncs", "chunks", "prefill_span_calls", "spec_tokens",
            "spec_steps", "prefills", "suffix_prefills", "prompt_tokens",
            "cached_prompt_tokens", "span_prefill_compiles")


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


def _engines(cfg, int8=False, **kw):
    jctx = JCtx(compute_dtype=jnp.float32,
                decode_cache_dtype=jnp.int8 if int8 else None)
    tctx = TCtx(compute_dtype=torch.float32,
                decode_cache_dtype=torch.int8 if int8 else None,
                device="cpu")
    return JEngine(cfg, jctx, **kw), TEngine(cfg, tctx, **kw)


def _run_both(qwen, prompts, max_new, runs=1, int8=False, **kw):
    cfg, jp, tp = qwen
    je, te = _engines(cfg, int8=int8, **kw)
    for _ in range(runs):
        jout = je.run(jp, [JRequest(rid=i, prompt=p, max_new=max_new)
                           for i, p in enumerate(prompts)])
        tout = te.run(tp, [TRequest(rid=i, prompt=p, max_new=max_new)
                           for i, p in enumerate(prompts)])
        assert sorted(jout) == sorted(tout)
        for rid in jout:
            np.testing.assert_array_equal(tout[rid], jout[rid],
                                          err_msg=f"rid {rid}")
        assert te.scheduler.stats == je.scheduler.stats
        assert te.prefix_hit_rate == je.prefix_hit_rate
    for name in COUNTERS:
        assert te.counters[name] == je.counters[name], name
    assert te.kv.counters == je.kv.counters
    return je, te


def _prompts(cfg, n, lo, hi, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1)))
            for _ in range(n)]


EVICTION = dict(window=64, max_batch=3, chunk=4, page_size=8, num_pages=12)


@pytest.mark.parametrize("case", ["plain", "draft_k2", "int8"])
def test_eviction_scenario_matches_reference(qwen, case):
    """5 requests through 3 slots and a pool too small for all of them
    (the eviction scenario of tests/test_serve.py): admissions,
    completions and at least one preemption."""
    kw = dict(EVICTION)
    if case == "draft_k2":
        kw["draft_k"] = 2
    je, te = _run_both(qwen, _prompts(qwen[0], 5, 8, 14), 14,
                       int8=case == "int8", **kw)
    assert te.scheduler.stats["preemptions"] >= 1
    assert te.scheduler.stats["completions"] == 5
    assert te.counters["host_syncs"] == te.counters["chunks"]
    if case == "draft_k2":
        assert te.counters["spec_tokens"] > 0


@pytest.mark.parametrize("case", ["plain", "draft_k2", "int8"])
def test_moe_eviction_and_trim_match_reference(mixtral, case):
    """Mixtral smoke through the eviction scenario's small pool: prompts
    longer than the 8-token window, so decode trims pages behind it as
    the reference does (which frees enough pages that nothing is
    preempted); speculation and int8 pages as above."""
    kw = dict(EVICTION)
    if case == "draft_k2":
        kw["draft_k"] = 2
    je, te = _run_both(mixtral, _prompts(mixtral[0], 5, 8, 14), 14,
                       int8=case == "int8", **kw)
    assert te.counters["pages_trimmed"] == je.counters["pages_trimmed"] > 0
    assert te.scheduler.stats["completions"] == 5
    if case == "draft_k2":
        assert te.counters["spec_tokens"] > 0


def test_moe_prefix_hits_match_reference(mixtral):
    cfg = mixtral[0]
    shared = _prompts(cfg, 1, 16, 16, seed=3)[0]
    tails = _prompts(cfg, 3, 3, 9, seed=4)
    prompts = [np.concatenate([shared, t]) for t in tails]
    je, te = _run_both(mixtral, prompts, 6, runs=2, window=48, max_batch=2,
                       chunk=4, page_size=8)
    assert te.prefix_hit_rate > 0
    assert te.counters["suffix_prefills"] > 0
    assert te.counters["pages_trimmed"] == je.counters["pages_trimmed"]


def test_prefix_hits_on_second_run_match_reference(qwen):
    """Prompts sharing a two-page prefix, served twice by one engine: the
    second run adopts the pages published by the first."""
    cfg = qwen[0]
    shared = _prompts(cfg, 1, 16, 16, seed=3)[0]
    tails = _prompts(cfg, 3, 3, 9, seed=4)
    prompts = [np.concatenate([shared, t]) for t in tails]
    je, te = _run_both(qwen, prompts, 6, runs=2, window=48, max_batch=2,
                       chunk=4, page_size=8)
    assert te.prefix_hit_rate > 0
    assert te.counters["suffix_prefills"] > 0


def test_generate_matches_reference(qwen):
    cfg, jp, tp = qwen
    je, te = _engines(cfg, window=48, max_batch=3, chunk=5)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 12))
    want = je.generate(jp, {"tokens": jnp.asarray(tokens, jnp.int32)},
                       max_new=9)
    got = te.generate(tp, {"tokens": tokens}, max_new=9)
    assert got.shape == (3, 9) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert te.counters["host_syncs"] == je.counters["host_syncs"]


def test_eos_and_sampling(qwen):
    """EOS stops a request early (as the reference does), and sampling
    with an explicit generator is reproducible."""
    cfg, jp, tp = qwen
    je, te = _engines(cfg, window=48, max_batch=1, chunk=4)
    p = _prompts(cfg, 1, 10, 10, seed=6)[0]
    full = te.run(tp, [TRequest(rid=0, prompt=p, max_new=12)])[0]
    eos = int(full[4])
    je, te = _engines(cfg, window=48, max_batch=1, chunk=4, eos_id=eos)
    want = je.run(jp, [JRequest(rid=0, prompt=p, max_new=12)])[0]
    got = te.run(tp, [TRequest(rid=0, prompt=p, max_new=12)])[0]
    np.testing.assert_array_equal(got, want)
    assert len(got) < 12 and got[-1] == eos
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(7)
        outs.append(te.run(tp, [TRequest(rid=0, prompt=p, max_new=12)],
                           generator=gen, temperature=1.0)[0])
    np.testing.assert_array_equal(outs[0], outs[1])
    assert ((outs[0] >= 0) & (outs[0] < cfg.vocab_size)).all()


def test_unported_features_raise(qwen):
    """mesh= runs the paged backend only: on the dense caches it is not
    ported and raises NotImplementedError (disaggregate=True and the
    paged mesh are ported; tests/test_torch_sharding.py and
    tests/test_torch_disagg.py hold them). On the dense backend
    speculation and prefix caching raise ValueError, as in the reference
    engine."""
    cfg = qwen[0]
    ctx = TCtx(compute_dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="dense and ring"):
        TEngine(cfg, ctx, window=32, paged=False,
                mesh={"data": 1, "model": 2})
    eng = TEngine(cfg, ctx, window=32, disaggregate=True)
    assert eng.transfer_model is not None and eng.paged
    jctx = JCtx(compute_dtype=jnp.float32)
    for kw in (dict(draft_k=2), dict(prefix_cache=True)):
        for engine, c in ((JEngine, jctx), (TEngine, ctx)):
            with pytest.raises(ValueError, match="paged KV backend"):
                engine(cfg, c, window=32, paged=False, **kw)
