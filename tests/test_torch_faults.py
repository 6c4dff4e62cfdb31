"""Resilient serving of the port against the JAX package on the same
inputs: the fault schedule (numpy, answer for answer and digest for
digest), the admission policy's decisions, the FBIST patterns (byte for
byte), the startup self-test through the plain kernels, weight storage
quantization, and the engine under faults and admission on qwen2 smoke at
f32: survivors' tokens, ``fault_stats``, scheduler stats and the failed
and shed request ids equal the JAX ``ServeEngine``'s in the scenarios of
tests/test_serve_faults.py (co-located: the port has no disaggregation
yet, so the worker-failure and transfer-drop faults never fire)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke
from repro.core import sdc as jsdc
from repro.models import api as japi
from repro.models.blocks import ModelContext as JCtx
from repro.models.params import init_params as j_init_params
from repro.serve import admission as jadm
from repro.serve import faults as jfaults
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.engine import quantize_weights as j_quantize_weights
from repro.serve.scheduler import Request as JRequest
from repro_torch.core import sdc as tsdc
from repro_torch.launch import serve as launch_serve
from repro_torch.models.blocks import ModelContext as TCtx
from repro_torch.models.params import params_from_numpy, tree_items
from repro_torch.serve import admission as tadm
from repro_torch.serve import faults as tfaults
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.engine import quantize_weights as t_quantize_weights
from repro_torch.serve.scheduler import Request as TRequest

jax.config.update("jax_default_matmul_precision", "highest")

CHAOS = dict(seed=7, worker_fail_rate=0.25, page_flip_rate=0.25,
             transfer_drop_rate=0.2, straggler_rate=0.2)


@pytest.fixture(scope="module")
def qwen():
    cfg = get_smoke("qwen2_0_5b")
    jp = j_init_params(jax.random.key(0), japi.model_specs(cfg))
    return cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")


# ------------------------------------------------------- fault schedule


@pytest.mark.parametrize("seed,rates,horizon", [
    (7, (0.25, 0.25, 0.2, 0.2), 4096),
    (0, (0.0, 0.0, 0.0, 0.0), 64),
    (11, (0.0, 1.0, 0.0, 0.0), 300),
    (123456, (0.3, 0.1, 0.2, 0.4), 256),
    (2 ** 20, (0.05, 0.05, 0.05, 0.05), 1000),
])
def test_fault_schedule_matches_reference(seed, rates, horizon):
    kw = dict(zip(("worker_fail_rate", "page_flip_rate",
                   "transfer_drop_rate", "straggler_rate"), rates))
    j = jfaults.FaultInjector(jfaults.FaultPlan(
        seed=seed, horizon_boundaries=horizon, straggler_extra_boundaries=2,
        **kw))
    t = tfaults.FaultInjector(tfaults.FaultPlan(
        seed=seed, horizon_boundaries=horizon, straggler_extra_boundaries=2,
        **kw))
    assert t.schedule_digest() == j.schedule_digest()
    for b in range(-2, horizon + 2):
        assert (t.worker_failure(b), t.page_flip(b), t.transfer_drop(b),
                t.straggler(b)) == (j.worker_failure(b), j.page_flip(b),
                                    j.transfer_drop(b), j.straggler(b)), b


def test_fault_plan_validation_matches_reference():
    for bad in (dict(page_flip_rate=1.5), dict(horizon_boundaries=0),
                dict(straggler_extra_boundaries=0),
                dict(transfer_retry_boundaries=0)):
        with pytest.raises(ValueError):
            jfaults.FaultPlan(**bad)
        with pytest.raises(ValueError):
            tfaults.FaultPlan(**bad)


# ------------------------------------------------------------ admission


def _req_pair(rid, plen, arrival, *, cached=0, prefill_done=False,
              generated=0, retries=0, preemptions=0):
    out = []
    for cls in (JRequest, TRequest):
        r = cls(rid=rid, prompt=np.arange(plen), max_new=4, arrival=arrival)
        r.cached_prefix_len = cached
        r.prefill_done = prefill_done
        r.generated.extend(range(generated))
        r.retries = retries
        r.preemptions = preemptions
        out.append(r)
    return out


@pytest.mark.parametrize("deadline,depth", [(None, None), (3, 0), (12, 2),
                                            (40, None)])
def test_admission_decisions_match_reference(deadline, depth):
    jc = jadm.AdmissionController(jadm.AdmissionPolicy(deadline, depth))
    tc = tadm.AdmissionController(tadm.AdmissionPolicy(deadline, depth))
    reqs = [_req_pair(i, plen, arr, cached=c, prefill_done=pd, generated=g,
                      retries=rt, preemptions=pe)
            for i, (plen, arr, c, pd, g, rt, pe) in enumerate([
                (8, 0, 0, False, 0, 0, 0), (40, 3, 16, False, 0, 0, 0),
                (40, 3, 40, False, 0, 0, 0), (9, 0, 0, True, 0, 0, 0),
                (9, 0, 0, False, 2, 0, 0), (9, 0, 0, False, 0, 1, 0),
                (9, 0, 0, False, 0, 0, 1), (200, 5, 0, False, 0, 0, 0)])]
    for (jr, tr), clock, chunk, span, dis in itertools.product(
            reqs, (0, 4, 10, 33), (2, 8), (8, 128), (False, True)):
        kw = dict(chunk=chunk, span_len=span, disaggregated=dis)
        assert tc.should_shed(tr, clock, **kw) == jc.should_shed(
            jr, clock, **kw)
        assert tc.predicted_ttft_steps(tr, clock, **kw) == \
            jc.predicted_ttft_steps(jr, clock, **kw)
    for q in range(5):
        assert tc.drop_speculation(q) == jc.drop_speculation(q)


def test_admission_policy_validation_matches_reference():
    for bad in (dict(ttft_deadline_steps=0), dict(spec_off_queue_depth=-1)):
        with pytest.raises(ValueError):
            jadm.AdmissionPolicy(**bad)
        with pytest.raises(ValueError):
            tadm.AdmissionPolicy(**bad)


# ----------------------------------------------------------- core.sdc


def test_fbist_patterns_byte_equal_to_reference():
    for kw in ({}, dict(m=32, k=48, n=16, n_patterns=11, seed=5)):
        j, t = jsdc.FBIST(**kw), tsdc.FBIST(**kw)
        assert len(t._patterns) == len(j._patterns)
        for (ja, jb), (ta, tb) in zip(j._patterns, t._patterns):
            assert ta.dtype == ja.dtype == np.float32
            assert ta.tobytes() == ja.tobytes()
            assert tb.tobytes() == jb.tobytes()


def test_fbist_and_screening_on_the_cpu():
    fb = tsdc.FBIST(m=32, k=32, n=32)
    good = lambda a, b: a @ b
    bad = tsdc.faulty_wrap(good, tsdc.FaultModel(rate=1.0, magnitude=0.5,
                                                 seed=1))
    assert fb.run(good, device="cpu").passed
    rep = fb.run(bad, device="cpu")
    assert not rep.passed and rep.first_failing_pattern == 0
    assert tsdc.screen_devices([good, bad, good], fbist=fb,
                               device="cpu") == [1]


def test_fault_model_draws_match_reference():
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    jm = jsdc.FaultModel(rate=0.5, magnitude=0.25, seed=3)
    tm = tsdc.FaultModel(rate=0.5, magnitude=0.25, seed=3)
    for _ in range(10):
        np.testing.assert_array_equal(tm.corrupt(x), jm.corrupt(x))
    wrapped = tsdc.faulty_wrap(lambda a: a * 2, tsdc.FaultModel(seed=0))
    out = wrapped(torch.ones(4, 4, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16 and int((out != 2).sum()) == 1


def test_replay_checker_catches_a_bad_lane():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 16)).astype(np.float32))
    chk = tsdc.ReplayChecker(sample_frac=0.25)
    gen = torch.Generator().manual_seed(0)
    rep = chk.check(torch.tanh, x, gen)
    assert rep.passed and rep.bundles_checked == 16
    lane = torch.ones(16)
    lane[3] = 1.001  # lane 3 is marginal: wrong in one pass, not the other
    rep = chk.check(lambda s: torch.tanh(s) * lane, x, gen)
    assert not rep.passed and rep.mismatches > 0
    with pytest.raises(ValueError):
        tsdc.ReplayChecker(sample_frac=0.0)


def test_sdc_rate_model_matches_reference():
    jm, tm = jsdc.SDCRateModel(), tsdc.SDCRateModel()
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    for chips in (1, 256, 9216):
        assert tm.corruption_rate_per_s(chips) == \
            jm.corruption_rate_per_s(chips)
        assert tm.draw_time_to_corruption_s(tr, chips) == \
            jm.draw_time_to_corruption_s(jr, chips)
        assert tm.draw_detection_delay_s(tr) == jm.draw_detection_delay_s(jr)


# ------------------------------------------------------- startup BIST


def test_startup_bist_matches_reference():
    j = jfaults.startup_bist(interpret=True)
    t = tfaults.startup_bist(impl="ref", device="cpu")
    assert t.passed and j.passed
    assert t.matmul_report.patterns_run == j.matmul_report.patterns_run == 8
    assert abs(t.matmul_report.max_abs_err
               - j.matmul_report.max_abs_err) <= 1e-6
    assert abs(t.paged_decode_max_err - j.paged_decode_max_err) <= 1e-6


def test_startup_bist_catches_the_reference_planted_faults():
    bad_mm = tsdc.faulty_wrap(lambda a, b: a @ b,
                              tsdc.FaultModel(rate=1.0, magnitude=0.5, seed=1))
    res = tfaults.startup_bist(impl="ref", device="cpu", matmul_fn=bad_mm)
    assert not res.passed and not res.matmul_report.passed
    res = tfaults.startup_bist(
        impl="ref", device="cpu", matmul_fn=lambda a, b: a @ b,
        decode_fn=lambda q, k, v, t, p, **kw: torch.zeros_like(q))
    assert not res.passed and not res.paged_decode_ok
    assert res.matmul_report.passed


# ------------------------------------------------ engine under faults


def _engines(cfg, *, faults=None, admission=None, retry_budget=3,
             spec=True, int8=False):
    """The JAX and port engines of tests/test_serve_faults.py::_build,
    co-located; ``faults``/``admission`` are plan/policy kwargs."""
    kw = dict(window=32, max_batch=2, chunk=2, page_size=8,
              draft_k=2 if spec else 0, retry_budget=retry_budget)
    jctx = JCtx(compute_dtype=jnp.float32, q_chunk=64,
                decode_cache_dtype=jnp.int8 if int8 else None)
    tctx = TCtx(compute_dtype=torch.float32,
                decode_cache_dtype=torch.int8 if int8 else None,
                device="cpu")
    je = JEngine(cfg, jctx, disaggregate=False, prefill_workers=1,
                 faults=(None if faults is None else jfaults.FaultInjector(
                     jfaults.FaultPlan(**faults))),
                 admission=(None if admission is None else
                            jadm.AdmissionController(
                                jadm.AdmissionPolicy(**admission))),
                 **kw)
    te = TEngine(cfg, tctx,
                 faults=(None if faults is None else tfaults.FaultInjector(
                     tfaults.FaultPlan(**faults))),
                 admission=(None if admission is None else
                            tadm.AdmissionController(
                                tadm.AdmissionPolicy(**admission))),
                 **kw)
    return je, te


def _reqs(cls, cfg, n, *, seed=1, lo=9, hi=14, max_new=6, late=False):
    rng = np.random.default_rng(seed)
    out = [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                          int(rng.integers(lo, hi + 1))),
               max_new=max_new) for i in range(n)]
    if late:  # latecomers behind a full batch
        for i, r in enumerate(out):
            r.arrival = 0 if i < 2 else 1
    return out


SCENARIOS = {
    # 16 new tokens (not 6): co-located, 6 end the run before the plan's
    # first page flip (boundary 4)
    "chaos_f32": dict(faults=CHAOS, max_new=16),
    "chaos_int8_pages": dict(faults=CHAOS, int8=True, max_new=16),
    "disabled_injector": dict(faults=dict(seed=7)),
    "retry_budget_0": dict(faults=dict(seed=11, page_flip_rate=1.0),
                           retry_budget=0),
    "ttft_shedding": dict(admission=dict(ttft_deadline_steps=3),
                          spec=False, n=4, late=True),
    "spec_off_under_pressure": dict(admission=dict(spec_off_queue_depth=0),
                                    n=4),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_under_faults_matches_reference(qwen, name):
    cfg, jp, tp = qwen
    kw = dict(SCENARIOS[name])
    rq = dict(n=kw.pop("n", 3), late=kw.pop("late", False),
              max_new=kw.pop("max_new", 6))
    je, te = _engines(cfg, **kw)
    jout = je.run(jp, _reqs(JRequest, cfg, **rq))
    tout = te.run(tp, _reqs(TRequest, cfg, **rq))
    assert sorted(tout) == sorted(jout)
    for rid in jout:
        np.testing.assert_array_equal(tout[rid], jout[rid],
                                      err_msg=f"rid {rid}")
    assert dict(te.fault_stats.items()) == dict(je.fault_stats.items())
    assert te.scheduler.stats == je.scheduler.stats
    assert [r.rid for r in te.scheduler.failed] == \
        [r.rid for r in je.scheduler.failed]
    assert [r.rid for r in te.scheduler.shed] == \
        [r.rid for r in je.scheduler.shed]
    assert te.kv.counters == je.kv.counters
    for c in ("host_syncs", "chunks", "spec_tokens", "spec_steps",
              "prefills", "suffix_prefills", "cached_prompt_tokens"):
        assert te.counters[c] == je.counters[c], c
    fs = te.fault_stats
    if name.startswith("chaos"):
        assert fs["fault_page_corruptions"] > 0 and fs["fault_detections"] > 0
        assert te.kv._quarantined
        assert not (te.kv._quarantined & set(te.kv._index))
    if name == "retry_budget_0":
        assert te.scheduler.stats["failures"] > 0
    if name == "ttft_shedding":
        assert fs["shed_requests"] > 0
    if name == "spec_off_under_pressure":
        assert fs["shed_spec_chunks"] > 0 and fs["shed_requests"] == 0
    if name == "disabled_injector":
        assert sum(fs.values()) == 0


# ------------------------------------------------- weight quantization


@pytest.mark.parametrize("kind", ["fp8", "int8"])
def test_quantize_weights_matches_reference(qwen, kind):
    cfg, jp, tp = qwen
    jdt = {"fp8": jnp.float8_e4m3fn, "int8": jnp.int8}[kind]
    tdt = {"fp8": torch.float8_e4m3fn, "int8": torch.int8}[kind]
    jq = j_quantize_weights(jp, jdt)
    tq = t_quantize_weights(tp, tdt)
    jleaves = dict(tree_items(jax.tree.map(np.asarray, jq)))
    tleaves = dict(tree_items(tq))
    assert sorted(jleaves) == sorted(tleaves)
    cast = 0
    for path, jl in jleaves.items():
        tl = tleaves[path]
        assert tl.shape == jl.shape, path
        assert tl.element_size() == jl.dtype.itemsize, path
        assert tl.contiguous().view(torch.uint8).numpy().tobytes() == \
            np.ascontiguousarray(jl).view(np.uint8).tobytes(), path
        cast += tl.dtype == tdt
    assert tleaves["embed"].dtype == tdt  # the tied embedding too
    assert cast == sum(jl.dtype == jdt for jl in jleaves.values())
    # greedy tokens of a smoke serve over the quantized weights
    je, te = _engines(cfg, spec=False)
    jout = je.run(jq, _reqs(JRequest, cfg, 2, max_new=4))
    tout = te.run(tq, _reqs(TRequest, cfg, 2, max_new=4))
    for rid in jout:
        np.testing.assert_array_equal(tout[rid], jout[rid])


# ------------------------------------------------------------ launcher


def test_launcher_bist_and_chaos_on_the_cpu(capsys):
    launch_serve.main(["--arch", "qwen2_0_5b", "--smoke", "--device", "cpu",
                       "--bist", "--chaos", "7", "--trace", "4",
                       "--ttft-deadline", "64", "--spec-off-depth", "1",
                       "--draft-k", "2", "--quantize", "fp8"])
    out = capsys.readouterr().out
    assert "-> PASS" in out
    line = [ln for ln in out.splitlines() if ln.startswith("[faults] ")]
    assert len(line) == 1 and "'shed_spec_chunks'" in line[0]


def test_launcher_refuses_to_serve_on_a_failed_bist(monkeypatch, capsys):
    bad = tfaults.BISTResult(False, tsdc.FBISTReport(False, 1, 0, 1.0),
                             True, 0.0)
    monkeypatch.setattr(launch_serve, "startup_bist", lambda **kw: bad)
    with pytest.raises(SystemExit, match="refusing to serve"):
        launch_serve.main(["--arch", "qwen2_0_5b", "--smoke", "--device",
                           "cpu", "--bist", "--trace", "2"])
    assert "-> FAIL" in capsys.readouterr().out
