"""Prefill/decode disaggregation of the port against the JAX package on
the CPU: ``PageTransferModel`` (``transfer_s``, ``delay_boundaries``) on a
grid of pages, page sizes, chunks, resident sets, generations and links;
the engine's runs of tests/test_serve_sharded.py (qwen2 smoke, f32, two
prefill workers on the "ici" and "dcn" links; speculation with staggered
arrivals; int8 pages), whose greedy tokens, ``transfer_stats()`` and
``prefill_pool.stats`` equal the JAX engine's, the tokens also the
co-located engine's; the paged-only check; and the launcher's ``--mesh
1,2 --disaggregate`` on the CPU."""

import itertools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke
from repro.core import hwspec as jhw
from repro.models import api as japi
from repro.models.blocks import ModelContext as JCtx
from repro.models.params import init_params as j_init_params
from repro.serve.engine import PageTransferModel as JTransfer
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import Request as JRequest
from repro_torch.models.blocks import ModelContext as TCtx
from repro_torch.models.params import params_from_numpy
from repro_torch.serve.engine import PageTransferModel as TTransfer
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.scheduler import Request as TRequest

jax.config.update("jax_default_matmul_precision", "highest")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("hw", sorted(jhw.BY_NAME))
@pytest.mark.parametrize("link", ["ici", "dcn"])
def test_transfer_model_matches_reference(hw, link):
    for page_bytes, chunk, resident in itertools.product(
            (1 << 10, 1 << 14, 3 * 8 * 2 * 48 * 4, 57344),
            (1, 4, 8, 32), (1 << 16, 1 << 22, 6 << 30)):
        kw = dict(page_bytes=page_bytes, chunk=chunk,
                  resident_bytes=resident, hw=hw, link=link)
        j, t = JTransfer(**kw), TTransfer(**kw)
        assert t.boundary_s == j.boundary_s
        assert t.latency_s == j.latency_s
        for n in (0, 1, 2, 5, 17, 300, 4096):
            assert t.transfer_s(n) == j.transfer_s(n)
            assert t.delay_boundaries(n) == j.delay_boundaries(n)
    with pytest.raises(ValueError, match="transfer link"):
        TTransfer(page_bytes=1, chunk=1, resident_bytes=1, link="rdma")


@pytest.fixture(scope="module")
def qwen():
    cfg = get_smoke("qwen2_0_5b")
    jp = j_init_params(jax.random.key(0), japi.model_specs(cfg))
    return cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")


def _reqs(cls, cfg, n=4, seed=1, max_new=8, arrivals=None):
    """tests/test_serve_sharded.py::_reqs."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                           int(rng.integers(8, 15))),
                max_new=max_new,
                arrival=0 if arrivals is None else arrivals[i])
            for i in range(n)]


def _both(qwen, *, int8=False, arrivals=None, **kw):
    """The JAX and the port's engines on the same requests: their outputs
    and engines."""
    cfg, jp, tp = qwen
    jctx = JCtx(compute_dtype=jnp.float32, q_chunk=64,
                decode_cache_dtype=jnp.int8 if int8 else None)
    tctx = TCtx(compute_dtype=torch.float32, q_chunk=64, device="cpu",
                decode_cache_dtype=torch.int8 if int8 else None)
    eng = dict(window=48, max_batch=2, chunk=4, page_size=8, **kw)
    je, te = JEngine(cfg, jctx, **eng), TEngine(cfg, tctx, **eng)
    jout = je.run(jp, _reqs(JRequest, cfg, arrivals=arrivals))
    tout = te.run(tp, _reqs(TRequest, cfg, arrivals=arrivals))
    return jout, tout, je, te


@pytest.mark.parametrize("case", [
    # test_disaggregated_matches_colocated, each link
    dict(link="ici"), dict(link="dcn"),
    # test_disaggregated_with_speculation_and_arrivals
    dict(link="ici", draft_k=2, arrivals=[0, 3, 9, 9], workers=1),
    # int8 pages: the transfer's page bytes count the scale pages
    dict(link="dcn", int8=True),
], ids=["ici", "dcn", "spec_arrivals", "int8_dcn"])
def test_disaggregated_matches_reference(qwen, case):
    case = dict(case)
    link, workers = case.pop("link"), case.pop("workers", 2)
    _, co, _, _ = _both(qwen, **case)
    jout, tout, je, te = _both(qwen, disaggregate=True,
                               prefill_workers=workers, transfer_link=link,
                               **case)
    assert sorted(tout) == sorted(jout) == sorted(co)
    for rid in jout:
        np.testing.assert_array_equal(tout[rid], jout[rid])
        np.testing.assert_array_equal(tout[rid], co[rid])
    ts = te.transfer_stats()
    assert ts == je.transfer_stats()
    assert te.prefill_pool.stats == je.prefill_pool.stats
    assert te.page_bytes == je.page_bytes
    assert ts["link"] == link and ts["transfers"] == 4
    assert ts["transfer_bytes"] > 0
    assert ts["transfer_stall_boundaries"] >= 1
    assert ts["prefill_depth_peak"] >= 1
    assert te.prefill_pool.stats["placed"] == 4
    assert te.scheduler.stats == je.scheduler.stats
    for c in ("host_syncs", "chunks", "prefills", "spec_tokens"):
        assert te.counters[c] == je.counters[c], c
    # a parked slot is frozen as a finished one: one drain a chunk
    assert te.counters["host_syncs"] == te.counters["chunks"]
    assert te.kv.counters == je.kv.counters


def test_disaggregation_checks_match_reference():
    ctx = TCtx(compute_dtype=torch.float32, device="cpu")
    jctx = JCtx(compute_dtype=jnp.float32)
    cfg = get_smoke("rwkv6_1_6b")
    for engine, c in ((JEngine, jctx), (TEngine, ctx)):
        with pytest.raises(ValueError, match="disaggregation requires"):
            engine(cfg, c, window=32, max_batch=2, disaggregate=True)
        with pytest.raises(ValueError, match="prefill_workers"):
            engine(get_smoke("qwen2_0_5b"), c, window=32, max_batch=2,
                   disaggregate=True, prefill_workers=0)
    assert TEngine(get_smoke("qwen2_0_5b"), ctx,
                   window=32).transfer_stats() == {}


def test_launcher_mesh_and_disaggregation_on_the_cpu(tmp_path):
    """``--mesh 1,2 --disaggregate`` serves a smoke trace: the launcher
    starts the two ranks itself and rank 0 prints."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env["TMPDIR"] = str(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2_0_5b", "--smoke", "--trace", "6", "--device", "cpu",
         "--mesh", "1,2", "--disaggregate", "--prefill-workers", "2",
         "--link", "dcn", "--chaos", "7"],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert out.count("mesh={'data': 1, 'model': 2}") == 1, out
    assert "6 requests" in out and "mesh 1,2" in out
    assert "[disagg] link=dcn transfers=" in out
    assert "[faults] {" in out
