"""The port's multi-device serving path against the JAX package on the
CPU: the logical-axis rules (``resolve_spec``, ``summarize_dropped``,
``tree_shardings``) on a grid of dims, meshes and all four rule sets; the
paged attention's partition plan and the GQA fallback's KV-head block;
the expert-parallel grouped GEMM over gloo ranks; and ``ServeEngine`` on
(data, model) meshes of 2 and 4 gloo ranks (one process each): qwen2 smoke
on (1, 2) and (2, 2) over f32, bf16 and int8 pools with speculation and a
second run on prefix hits, qwen2 smoke with its vocabulary split over
"model", and mixtral smoke on (2, 2) (experts over "data", heads over
"model") and (1, 4) (the GQA fallback). Greedy tokens equal the JAX solo
engine's and the port's solo engine's; ``sharding_report`` equals the JAX
engine's on the same mesh shape (built in a subprocess with fake devices:
under this JAX the reference's mesh engine constructs and shards, and
only its ``run`` fails).

The reference functions need only ``mesh.axis_names`` and
``mesh.devices.shape``, so they get a stub mesh here."""

import dataclasses
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.models.blocks import ModelContext as JCtx
from repro.models.params import axes_tree, init_params as j_init_params
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import Request as JRequest
from repro.sharding import axes as jaxes
from repro_torch.kernels import ops as tops
from repro_torch.models import api as tapi
from repro_torch.models import moe as tmoe
from repro_torch.models.blocks import ModelContext as TCtx
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.scheduler import Request as TRequest
from repro_torch.serve.sharded import request_dicts, serve_on_mesh
from repro_torch.sharding import axes as taxes

jax.config.update("jax_default_matmul_precision", "highest")

RANK_TIMEOUT_S = 120.0


class StubMesh:
    """What the reference's rule functions read of a mesh."""

    def __init__(self, names, shape):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


MESHES = [(("data", "model"), s) for s in
          ((1, 1), (2, 1), (1, 2), (2, 2), (1, 4), (4, 2), (2, 4), (8, 16))]
MESHES += [(("pod", "data", "model"), (2, 2, 2)),
           (("pod", "data", "model"), (2, 4, 4))]
RULES = sorted(taxes.RULE_SETS)
LOGICALS = [
    ("embed", "heads", "head_dim"), ("heads", "head_dim", "embed"),
    ("embed", "kv_heads", "head_dim"), ("vocab", "embed"),
    ("embed", "mlp"), ("mlp", "embed"), ("expert", "embed", "expert_mlp"),
    ("expert", "expert_mlp", "embed"), ("batch", "seq", "embed"),
    ("batch", "act_seq", "embed"), (None, None, "kv_heads", None),
    ("batch", "kv_seq", "kv_heads", None), ("exp_cap", "embed"),
    ("heads", "kv_heads"), ("mlp", "vocab"), ("unknown", "embed"),
    ("batch", "heads", None, None), (None,),
]
DIMS = [1, 2, 3, 4, 6, 8, 12, 14, 16, 48, 211, 212, 896, 4864, 151936]


def _grid():
    rng = np.random.default_rng(0)
    for logical in LOGICALS:
        for _ in range(6):
            yield logical, tuple(int(d) for d in rng.choice(DIMS,
                                                            len(logical)))


@pytest.mark.parametrize("names,shape", MESHES,
                         ids=[f"{'x'.join(map(str, s))}" for _, s in MESHES])
@pytest.mark.parametrize("rules", RULES)
def test_resolve_spec_and_dropped_match_reference(names, shape, rules):
    jr, tr = jaxes.RULE_SETS[rules], taxes.RULE_SETS[rules]
    mesh = StubMesh(names, shape)
    tmesh = dict(zip(names, shape))
    jd, td = [], []
    for logical, dims in _grid():
        want = tuple(jaxes.resolve_spec(logical, dims, mesh, jr, jd))
        assert taxes.resolve_spec(logical, dims, tmesh, tr, td) == want, \
            (logical, dims)
        assert taxes.resolve_spec(logical, dims, mesh, tr) == want
    assert td == jd
    assert taxes.summarize_dropped(td, tmesh, tr) == \
        jaxes.summarize_dropped(jd, mesh, jr)
    with pytest.raises(ValueError, match="rank"):
        taxes.resolve_spec(("embed",), (4, 4), tmesh, tr)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "mixtral_8x22b"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_tree_shardings_match_reference_on_the_model(arch, shape):
    """Every parameter leaf of the model, at full width, resolves as the
    reference resolves it, and the dropped rules come in its order."""
    from repro.configs.registry import get_arch as j_get_arch
    from repro_torch.configs.registry import get_arch as t_get_arch
    jspecs = japi.model_specs(j_get_arch(arch))
    tspecs = tapi.model_specs(t_get_arch(arch))
    logical = axes_tree(jspecs)
    shapes = jax.tree.map(lambda s: tuple(s.shape), jspecs,
                          is_leaf=lambda x: hasattr(x, "logical"))
    mesh = StubMesh(("data", "model"), shape)
    rules = jaxes.BASELINE_RULES
    jd, td = [], []
    want = jax.tree.map(
        lambda la, shp: tuple(jaxes.resolve_spec(la, shp, mesh, rules, jd)),
        logical, shapes, is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(e, (str, type(None))) for e in x))
    tlogical = jax.tree.map(lambda s: tuple(s.logical), tspecs,
                            is_leaf=lambda x: hasattr(x, "logical"))
    tshapes = jax.tree.map(lambda s: tuple(s.shape), tspecs,
                           is_leaf=lambda x: hasattr(x, "logical"))
    got = taxes.tree_shardings(tlogical, tshapes, dict(zip(
        ("data", "model"), shape)), taxes.BASELINE_RULES, td)
    assert got == want
    assert taxes.summarize_dropped(td, mesh, taxes.BASELINE_RULES) == \
        jaxes.summarize_dropped(jd, mesh, rules)


@pytest.mark.parametrize("d,m", [(1, 1), (2, 1), (1, 2), (2, 2), (1, 4),
                                 (4, 2), (2, 8), (1, 16)])
def test_paged_partition_matches_reference(d, m):
    mesh = StubMesh(("data", "model"), (d, m))
    for b, h, kv in itertools.product((1, 2, 3, 4, 8), (1, 2, 4, 6, 8, 12,
                                                        14, 24, 48),
                                      (1, 2, 4, 6, 8)):
        if h % kv:
            continue
        want = jops._paged_partition(mesh, "data", "model", b, h, kv)
        assert tops.paged_partition(mesh, "data", "model", b, h,
                                    kv) == want, (b, h, kv)
        assert tops.paged_partition({"data": d, "model": m}, "data",
                                    "model", b, h, kv) == want


@pytest.mark.parametrize("h,kv,m", [(8, 2, 4), (8, 1, 2), (8, 1, 4),
                                    (16, 2, 4), (16, 2, 8), (12, 3, 6),
                                    (24, 2, 4), (48, 8, 16), (14, 2, 14)])
def test_local_kv_block_matches_reference_slice(h, kv, m):
    """The GQA fallback's KV-head block, against the reference's
    ``_local_kv_slice`` run under ``jax.vmap`` over the model axis."""
    _, hm, _, slice_kv, _ = tops.paged_partition(
        {"model": m}, "data", "model", 1, h, kv)
    assert hm == "model" and slice_kv
    pool = np.broadcast_to(np.arange(kv, dtype=np.float32)[None, None, :,
                                                           None],
                           (m, 2, 3, kv, 4)).copy()
    want = np.asarray(jax.vmap(
        lambda a: jops._local_kv_slice([a], "model", h, kv, m)[0],
        axis_name="model")(jnp.asarray(pool)))
    for idx in range(m):
        start, n = tops.local_kv_block(h, kv, m, idx)
        np.testing.assert_array_equal(pool[idx, :, :, start:start + n],
                                      want[idx])


def test_expert_parallel_grouped_matmul_over_ranks(tmp_path):
    """``ops.grouped_matmul(mesh=...)`` on a (2, 1) gloo mesh: each rank
    holds 2 of 4 experts; the sum over "data" equals the one-device
    product, on every rank. The same ranks run the collectives the mesh
    path issues (a bf16 all-reduce summed in f32, an int8 all-gather) and
    the MoE layer's grouped dispatch over the mesh (mixtral smoke's 4
    experts, 2 a rank) against the one-device layer. A mapping mesh whose
    expert axis is 1 runs the plain call; experts that do not split the
    axis raise."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16, 24)).astype(np.float32)
    gids = np.array([0, 0, 1, -1, 2, 3, 3, -1], np.int32)
    want = tops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(gids), impl="ref").numpy()
    cfg = get_smoke("mixtral_8x22b")
    xm = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    full = init_params(tmoe.moe_param_specs(cfg), seed=3, device="cpu")
    want_moe, _ = tmoe.moe_ffn(full, torch.from_numpy(xm), cfg,
                               torch.float32, dispatch="grouped",
                               impl="ref", with_aux=False)
    res = serve_on_mesh(
        [{"task": "torch_rank_tasks:expert_parallel_gemm",
          "kwargs": dict(x=x, w=w, gids=gids)},
         {"task": "torch_rank_tasks:gloo_collectives"},
         {"task": "torch_rank_tasks:expert_parallel_moe",
          "kwargs": dict(arch="mixtral_8x22b", x=xm, seed=3)}],
        (2, 1), "cpu", timeout_s=RANK_TIMEOUT_S, store_dir=str(tmp_path))
    for got, (s, g), moe_out in res:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(s, np.full(3, 3.0))
        np.testing.assert_array_equal(g, np.arange(2))
        np.testing.assert_allclose(moe_out, want_moe.numpy(), rtol=1e-6,
                                   atol=1e-6)
    got = tops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(gids), impl="ref",
                              mesh={"data": 1, "model": 2})
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="do not split"):
        tops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(gids), impl="ref",
                            mesh={"data": 2}, n_experts=6)


# ------------------------------------------------------ the mesh serve


def _cfg(arch, over):
    return dataclasses.replace(get_smoke(arch), **over)


QWEN = dict(arch="qwen2_0_5b", over={}, n=4, lo=8, hi=15, max_new=8,
            seed=1, eng=dict(window=48, max_batch=2, chunk=4, page_size=8,
                             draft_k=2),
            caches=(None, "bfloat16", "int8"), runs=2)
MIXTRAL = dict(arch="mixtral_8x22b", over={}, n=3, lo=6, hi=12, max_new=6,
               seed=2, eng=dict(window=32, max_batch=2, chunk=4,
                                page_size=4),
               caches=(None,), runs=1)
CASES = {
    # the reference's test_sharded_decode_matches_single_host, at the
    # mesh shapes this test's ranks allow
    "qwen_1x2": dict(QWEN, mesh=(1, 2), disagg=True),
    "qwen_2x2": dict(QWEN, mesh=(2, 2)),
    # a vocabulary that divides "model": the masked embedding lookup and
    # the lm head's gathered logits
    "qwen_vocab212_1x2": dict(QWEN, over={"vocab_size": 212}, mesh=(1, 2),
                              caches=(None,)),
    # experts over "data", heads (kv 2 divides model 2) over "model"
    "mixtral_2x2": dict(MIXTRAL, mesh=(2, 2)),
    # the reference's test_gqa_kv_fallback_sharded_parity: kv 2 does not
    # divide model 4, each rank keeps its group-aligned KV block
    "mixtral_1x4": dict(MIXTRAL, mesh=(1, 4)),
}

_JAX_REPORTS = """
import dataclasses, json, jax, jax.numpy as jnp
from repro.configs.registry import get_smoke
from repro.models import api
from repro.models.blocks import ModelContext
from repro.models.params import init_params
from repro.serve.engine import ServeEngine
out = {}
for name, arch, over, shape, eng in json.loads(%r):
    cfg = dataclasses.replace(get_smoke(arch), **over)
    params = init_params(jax.random.key(0), api.model_specs(cfg))
    ctx = ModelContext(compute_dtype=jnp.float32, q_chunk=64)
    e = ServeEngine(cfg, ctx, mesh=jax.make_mesh(tuple(shape),
                                                 ("data", "model")), **eng)
    built = e.sharding_report
    e.shard_params(params)
    out[name] = [built, e.sharding_report]
print("REPORTS" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_reports():
    from conftest import run_in_subprocess
    cases = [[name, c["arch"], c["over"], list(c["mesh"]), c["eng"]]
             for name, c in CASES.items()]
    out = run_in_subprocess(_JAX_REPORTS % json.dumps(cases), devices=4)
    return json.loads(out.split("REPORTS", 1)[1])


def _requests(cls, cfg, c):
    rng = np.random.default_rng(c["seed"])
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                           int(rng.integers(c["lo"],
                                                            c["hi"]))),
                max_new=c["max_new"]) for i in range(c["n"])]


def _jax_dtype(name):
    return None if name is None else getattr(jnp, name)


def _torch_dtype(name):
    return None if name is None else getattr(torch, name)


_SOLO = {}


def _solo(c, cache):
    """The JAX and the port's solo engines over ``c``'s requests, run
    ``c["runs"]`` times on one engine each: the greedy tokens (equal in
    both), the port's pool counters and host syncs of each run. Cached:
    cases on two mesh shapes share them."""
    key = (c["arch"], json.dumps(c["over"]), cache)
    if key in _SOLO:
        return _SOLO[key]
    cfg = _cfg(c["arch"], c["over"])
    jp = j_init_params(jax.random.key(0), japi.model_specs(cfg))
    np_params = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(np_params, device="cpu")
    jctx = JCtx(compute_dtype=jnp.float32, q_chunk=64,
                decode_cache_dtype=_jax_dtype(cache))
    tctx = TCtx(compute_dtype=torch.float32, q_chunk=64, device="cpu",
                decode_cache_dtype=_torch_dtype(cache))
    je, te = JEngine(cfg, jctx, **c["eng"]), TEngine(cfg, tctx, **c["eng"])
    runs = []
    for _ in range(c["runs"]):
        jout = je.run(jp, _requests(JRequest, cfg, c))
        tout = te.run(tp, _requests(TRequest, cfg, c))
        for rid in jout:
            np.testing.assert_array_equal(tout[rid], jout[rid])
        runs.append(({rid: v.tolist() for rid, v in jout.items()},
                     dict(te.kv.counters), te.counters["host_syncs"]))
    _SOLO[key] = (np_params, tp, runs)
    return _SOLO[key]


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_serve_matches_solo_engines(name, jax_reports, tmp_path):
    c = CASES[name]
    cfg = _cfg(c["arch"], c["over"])
    jobs, want = [], []
    for cache in c["caches"]:
        np_params, tp, runs = _solo(c, cache)
        want.append(runs)
        jobs.append(dict(arch=c["arch"], smoke=True, overrides=c["over"],
                         compute_dtype="float32", cache_dtype=cache,
                         engine=c["eng"], params=np_params, runs=c["runs"],
                         requests=request_dicts(_requests(TRequest, cfg,
                                                          c))))
    disagg = None
    if c.get("disagg"):
        eng = dict(c["eng"], disaggregate=True, prefill_workers=2)
        te = TEngine(cfg, TCtx(compute_dtype=torch.float32, q_chunk=64,
                               device="cpu"), **eng)
        te.run(tp, _requests(TRequest, cfg, c))
        disagg = (te.transfer_stats(), dict(te.prefill_pool.stats))
        jobs.append(dict(jobs[0], engine=eng, runs=1, cache_dtype=None))
    res = serve_on_mesh(jobs, c["mesh"], "cpu", timeout_s=RANK_TIMEOUT_S,
                        store_dir=str(tmp_path))
    built, report = jax_reports[name]
    d, m = c["mesh"]
    for rank in res:
        for j, cache in enumerate(c["caches"]):
            got = rank[j]
            assert got["report_built"] == built
            assert got["report"] == report
            for i, (tokens, kv, syncs) in enumerate(want[j]):
                run = got["runs"][i]
                assert run["tokens"] == tokens, (cache, i)
                assert run["kv"] == kv  # host state identical to solo
                assert run["counters"]["host_syncs"] == syncs
                assert run["counters"]["host_syncs"] == \
                    run["counters"]["chunks"]
            if c["runs"] > 1:
                assert got["runs"][1]["prefix_hit_rate"] > 0
        first = rank[0]
        h, kv = cfg.n_heads, cfg.n_kv_heads
        assert first["h_local"] == h // m
        if kv % m == 0:
            assert first["kv_mode"] == "split"
            assert first["kv_local"] == kv // m
        else:
            assert first["kv_mode"] == "slice"
            assert any(f"kv_heads={kv}" in ln
                       for ln in first["report"]["dropped_rules"])
        if cfg.n_experts:
            assert first["expert_local"] == cfg.n_experts // d
        if disagg is not None:
            run = rank[-1]["runs"][0]
            assert run["tokens"] == want[0][0][0]
            assert run["transfer"] == disagg[0]
            assert run["transfer"]["transfers"] == c["n"]


def test_other_families_refuse_a_mesh():
    """Only the paged backend (attention and MoE stacks) runs on a mesh:
    the dense and ring caches, the state families and the encoder-decoder
    raise, naming the family."""
    ctx = TCtx(compute_dtype=torch.float32, device="cpu")
    mesh = {"data": 1, "model": 2}
    cases = (("qwen2_0_5b", dict(paged=False), "dense and ring"),
             ("rwkv6_1_6b", {}, "state family"),
             ("jamba_v01_52b", {}, "state family"),
             ("whisper_small", {}, "encoder-decoder"))
    for arch, kw, family in cases:
        with pytest.raises(NotImplementedError, match=family):
            TEngine(get_smoke(arch), ctx, window=32, mesh=mesh, **kw)


@pytest.mark.parametrize("cache", [None, "bfloat16", "int8"])
def test_trash_page_holds_zeros(cache):
    """Padded span slots, speculative writes past the frontier and
    finished slots all write to the trash page 0, in an order the card
    leaves undefined; the writes store zeros, so the page (which the dead
    rows read) is identical on every rank of a mesh, as the replicated
    expert-parallel dispatch needs."""
    c = dict(QWEN, n=5, max_new=7)
    cfg = _cfg(c["arch"], c["over"])
    ctx = TCtx(compute_dtype=torch.float32, q_chunk=64, device="cpu",
               decode_cache_dtype=_torch_dtype(cache))
    engine = TEngine(cfg, ctx, **c["eng"])
    tp = init_params(tapi.model_specs(cfg), seed=0, device="cpu")
    reqs = _requests(TRequest, cfg, c)
    for i, r in enumerate(reqs):
        r.max_new = 3 + 2 * i  # slots finish at different steps
    engine.run(tp, reqs)
    assert engine.counters["prefill_span_calls"] > 0
    for sl, leaves in engine.kv.pages.items():
        for name in ("k", "v"):
            trash = leaves[name][:, 0]
            assert not torch.any(trash != 0), (sl, name)


class RankMesh:
    """What ShardPlan reads of one rank's DeviceMesh, without a group."""

    def __init__(self, shape, coords):
        self.mesh_dim_names = ("data", "model")
        self.shape = tuple(shape)
        self._coords = dict(zip(self.mesh_dim_names, coords))

    def get_local_rank(self, axis):
        return self._coords[axis]

    def get_group(self, axis):
        return None


def test_slice_leaf_takes_full_leaves_and_own_shards_only():
    """``ShardPlan.slice_leaf`` cuts a full leaf to the rank's shard and
    passes a leaf of exactly that shard's shape; any other shape (another
    config's tree, or a shard cut for another mesh) raises."""
    from repro_torch.sharding.axes import BASELINE_RULES
    from repro_torch.sharding.plan import ShardPlan
    cfg = get_smoke("mixtral_8x22b")
    specs = tapi.model_specs(cfg)
    plan = ShardPlan.build(cfg, specs, RankMesh((2, 2), (1, 1)),
                           BASELINE_RULES)
    full = init_params(specs, seed=0, device="cpu")
    wq = full["blocks"]["sl0"]["core"]["wq"]  # (n_blocks, d, h, hd)
    up = full["blocks"]["sl0"]["mlp"]["w_up"]  # (n_blocks, E, d, f)
    cut = plan.slice_leaf("blocks/sl0/core/wq", wq)
    h = cfg.n_heads
    np.testing.assert_array_equal(cut.numpy(), wq[:, :, h // 2:].numpy())
    assert plan.slice_leaf("blocks/sl0/core/wq", cut) is cut
    e = cfg.n_experts
    np.testing.assert_array_equal(
        plan.slice_leaf("blocks/sl0/mlp/w_up", up).numpy(),
        up[:, e // 2:].numpy())
    with pytest.raises(ValueError, match="neither the full"):
        plan.slice_leaf("blocks/sl0/core/wq", wq[:, :, :h // 4])
    with pytest.raises(ValueError, match="neither the full"):
        plan.slice_leaf("blocks/sl0/mlp/w_up", up[:, :1])
