"""MoE serving path of the port against the JAX package, on the CPU: the
grouped dispatch plan, permute and combine, the grouped-GEMM oracle twin
(against ``repro.kernels.ref`` and the Pallas body in interpret mode),
``moe_ffn`` on the mixtral and kimi smoke configs, int8 expert weights
and the router's tie order. Inputs come from numpy seeds.

Tolerances: the plan, the permute, the int8 quantization and the routing
are exact. f32 products at 1e-5 (summation order only), except int8
weights times f32 activations, whose error bound grows with the
contraction length D and the output's size: 4 * D * eps32 * max|out|
(the reference's own fixed 1e-5 case is red for that reason). bf16
outputs within one bf16 step (2^-7 relative)."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke
from repro.kernels import moe_gemm as jgemm
from repro.kernels import ref as jref
from repro.models import moe as jmoe
from repro.models.params import init_params as j_init_params
from repro_torch.kernels import moe_gemm as tgemm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import moe as tmoe
from repro_torch.models.blocks import ModelContext
from repro_torch.models.params import params_from_numpy

jax.config.update("jax_default_matmul_precision", "highest")

EPS32 = float(np.finfo(np.float32).eps)
PLAN_FIELDS = ("row_src", "dest", "block_experts", "counts", "offsets",
               "padded_starts")


def _routing(seed, t, k, e):
    """(T, k) int32 expert ids, distinct per token like top-k."""
    rng = np.random.default_rng(seed)
    return np.argsort(rng.standard_normal((t, e)), axis=1)[:, :k].astype(
        np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


def _params(arch, seed, act=None):
    cfg = get_smoke(arch)
    if act is not None:
        cfg = dataclasses.replace(cfg, mlp_act=act)
    jp = j_init_params(jax.random.key(seed), jmoe.moe_param_specs(cfg))
    jp = jax.tree.map(np.asarray, jp)
    return cfg, jp, params_from_numpy(jp, device="cpu")


# ------------------------------------------------------------ the plan

PLAN_GRID = [(t, k, e, bm) for t, k, e, bm in itertools.product(
    [1, 3, 7, 24], [1, 2], [1, 4, 8, 16], [1, 4, 8, 64]) if k <= e]


@pytest.mark.parametrize("t,k,e,bm", PLAN_GRID)
def test_plan_equals_reference(t, k, e, bm):
    gate_idx = _routing(t * 1000 + e * 10 + bm, t, k, e)
    want = jmoe.grouped_dispatch_plan(jnp.asarray(gate_idx), n_experts=e,
                                      block_m=bm)
    got = tmoe.grouped_dispatch_plan(torch.from_numpy(gate_idx),
                                     n_experts=e, block_m=bm)
    for name in PLAN_FIELDS:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got.padded_rows == want.padded_rows


@pytest.mark.parametrize("case", ["all_to_one", "single_token",
                                  "experts_exceed_assignments"])
def test_plan_degenerate_cases_equal_reference(case):
    if case == "all_to_one":  # every assignment on expert 2 (k = 1)
        gate_idx, e = np.full((9, 1), 2, np.int32), 4
    elif case == "single_token":
        gate_idx, e = np.array([[3, 0]], np.int32), 4
    else:  # e > t * k: most experts get nothing
        gate_idx, e = _routing(7, 3, 2, 16), 16
    for bm in (1, 8):
        want = jmoe.grouped_dispatch_plan(jnp.asarray(gate_idx),
                                          n_experts=e, block_m=bm)
        got = tmoe.grouped_dispatch_plan(torch.from_numpy(gate_idx),
                                         n_experts=e, block_m=bm)
        for name in PLAN_FIELDS:
            np.testing.assert_array_equal(
                getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                err_msg=f"{case} bm={bm} {name}")


@pytest.mark.parametrize("t,k,e", [(5, 2, 4), (1, 2, 8), (12, 3, 8)])
def test_permute_and_combine_equal_reference(t, k, e):
    rng = np.random.default_rng(t + k + e)
    gate_idx = _routing(t + 31, t, k, e)
    xt = rng.standard_normal((t, 16)).astype(np.float32)
    gate_w = rng.random((t, k)).astype(np.float32)
    jplan = jmoe.grouped_dispatch_plan(jnp.asarray(gate_idx), n_experts=e,
                                       block_m=4)
    tplan = tmoe.grouped_dispatch_plan(torch.from_numpy(gate_idx),
                                       n_experts=e, block_m=4)
    jxs = jmoe.grouped_permute(jnp.asarray(xt), jplan, jnp.float32)
    txs = tmoe.grouped_permute(torch.from_numpy(xt), tplan, torch.float32)
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    y = rng.standard_normal(txs.shape).astype(np.float32)
    want = jmoe.grouped_combine(jnp.asarray(y), jplan, jnp.asarray(gate_w),
                                t, k)
    got = tmoe.grouped_combine(torch.from_numpy(y), tplan,
                               torch.from_numpy(gate_w), t, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------- the GEMM oracle twin

GIDS = np.array([0, 0, 1, -1, 2, 3, 3, -1], np.int32)


def _gemm_case(dtype, with_scale, m=64, d=32, f=48, e=4, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    if with_scale:
        w = np.clip(np.round(rng.standard_normal((e, d, f)) * 40), -127,
                    127).astype(np.int8)
        scale = (np.abs(rng.standard_normal(e)) + 0.1).astype(np.float32)
    else:
        w, scale = rng.standard_normal((e, d, f)).astype(np.float32), None
    jx = jnp.asarray(x, dtype)
    jw = jnp.asarray(w) if with_scale else jnp.asarray(w, dtype)
    js = None if scale is None else jnp.asarray(scale)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tx = torch.from_numpy(np.asarray(jx, np.float32)).to(tdt)
    tw = torch.from_numpy(np.asarray(jw)) if with_scale else \
        torch.from_numpy(np.asarray(jw, np.float32)).to(tdt)
    ts = None if scale is None else torch.from_numpy(scale)
    return (jx, jw, js), (tx, tw, ts)


def _gemm_tol(dtype, want, d):
    if dtype == jnp.bfloat16:
        return dict(rtol=2 ** -7, atol=2 ** -7 * float(np.abs(want).max()))
    return dict(rtol=0, atol=max(1e-5, 4 * d * EPS32
                                 * float(np.abs(want).max())))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("with_scale", [False, True])
def test_grouped_matmul_twin_matches_ref_and_interpret(dtype, with_scale):
    (jx, jw, js), (tx, tw, ts) = _gemm_case(dtype, with_scale)
    jg, tg = jnp.asarray(GIDS), torch.from_numpy(GIDS)
    want = np.asarray(jref.grouped_matmul_ref(jx, jw, jg, w_scale=js),
                      np.float32)
    interp = np.asarray(jgemm.grouped_matmul(jx, jw, jg, w_scale=js,
                                             interpret=True, block_f=16),
                        np.float32)
    for got in (tref.grouped_matmul_ref(tx, tw, tg, w_scale=ts),
                tgemm.grouped_matmul(tx, tw, tg, w_scale=ts),
                tops.grouped_matmul(tx, tw, tg, w_scale=ts, impl="ref")):
        assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
        tol = _gemm_tol(dtype, want, tx.shape[1])
        np.testing.assert_allclose(_np(got), want, **tol)
        np.testing.assert_allclose(_np(got), interp, **tol)
        # sentinel tiles are exactly zero
        tiles = _np(got).reshape(len(GIDS), -1, want.shape[1])
        np.testing.assert_array_equal(tiles[GIDS < 0], 0.0)


@pytest.mark.parametrize("gids", [[-1, -1, -1], [2, 2, 2], [1, 0, 5]])
def test_grouped_matmul_twin_edge_plans(gids):
    """An all -1 plan, one expert throughout, and an id past the last
    expert (the reference's gather clamps it)."""
    rng = np.random.default_rng(3)
    gids = np.asarray(gids, np.int32)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    w = rng.standard_normal((3, 8, 5)).astype(np.float32)
    want = np.asarray(jref.grouped_matmul_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(gids)))
    got = tref.grouped_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(gids))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cuda_impl_refuses_cpu_tensors_and_mesh():
    (_, _, _), (tx, tw, _) = _gemm_case(jnp.float32, False)
    tg = torch.from_numpy(GIDS)
    with pytest.raises(ValueError, match="CUDA"):
        tops.grouped_matmul(tx, tw, tg, impl="cuda")
    # a mesh whose expert axis is 1 runs the plain call; experts that do
    # not split the axis raise (the expert-parallel run over gloo ranks
    # is in tests/test_torch_sharding.py)
    want = tops.grouped_matmul(tx, tw, tg, impl="ref")
    got = tops.grouped_matmul(tx, tw, tg, impl="ref",
                              mesh={"data": 1, "model": 4})
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="do not split"):
        tops.grouped_matmul(tx, tw, tg, impl="ref", mesh={"data": 2},
                            n_experts=tw.shape[0] + 1)
    with pytest.raises(ValueError, match="impl"):
        tops.grouped_matmul(tx, tw, tg, impl="triton")
    with pytest.raises(ValueError, match="CUDA"):
        tgemm._check(tx, tw, tg, None)


# ------------------------------------------------------------- moe_ffn


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "kimi_k2_1t_a32b"])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_moe_ffn_grouped_matches_reference(arch, act):
    cfg, jp, tp = _params(arch, 3, act)
    x = np.random.default_rng(21).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32)
    want, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), cfg, jnp.float32,
                              dispatch="grouped", impl="ref")
    got, taux = tmoe.moe_ffn(tp, torch.from_numpy(x), cfg, torch.float32,
                             dispatch="grouped", impl="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert sorted(taux) == sorted(jaux)
    for name in jaux:
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   rtol=1e-5)
    # the capacity-dropless path computes the same function
    cap, caux = tmoe.moe_ffn(tp, torch.from_numpy(x), cfg, torch.float32,
                             dropless=True)
    jcap, _ = jmoe.moe_ffn(jp, jnp.asarray(x), cfg, jnp.float32,
                           dropless=True)
    np.testing.assert_allclose(cap.numpy(), got.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(cap.numpy(), np.asarray(jcap), rtol=1e-5,
                               atol=1e-5)
    for name in caux:
        np.testing.assert_allclose(float(caux[name]), float(taux[name]),
                                   rtol=1e-6)


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "kimi_k2_1t_a32b"])
def test_moe_ffn_is_invariant_to_block_m_and_chunking(arch):
    cfg, _, tp = _params(arch, 4)
    x = torch.from_numpy(np.random.default_rng(22).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    base, _ = tmoe.moe_ffn(tp, x, cfg, torch.float32, dispatch="grouped",
                           impl="ref", block_m=8)
    for bm in (1, 64):
        got, _ = tmoe.moe_ffn(tp, x, cfg, torch.float32, dispatch="grouped",
                              impl="ref", block_m=bm)
        np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=1e-6,
                                   atol=1e-6)
    # 16 tokens in 4-token chunks; the reference scans the same chunks
    got, aux = tmoe.moe_ffn(tp, x, cfg, torch.float32, chunk_tokens=4,
                            dispatch="grouped", impl="ref")
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=1e-6,
                               atol=1e-6)
    jp = jax.tree.map(lambda t: np.asarray(t.numpy()), tp)
    want, jaux = jmoe.moe_ffn(jp, jnp.asarray(x.numpy()), cfg, jnp.float32,
                              chunk_tokens=4, dispatch="grouped",
                              impl="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for name in jaux:
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]),
                                   rtol=1e-5)
    # a 1-token decode dispatch equals its row of the 16-token one
    step, _ = tmoe.moe_ffn(tp, x[:1, 5:6], cfg, torch.float32,
                           dispatch="grouped", impl="ref")
    np.testing.assert_allclose(step[0, 0].numpy(), base[0, 5].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_quantize_moe_params_is_exact():
    cfg, jp, tp = _params("mixtral_8x22b", 5)
    jq = jmoe.quantize_moe_params(jax.tree.map(jnp.asarray, jp))
    tq = tmoe.quantize_moe_params(tp)
    assert sorted(jq) == sorted(tq)
    for name in jq:
        assert tuple(tq[name].shape) == jq[name].shape, name
        if name.endswith("_scale"):
            assert tq[name].dtype == torch.float32
        np.testing.assert_array_equal(_np(tq[name]),
                                      np.asarray(jq[name], np.float32)
                                      if name.endswith("_scale")
                                      else np.asarray(jq[name]))
    assert tq["w_up"].dtype == torch.int8
    assert torch.equal(tq["router"], tp["router"])


def test_moe_ffn_int8_experts_match_reference():
    cfg, jp, tp = _params("mixtral_8x22b", 6)
    jq = jmoe.quantize_moe_params(jax.tree.map(jnp.asarray, jp))
    tq = tmoe.quantize_moe_params(tp)
    x = np.random.default_rng(23).standard_normal(
        (1, 7, cfg.d_model)).astype(np.float32)
    want, _ = jmoe.moe_ffn(jq, jnp.asarray(x), cfg, jnp.float32,
                           dispatch="grouped", impl="ref")
    got, _ = tmoe.moe_ffn(tq, torch.from_numpy(x), cfg, torch.float32,
                          dispatch="grouped", impl="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # post-dot dequant (grouped) == pre-dot dequant (capacity)
    cap, _ = tmoe.moe_ffn(tq, torch.from_numpy(x), cfg, torch.float32,
                          dropless=True)
    np.testing.assert_allclose(cap.numpy(), got.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_router_ties_go_to_the_lower_expert():
    cfg, jp, tp = _params("kimi_k2_1t_a32b", 7)
    k, e = cfg.experts_per_token, cfg.n_experts
    x = np.random.default_rng(24).standard_normal(
        (5, cfg.d_model)).astype(np.float32)
    # a zero router: every probability ties, so top-k picks 0 .. k-1
    tp0 = dict(tp, router=torch.zeros_like(tp["router"]))
    _, _, gw, gi = tmoe._route(tp0, torch.from_numpy(x), torch.float32, k)
    np.testing.assert_array_equal(gi.numpy(), np.tile(np.arange(k), (5, 1)))
    np.testing.assert_allclose(gw.numpy(), np.full((5, k), 1.0 / k))
    # pairwise ties among distinct values: columns 2j and 2j+1 equal
    router = np.repeat(np.random.default_rng(25).standard_normal(
        (cfg.d_model, e // 2)).astype(np.float32), 2, axis=1)
    _, _, jgw, jgi = jmoe._route({"router": jnp.asarray(router)},
                                 jnp.asarray(x), jnp.float32, k)
    _, _, tgw, tgi = tmoe._route({"router": torch.from_numpy(router)},
                                 torch.from_numpy(x), torch.float32, k)
    np.testing.assert_array_equal(tgi.numpy(), np.asarray(jgi))
    np.testing.assert_allclose(tgw.numpy(), np.asarray(jgw), rtol=1e-6)
    assert (tgi.numpy()[:, 0] % 2 == 0).all()


def test_context_derives_the_gemm_impl():
    ctx = ModelContext(compute_dtype=torch.float32, device="cpu")
    assert ctx.moe_kwargs() == {"dispatch": "grouped", "impl": "ref"}
    ctx = ModelContext(compute_dtype=torch.float32, device="cpu",
                       moe_impl="cuda")
    assert ctx.moe_kwargs()["impl"] == "cuda"
    ctx = ModelContext(compute_dtype=torch.float32, device="cpu",
                       moe_dispatch="capacity")
    assert ctx.moe_kwargs() == {"dropless": True}
    with pytest.raises(ValueError):
        ModelContext(device="cpu", moe_dispatch="dense")
