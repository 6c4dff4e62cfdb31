"""Weight bridge, initialization and elementary ops of the port against
the JAX package: the same numpy inputs through both sides."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.configs.registry import get_smoke as j_get_smoke
from repro.models import api as japi
from repro.models import ops as jops
from repro.models.blocks import paged_quantize as j_paged_quantize
from repro.models.params import init_params as j_init_params
from repro_torch.configs import registry
from repro_torch.models import api as tapi
from repro_torch.models import ops as tops
from repro_torch.models.blocks import paged_dequantize, paged_quantize
from repro_torch.models.params import (ParamSpec, init_params,
                                       params_from_numpy, tree_items)


def _jax_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: not isinstance(x, dict))[0]:
        out["/".join(str(p.key) for p in path)] = leaf
    return out


@pytest.fixture(scope="module")
def smoke():
    cfg = registry.get_smoke("qwen2_0_5b")
    jp = j_init_params(jax.random.key(0), japi.model_specs(cfg))
    return cfg, jp


def test_configs_are_copies_of_the_reference():
    for arch in ("qwen2_0_5b", "mixtral_8x22b", "kimi_k2_1t_a32b",
                 "rwkv6_1_6b", "jamba_v01_52b"):
        for mine, ref in ((registry.get_arch(arch), j_get_arch(arch)),
                          (registry.get_smoke(arch.replace("_", "-")),
                           j_get_smoke(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    cfg = registry.get_arch("qwen2_0_5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size) == \
        (24, 896, 14, 2, 64, 4864, 151936)
    cfg = registry.get_arch("mixtral_8x22b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.n_experts, cfg.experts_per_token, cfg.sliding_window,
            cfg.tie_embeddings) == \
        (56, 6144, 48, 8, 128, 16384, 32768, 8, 2, 4096, False)
    cfg = registry.get_arch("rwkv6_1_6b")
    assert (cfg.n_layers, cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim,
            cfg.d_ff, cfg.vocab_size, set(cfg.sublayer_kinds())) == \
        (24, 2048, 32, 64, 7168, 65536, {"rwkv"})
    cfg = registry.get_arch("jamba_v01_52b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.n_experts, cfg.experts_per_token, cfg.d_inner,
            cfg.ssm_state_dim, cfg.block_len, cfg.sublayer_kinds(),
            cfg.moe_mask()) == \
        (32, 4096, 32, 8, 128, 14336, 65536, 16, 2, 8192, 16, 8,
         ("mamba",) * 4 + ("attn",) + ("mamba",) * 3, (False, True) * 4)
    # every architecture of the reference resolves, to the same numbers
    for arch in registry.ARCH_IDS:
        for mine, ref in ((registry.get_arch(arch), j_get_arch(arch)),
                          (registry.get_smoke(arch), j_get_smoke(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref), arch
    with pytest.raises(KeyError):
        registry.get_arch("gpt5")


def test_spec_tree_matches_reference(smoke):
    """Same paths, shapes and stacked leading n_blocks axis."""
    for cfg in (smoke[0], registry.get_arch("qwen2_0_5b")):
        jspecs = _jax_leaves(japi.model_specs(cfg))
        tspecs = dict(tree_items(tapi.model_specs(cfg)))
        assert sorted(jspecs) == sorted(tspecs)
        for path, spec in tspecs.items():
            assert isinstance(spec, ParamSpec)
            assert spec.shape == jspecs[path].shape, path
            assert spec.logical == jspecs[path].logical, path
        assert tspecs["blocks/sl0/core/wq"].shape[0] == cfg.n_blocks


def test_weight_bridge_is_exact(smoke):
    cfg, jp = smoke
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jl = _jax_leaves(jp)
    tl = dict(tree_items(tp))
    assert sorted(jl) == sorted(tl)
    for path, t in tl.items():
        assert tuple(t.shape) == jl[path].shape, path
        np.testing.assert_array_equal(t.numpy(), np.asarray(jl[path]),
                                      err_msg=path)
    bf = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                           dtype=torch.bfloat16)
    assert bf["embed"].dtype == torch.bfloat16


def test_init_params_laws_and_determinism(smoke):
    cfg = smoke[0]
    specs = tapi.model_specs(cfg)
    a = init_params(specs, seed=3, device="cpu")
    b = init_params(specs, seed=3, device="cpu")
    c = init_params(specs, seed=4, device="cpu")
    for (path, x), (_, y), (_, z) in zip(tree_items(a), tree_items(b),
                                         tree_items(c)):
        assert torch.equal(x, y), path
        assert x.dtype == torch.float32
    blocks = a["blocks"]["sl0"]
    assert torch.all(blocks["ln1"] == 1) and torch.all(a["final_norm"] == 1)
    assert torch.all(blocks["core"]["bq"] == 0)
    std = float(a["embed"].std())
    assert 0.018 < std < 0.022, std  # normal(0.02) over 211 x 48 draws
    assert not torch.equal(a["embed"], c["embed"])
    # layers draw from one stacked leaf, so they differ from each other
    assert not torch.equal(blocks["core"]["wq"][0], blocks["core"]["wq"][1])
    half = init_params(specs, seed=3, dtype=torch.bfloat16, device="cpu")
    assert half["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_quantize_is_byte_exact(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 7, 2, 64)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0  # an all-zero head: the 1e-8 scale floor
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = j_paged_quantize(jx, jnp.int8)
    tq, ts = paged_quantize(tx, torch.int8)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js, np.float32))
    deq = paged_dequantize(tq, ts, torch.float32)
    np.testing.assert_allclose(deq.numpy(), x, atol=float(ts.max()))
    same, none = paged_quantize(tx, tx.dtype)
    assert none is None and torch.equal(same, tx)


def test_model_ops_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    scale = rng.standard_normal(8).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    pairs = [
        (tops.rms_norm(tx, torch.from_numpy(scale)),
         jops.rms_norm(jx, jnp.asarray(scale))),
        (tops.swiglu(tx, tx * 2), jops.swiglu(jx, jx * 2)),
        (tops.gelu(tx), jops.gelu(jx)),
        (tops.apply_rope(tx, torch.from_numpy(pos), 1e6),
         jops.apply_rope(jx, jnp.asarray(pos), 1e6)),
        (tops.rope_freqs(64, 1e4), jops.rope_freqs(64, 1e4)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def test_embed_lookup_wraps_negative_ids_like_jnp_take():
    """Draft misses (-1) embed as row V-1 in the reference; ids >= V are
    NaN rows there. F.embedding would refuse both."""
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([[-1, 0, 3, -4, 4]], np.int32)
    got = tops.embed_lookup(torch.from_numpy(table), torch.from_numpy(ids),
                            torch.float32)
    want = jops.embed_lookup(jnp.asarray(table), jnp.asarray(ids),
                             jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.isnan(got[0, 4]).all()


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "kimi_k2_1t_a32b"])
def test_moe_spec_tree_matches_reference(arch):
    """Expert leaves (n_blocks, E, D, F), the router and the untied head
    have the reference's paths, shapes and logical axes."""
    for cfg in (registry.get_smoke(arch), registry.get_arch(arch)):
        jspecs = _jax_leaves(japi.model_specs(cfg))
        tspecs = dict(tree_items(tapi.model_specs(cfg)))
        assert sorted(jspecs) == sorted(tspecs)
        for path, spec in tspecs.items():
            assert spec.shape == jspecs[path].shape, path
            assert spec.logical == jspecs[path].logical, path
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        assert tspecs["blocks/sl0/mlp/w_up"].shape == (cfg.n_blocks, e, d, f)
        assert tspecs["blocks/sl0/mlp/w_down"].shape == \
            (cfg.n_blocks, e, f, d)
        assert "lm_head" in tspecs


def test_init_params_draws_expert_leaves():
    cfg = registry.get_smoke("mixtral_8x22b")
    a = init_params(tapi.model_specs(cfg), seed=5, device="cpu")
    mlp = a["blocks"]["sl0"]["mlp"]
    assert tuple(mlp["w_gate"].shape) == (cfg.n_blocks, cfg.n_experts,
                                          cfg.d_model, cfg.d_ff)
    # every expert and every leaf draws its own values
    assert not torch.equal(mlp["w_up"][0, 0], mlp["w_up"][0, 1])
    assert not torch.equal(mlp["w_up"][0], mlp["w_gate"][0])
    assert 0.018 < float(mlp["w_up"].std()) < 0.022
    b = init_params(tapi.model_specs(cfg), seed=5, device="cpu")
    assert torch.equal(mlp["w_down"], b["blocks"]["sl0"]["mlp"]["w_down"])


def test_weight_bridge_carries_expert_leaves_and_int8():
    """Stacked (n_blocks, E, D, F) expert leaves cross exactly; int8
    experts keep int8 and their f32 scales keep f32 under a bf16 cast."""
    from repro.models.moe import quantize_moe_params as j_quantize
    cfg = registry.get_smoke("mixtral_8x22b")
    jp = j_init_params(jax.random.key(1), japi.model_specs(cfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jl = _jax_leaves(jp)
    for path, t in tree_items(tp):
        np.testing.assert_array_equal(t.numpy(), np.asarray(jl[path]),
                                      err_msg=path)
    assert tuple(tp["blocks"]["sl0"]["mlp"]["w_up"].shape) == (
        cfg.n_blocks, cfg.n_experts, cfg.d_model, cfg.d_ff)
    layer = jax.tree.map(lambda a: a[0], jp["blocks"]["sl0"]["mlp"])
    jq = jax.tree.map(np.asarray, j_quantize(layer))
    tq = params_from_numpy(jq, device="cpu", dtype=torch.bfloat16)
    assert tq["w_up"].dtype == torch.int8
    assert tq["w_up_scale"].dtype == torch.float32
    assert tq["router"].dtype == torch.bfloat16
    for name in ("w_up", "w_gate", "w_down", "w_up_scale"):
        np.testing.assert_array_equal(tq[name].numpy(), jq[name])


@pytest.mark.parametrize("arch", ["rwkv6_1_6b", "jamba_v01_52b"])
def test_state_family_spec_tree_and_bridge(arch):
    """Mamba and RWKV leaves (a_log, dt_bias, the (5, D) mix, u_bonus)
    have the reference's paths, shapes and logical axes at smoke and full
    size, and cross the weight bridge exactly."""
    for cfg in (registry.get_smoke(arch), registry.get_arch(arch)):
        jspecs = _jax_leaves(japi.model_specs(cfg))
        tspecs = dict(tree_items(tapi.model_specs(cfg)))
        assert sorted(jspecs) == sorted(tspecs)
        for path, spec in tspecs.items():
            assert spec.shape == jspecs[path].shape, path
            assert spec.logical == jspecs[path].logical, path
    cfg = registry.get_smoke(arch)
    jp = j_init_params(jax.random.key(2), japi.model_specs(cfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jl = _jax_leaves(jp)
    for path, t in tree_items(tp):
        np.testing.assert_array_equal(t.numpy(), np.asarray(jl[path]),
                                      err_msg=path)
    core = tp["blocks"]["sl0"]["core"]
    if arch == "rwkv6_1_6b":
        assert tuple(core["mix"].shape) == (cfg.n_blocks, 5, cfg.d_model)
    else:
        # the S4D-real init is deterministic: the port's own init equals it
        mine = init_params(tapi.model_specs(cfg), seed=0, device="cpu")
        np.testing.assert_allclose(
            mine["blocks"]["sl0"]["core"]["a_log"].numpy(),
            core["a_log"].numpy(), rtol=1e-6)
