"""Encoder-decoder serving (Whisper) of the port against the JAX package.

* The spec tree (paths, shapes, logical axes) equals the reference's and
  the weight bridge carries JAX-initialised params across.
* ``encode``, ``encdec_prefill`` (logits and the ring and cross caches)
  and ``encdec_decode_step`` against JAX on whisper smoke: logits rtol
  2e-5, caches 1e-5; the ring wraps when the decode passes the window.
* Attention with keys of another length than the queries (the cross
  attention): the port's q-chunked plain path, its kernel route through
  ``_FlashAttention`` (the oracle standing in for the kernel on the CPU),
  the flash oracle and the kernel's plain version against JAX's
  ``full_attention`` (rtol 1e-5); causal or windowed masks refuse
  S_k != S_q.
* ``ServeEngine`` with ``enc_feats`` extras against the JAX engine:
  greedy tokens, scheduler stats and every counter equal; ``generate``
  and ``generate_pertoken`` with an ``enc_feats`` batch key; the serve
  launcher gives trace requests their features.

fp32 with ``jax_default_matmul_precision="highest"``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.configs.registry import get_smoke as j_get_smoke
from repro.models import api as japi
from repro.models import encdec as jencdec
from repro.models.attention import full_attention as j_full_attention
from repro.models.blocks import ModelContext as JCtx
from repro.models.params import init_params as j_init_params
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.models.blocks import ModelContext as TCtx
from repro_torch.models.params import params_from_numpy, tree_items
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.scheduler import Request as TRequest

jax.config.update("jax_default_matmul_precision", "highest")

COUNTERS = ("prefills", "chunks", "decode_steps", "host_syncs",
            "pertoken_steps", "pages_trimmed", "suffix_prefills",
            "prompt_tokens", "cached_prompt_tokens", "spec_steps",
            "spec_tokens", "prefill_span_calls", "span_prefill_compiles",
            "span_prefill_dense_compiles")


@pytest.fixture(scope="module")
def whisper():
    cfg = j_get_smoke("whisper_small")
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


def _feats(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.encoder_seq, cfg.d_model),
                               dtype=np.float32) * 0.1


def _jax_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: not isinstance(x, dict))[0]:
        out["/".join(str(p.key) for p in path)] = leaf
    return out


def test_configs_and_spec_tree_are_the_reference_s(whisper):
    import dataclasses
    for arch in ("whisper_small", "qwen2_vl_7b"):
        assert dataclasses.asdict(registry.get_arch(arch)) == \
            dataclasses.asdict(j_get_arch(arch))
        assert dataclasses.asdict(registry.get_smoke(arch)) == \
            dataclasses.asdict(j_get_smoke(arch))
    cfg = registry.get_arch("whisper_small")
    assert (cfg.n_layers, cfg.encoder_layers, cfg.d_model, cfg.n_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.encoder_seq) == (12, 12, 768, 12, 64, 3072, 51865, 1500)
    cfg = registry.get_arch("qwen2_vl_7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.mrope_sections) == \
        (28, 3584, 28, 4, 128, 18944, 152064, (16, 24, 24))
    for c in (whisper[0], registry.get_arch("whisper_small")):
        jspecs = _jax_leaves(japi.model_specs(c))
        tspecs = dict(tree_items(tapi.model_specs(c)))
        assert sorted(jspecs) == sorted(tspecs)
        for path, spec in tspecs.items():
            assert spec.shape == jspecs[path].shape, path
            assert spec.logical == jspecs[path].logical, path
    assert tspecs["dec_pos"].shape[0] == tencdec.MAX_DEC_POSITIONS


def test_encode_prefill_and_decode_match_jax(whisper):
    """5-token prompts into a 7-slot ring: four decode steps wrap it."""
    cfg, jp, tp = whisper
    jctx, tctx = _ctxs()
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    feats = _feats(cfg, 2, 2)
    enc_j = jencdec.encode(jp, jnp.asarray(feats), cfg, jctx)
    enc_t = tencdec.encode(tp, torch.from_numpy(feats), cfg, tctx)
    np.testing.assert_allclose(_np(enc_t), _np(enc_j), rtol=1e-5,
                               atol=1e-5)
    jlog, jc = japi.prefill_fn(jp, {"tokens": jnp.asarray(tokens),
                                    "enc_feats": jnp.asarray(feats)},
                               cfg, jctx, window=7)
    tlog, tc = tapi.prefill_fn(tp, {"tokens": torch.from_numpy(tokens),
                                    "enc_feats": torch.from_numpy(feats)},
                               cfg, tctx, window=7)
    assert tlog.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    spec = tapi.cache_spec(cfg, 2, 7, tctx)["blocks"]
    for name, arr in jc["blocks"].items():
        assert tuple(tc["blocks"][name].shape) == spec[name].shape
        np.testing.assert_allclose(_np(tc["blocks"][name]), _np(arr),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    for step in range(4):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jlog, jc = japi.decode_fn(jp, jnp.asarray(tok), jc, cfg, jctx)
        tlog, tc = tapi.decode_fn(tp, torch.from_numpy(tok), tc, cfg, tctx)
        np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=2e-5,
                                   atol=2e-5, err_msg=f"step {step}")
    np.testing.assert_array_equal(tc["pos"].numpy(), [9, 9])
    for name, arr in jc["blocks"].items():
        np.testing.assert_allclose(_np(tc["blocks"][name]), _np(arr),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        tapi.prefill_fn(tp, {"tokens": torch.from_numpy(tokens)}, cfg, tctx,
                        window=7, logits_at=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="decoder-only"):
        tapi.decode_span_fn(tp, torch.from_numpy(tokens), tc, cfg, tctx)


@pytest.mark.parametrize("sq,sk,q_chunk", [(5, 12, 8), (9, 1500, 4),
                                           (16, 7, 4)])
def test_attention_with_another_key_length_matches_jax(whisper, sq, sk,
                                                       q_chunk):
    cfg = whisper[0]
    rng = np.random.default_rng(sq + sk)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, sk, 4, 16)).astype(np.float32)
    v = rng.standard_normal((2, sk, 4, 16)).astype(np.float32)
    want = np.asarray(j_full_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg, q_chunk=q_chunk,
        attn_type="bidirectional"))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = {
        "chunked": tattn._chunked_attention(tq, tk, tv, "bidirectional",
                                            None, q_chunk),
        "full ref": tattn.full_attention(tq, tk, tv, cfg, q_chunk=q_chunk,
                                         attn_type="bidirectional"),
        "kernel route": tattn._FlashAttention.apply(
            tq, tk, tv, "bidirectional", None, q_chunk, "ref")}
    fold = lambda x: x.transpose(1, 2).reshape(-1, x.shape[1], 16)
    for name, fn in (("oracle", tref.flash_attention_ref),
                     ("plain", tflash.flash_attention_plain),
                     ("wrapper", tflash.flash_attention)):
        out = fn(fold(tq), fold(tk), fold(tv), causal=False)
        got[name] = out.reshape(2, 4, sq, 16).transpose(1, 2)
    for name, out in got.items():
        assert tuple(out.shape) == (2, sq, 4, 16)
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    for causal, window in ((True, None), (False, 3)):
        with pytest.raises(ValueError, match="one sequence"):
            tflash.flash_attention(fold(tq), fold(tk), fold(tv),
                                   causal=causal, window=window)
        with pytest.raises(ValueError, match="one sequence"):
            kops.flash_attention(fold(tq), fold(tk), fold(tv), impl="ref",
                                 causal=causal, window=window)


def _requests(cfg, cls, seed):
    rng = np.random.default_rng(seed)
    feats = _feats(cfg, 5, seed + 1)
    reqs = []
    for i in range(5):
        r = cls(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                           int(rng.integers(2, 9))),
                max_new=int(rng.integers(4, 9)))
        r.extras["enc_feats"] = feats[i:i + 1]
        reqs.append(r)
    return reqs


def test_engine_with_enc_feats_matches_jax(whisper):
    cfg, jp, tp = whisper
    jctx, tctx = _ctxs()
    kw = dict(window=20, max_batch=2, chunk=3)
    je, te = JEngine(cfg, jctx, **kw), TEngine(cfg, tctx, **kw)
    assert not te.paged and not te.chunk_prefill and not te.bucket_prefill
    jout = je.run(jp, _requests(cfg, JRequest, 3))
    tout = te.run(tp, _requests(cfg, TRequest, 3))
    assert sorted(tout) == sorted(jout) == list(range(5))
    for rid in jout:
        np.testing.assert_array_equal(tout[rid], jout[rid],
                                      err_msg=f"rid {rid}")
    assert te.scheduler.stats == je.scheduler.stats
    for name in COUNTERS:
        assert te.counters[name] == je.counters[name], name


def test_generate_with_enc_feats_matches_jax(whisper):
    cfg, jp, tp = whisper
    jctx, tctx = _ctxs()
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 6)).astype(
        np.int32), "enc_feats": _feats(cfg, 2, 5)}
    kw = dict(window=16, max_batch=2, chunk=4)
    je, te = JEngine(cfg, jctx, **kw), TEngine(cfg, tctx, **kw)
    want = np.asarray(je.generate_pertoken(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, max_new=6))
    np.testing.assert_array_equal(
        te.generate_pertoken(tp, batch, max_new=6).numpy(), want)
    np.testing.assert_array_equal(te.generate(tp, batch, max_new=6).numpy(),
                                  np.asarray(je.generate(
                                      jp, {k: jnp.asarray(v)
                                           for k, v in batch.items()},
                                      max_new=6)))
    np.testing.assert_array_equal(te.generate(tp, batch, max_new=6).numpy(),
                                  want)


def test_serve_launcher_gives_trace_requests_their_features(capsys):
    launch_serve.main(["--arch", "whisper_small", "--smoke", "--trace", "3",
                       "--max-new", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[dense on cpu] 3 requests" in out
    launch_serve.main(["--arch", "whisper_small", "--smoke", "--batch", "2",
                       "--prompt-len", "5", "--max-new", "4",
                       "--device", "cpu"])
    assert "generated 8 tokens" in capsys.readouterr().out
