"""Training through the encoder-decoder (Whisper) and M-RoPE (Qwen2-VL)
stacks on the port, against the JAX package on the CPU.

* ``api.loss_fn`` and its gradient per leaf against
  ``jax.value_and_grad(api.loss_fn)`` on whisper smoke (with and without
  ``loss_mask``) and on qwen2-vl smoke with image-grid M-RoPE rows, same
  params through ``params_from_numpy``: loss rtol 2e-5, each gradient leaf
  within 1e-4 of its largest entry (``test_torch_train.py``'s limits).
  Whisper's key biases have an exact gradient of 0 (no rotary positions:
  a key bias moves every score of a row by the same amount, which the
  softmax cancels), so both sides are held below 1e-4 of the same layer's
  key-weight gradient instead. The image-grid rows change the loss
  against text rows.
* Cross attention (bidirectional, S_q != S_k) through ``_FlashAttention``
  with ``impl="ref"`` standing in for the kernel: output and the three
  gradients against ``jax.grad`` of the reference's ``full_attention``.
* For both archs: a 5-step ``make_train_step`` trajectory against the
  reference's (rtol 1e-4 on step 0, 1e-3 after, as
  ``test_torch_state_train.py``), a failure replay bit-identical to the
  uninterrupted run, two microbatches against one (f32 rounding), and
  the launcher on ``--device cpu``.

fp32 with ``jax_default_matmul_precision="highest"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as j_get_smoke
from repro.models import api as japi
from repro.models.attention import full_attention as j_full_attention
from repro.models.blocks import ModelContext as JCtx
from repro.models.params import init_params as j_init_params
from repro.optim import optimizers as jopt
from repro.train.step import TrainSettings as JSettings
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs.registry import get_smoke
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.launch import train as train_launch
from repro_torch.launch.train import build_trainer
from repro_torch.models import api as tapi
from repro_torch.models.attention import _FlashAttention
from repro_torch.models.blocks import ModelContext
from repro_torch.models.params import params_from_numpy, tree_items
from repro_torch.optim import optimizers as topt
from repro_torch.train.step import TrainSettings, make_train_step
from test_torch_mrope import vl_positions

jax.config.update("jax_default_matmul_precision", "highest")

ARCHS = ("whisper_small", "qwen2_vl_7b")
JCTX = JCtx(compute_dtype=jnp.float32, q_chunk=16)
TCTX = ModelContext(compute_dtype=torch.float32, q_chunk=16, device="cpu")

_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        cfg = j_get_smoke(arch)
        jp = j_init_params(jax.random.key(0), japi.model_specs(cfg))
        _MODELS[arch] = (cfg, jp, jax.tree.map(np.asarray, jp))
    return _MODELS[arch]


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in flat}


def _batch(cfg, b=2, s=32, seed=0):
    """Tokens and labels; Whisper's frames, or Qwen2-VL's image-grid rows
    (a 3 x 3 patch grid after 4 text tokens), from one numpy seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encoder_decoder:
        batch["enc_feats"] = (rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32)
    else:
        batch["positions"] = vl_positions(s, prefix=4, grid=3, b=b)
    return batch


def _zero_exactly(cfg, path):
    """Whisper's key biases: no rotary positions, so the softmax cancels
    them and their exact gradient is 0."""
    return cfg.is_encoder_decoder and path.endswith("/bk")


def _loss_and_grads(cfg, jp, npp, batch):
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: japi.loss_fn(p, b, cfg, JCTX), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_numpy(npp, device="cpu")
    for _, leaf in tree_items(tp):
        leaf.requires_grad_()
    tl, tm = tapi.loss_fn(tp, {k: torch.from_numpy(v)
                               for k, v in batch.items()}, cfg, TCTX)
    tl.backward()
    return jm, _jax_paths(jg), tm, tp


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, masked):
    cfg, jp, npp = _model(arch)
    batch = _batch(cfg)
    if masked:
        batch["loss_mask"] = (np.arange(32)[None, :]
                              < np.array([[20], [9]])).astype(np.float32)
    jm, want, tm, tp = _loss_and_grads(cfg, jp, npp, batch)
    assert set(tm) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=2e-5, atol=1e-7, err_msg=key)
    assert float(tm["tokens"]) == (29.0 if masked else 64.0)
    assert {path for path, _ in tree_items(tp)} == set(want)
    for path, leaf in tree_items(tp):
        got, w = leaf.grad.numpy(), want[path]
        if _zero_exactly(cfg, path):
            scale = np.abs(want[path[:-2] + "wk"]).max()
            assert np.abs(got).max() <= 1e-4 * scale, path
            assert np.abs(w).max() <= 1e-4 * scale, path
            continue
        assert float(np.abs(got).max()) > 0, path
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=path)


def test_image_rows_change_the_loss():
    """The image-grid rows reach the rotary embedding: the same tokens at
    text rows give another loss on both sides (at random weights the loss
    moves by ~1e-4, 100 times its f32 rounding), and query and key weight
    gradients that differ by far more than the parity limit."""
    cfg, jp, npp = _model("qwen2_vl_7b")
    batch = _batch(cfg)
    text = dict(batch)
    del text["positions"]
    jm, jg, tm, tp = _loss_and_grads(cfg, jp, npp, batch)
    jm_text, _, tm_text, tp_text = _loss_and_grads(cfg, jp, npp, text)
    np.testing.assert_allclose(float(tm_text["loss"]),
                               float(jm_text["loss"]), rtol=2e-5)
    for side in ((tm, tm_text), (jm, jm_text)):
        assert abs(float(side[0]["loss"]) - float(side[1]["loss"])) > 1e-5
    grads = dict(tree_items(tp))
    for path, leaf in tree_items(tp_text):
        if path.endswith(("/wq", "/wk")):
            moved = np.abs(grads[path].grad.numpy() - leaf.grad.numpy())
            assert moved.max() > 0.1 * np.abs(jg[path]).max(), path


@pytest.mark.parametrize("sq,sk,kv", [(7, 12, 4), (20, 12, 2),
                                      (33, 50, 4)])
def test_cross_attention_gradient_matches_jax(sq, sk, kv):
    """Bidirectional attention with S_q != S_k through _FlashAttention
    (the forward through kops.flash_attention(impl="ref"), the backward
    the plain path's gradient): output and dq, dk, dv against jax.grad of
    the reference's full_attention."""
    cfg = get_smoke("whisper_small")
    rng = np.random.default_rng(sq * 100 + sk)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, sk, kv, 16)).astype(np.float32)
    v = rng.standard_normal((2, sk, kv, 16)).astype(np.float32)
    cot = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)

    def jfn(q, k, v):
        out = j_full_attention(q, k, v, cfg, q_chunk=8,
                               attn_type="bidirectional")
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = _FlashAttention.apply(*leaves, "bidirectional", None, 8, "ref")
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=1e-5)
    for name, leaf, want in zip("qkv", leaves, jgrads):
        w = np.asarray(want)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_trajectory_matches_jax(arch):
    """5 steps of each side's train step from the same params on the
    pipeline's batches (Qwen2-VL's with image-grid rows)."""
    jcfg, jp, npp = _model(arch)
    cfg = get_smoke(arch)
    pipe = DataPipeline(DataConfig(global_batch=4, seq_len=32,
                                   vocab_size=cfg.vocab_size), cfg)
    jo = jopt.adamw(jopt.cosine_schedule(1e-3, 10, 1000))
    jstep = jax.jit(j_make_train_step(jcfg, JCTX, jo, JSettings()))
    jstate = {"params": jp, "opt": jo.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    opt = topt.adamw(topt.cosine_schedule(1e-3, 10, 1000))
    tstep = make_train_step(cfg, TCTX, opt, TrainSettings())
    params = params_from_numpy(npp, device="cpu")
    tstate = {"params": params, "opt": opt.init(params),
              "step": torch.zeros((), dtype=torch.int32)}
    for i in range(5):
        batch = pipe.batch_for_step(i)
        if "positions" in batch:
            batch["positions"] = vl_positions(32, prefix=4, grid=3, b=4)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        rtol = 1e-4 if i == 0 else 1e-3
        for key in ("loss", "xent", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=rtol, err_msg=f"{key} step {i}")
        assert float(tm["tokens"]) == float(jm["tokens"]) == 128.0
    assert int(tstate["step"]) == 5


@pytest.mark.parametrize("arch", ARCHS)
def test_failure_recovery_matches_uninterrupted_run(arch, tmp_path):
    """A failure at step 7 restores the step-4 checkpoint and replays
    steps 4-6 to the uninterrupted run's losses, bit for bit."""
    cfg = get_smoke(arch)
    kw = dict(batch=2, seq=32, checkpoint_every=4, device="cpu")
    tr1, st1 = build_trainer(cfg, ckpt_dir=str(tmp_path / "a"), **kw)
    _, _, losses1 = tr1.run(st1, 9)
    tr2, st2 = build_trainer(cfg, ckpt_dir=str(tmp_path / "b"),
                             failures={7: 1}, **kw)
    _, led2, losses2 = tr2.run(st2, 9)
    assert len(losses1) == 9 and losses1 == losses2
    assert all(np.isfinite(losses1))
    assert tr2.replay_summary()["replayed_steps"] == 3
    assert led2.totals().get("rework", 0) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_two_microbatches_match_one(arch, tmp_path):
    """The trainer's batch split in two (frames on axis 0, M-RoPE rows on
    axis 1) gives one microbatch's losses to f32 rounding."""
    cfg = get_smoke(arch)
    runs = []
    for n in (1, 2):
        tr, st = build_trainer(cfg, batch=4, seq=16, microbatches=n,
                               ckpt_dir=str(tmp_path / str(n)),
                               checkpoint_every=100, device="cpu")
        runs.append(tr.run(st, 3)[2])
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_smoke(arch, capsys, tmp_path):
    train_launch.main(["--arch", arch, "--smoke", "--steps", "3",
                       "--batch", "2", "--seq", "16", "--microbatches", "2",
                       "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "trained 3 effective steps" in out
    assert "telemetry: goodput=" in out and "replayed=0" in out
    assert "carbon:" in out
