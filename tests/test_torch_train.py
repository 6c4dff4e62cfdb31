"""Training path of the port against the JAX package on the CPU.

* ``lm_loss`` and its gradient per leaf against
  ``jax.value_and_grad(api.loss_fn)`` on qwen2 smoke and mixtral smoke
  (MoE capacity dispatch with aux losses), same params through
  ``params_from_numpy``: loss rtol 2e-5 (``test_attn_impl_parity.py``'s),
  each gradient leaf within 1e-4 of its largest entry.
* One AdamW and one Adafactor update on the same gradients, the cosine
  schedule and global-norm clipping: rtol 1e-5 (fp32 rounding).
* The masked loss on qwen2 smoke and on whisper smoke (the
  encoder-decoder family; its gradients: test_torch_encdec_train.py).
* Data tokens: bit-identical.
* A 5-step ``make_train_step`` loss trajectory: rtol 1e-4 on step 0 and
  1e-3 after (fp32 differences compound through the updates).
* Microbatching, checkpointing, and the resilient trainer (a failure at
  step 9 replays to the uninterrupted run's losses exactly; the goodput
  ledger has the reference trainer's shape).
* Deterministic mode refuses a cuBLAS workspace setting that comes after
  CUDA has started.

fp32 with ``jax_default_matmul_precision="highest"``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as j_get_smoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import DataPipeline as JDataPipeline
from repro.launch.train import build_trainer as j_build_trainer
from repro.models import api as japi
from repro.models.blocks import ModelContext as JCtx
from repro.models.params import init_params as j_init_params
from repro.optim import optimizers as jopt
from repro.train.step import TrainSettings as JSettings
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_smoke
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.launch import train as train_launch
from repro_torch.launch.train import build_trainer
from repro_torch.models import api as tapi
from repro_torch.models.blocks import ModelContext
from repro_torch.models.params import params_from_numpy, tree_items
from repro_torch.optim import optimizers as topt
from repro_torch.train.step import TrainSettings, make_train_step

jax.config.update("jax_default_matmul_precision", "highest")

TCTX = ModelContext(compute_dtype=torch.float32, q_chunk=16, device="cpu")
JCTX = JCtx(compute_dtype=jnp.float32, q_chunk=16)


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in flat}


def _model(arch):
    cfg = j_get_smoke(arch)
    jp = j_init_params(jax.random.key(0), japi.model_specs(cfg))
    return cfg, jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def qwen():
    return _model("qwen2_0_5b")


def _batch(cfg, b=2, s=32, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "mixtral_8x22b"])
def test_loss_and_grads_match_jax(arch, qwen):
    cfg, jp, npp = qwen if arch == "qwen2_0_5b" else _model(arch)
    batch = _batch(cfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: japi.loss_fn(p, b, cfg, JCTX), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_numpy(npp, device="cpu")
    for _, leaf in tree_items(tp):
        leaf.requires_grad_()
    tl, tm = tapi.loss_fn(tp, {k: torch.from_numpy(v)
                               for k, v in batch.items()}, cfg, TCTX)
    tl.backward()
    assert set(tm) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=2e-5, atol=1e-7, err_msg=key)
    if arch == "mixtral_8x22b":
        assert float(tm["load_balance"]) > 0 and float(tm["router_z"]) > 0
    want = _jax_paths(jg)
    for path, leaf in tree_items(tp):
        w = want[path]
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=path)


def test_loss_mask_and_encdec():
    cfg = get_smoke("qwen2_0_5b")
    jcfg, jp, npp = _model("qwen2_0_5b")
    batch = _batch(jcfg, seed=3)
    mask = (np.arange(32)[None, :] < np.array([[20], [9]])).astype(
        np.float32)
    jl, jm = japi.loss_fn(jp, {**{k: jnp.asarray(v)
                                  for k, v in batch.items()},
                               "loss_mask": jnp.asarray(mask)}, jcfg, JCTX)
    tl, tm = tapi.loss_fn(params_from_numpy(npp, device="cpu"),
                          {**{k: torch.from_numpy(v)
                              for k, v in batch.items()},
                           "loss_mask": torch.from_numpy(mask)}, cfg, TCTX)
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-5)
    assert float(tm["tokens"]) == float(jm["tokens"]) == 29.0
    # the encoder-decoder family trains: whisper smoke's masked loss
    wcfg, wjp, wnpp = _model("whisper_small")
    frames = np.random.default_rng(4).standard_normal(
        (2, wcfg.encoder_seq, wcfg.d_model)).astype(np.float32) * 0.1
    wbatch = {**_batch(wcfg, seed=3), "loss_mask": mask,
              "enc_feats": frames}
    jl, jm = japi.loss_fn(wjp, {k: jnp.asarray(v)
                                for k, v in wbatch.items()}, wcfg, JCTX)
    tl, tm = tapi.loss_fn(params_from_numpy(wnpp, device="cpu"),
                          {k: torch.from_numpy(v)
                           for k, v in wbatch.items()},
                          get_smoke("whisper_small"), TCTX)
    assert set(tm) == set(jm) == {"xent", "loss", "tokens"}
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-5)
    assert float(tm["tokens"]) == float(jm["tokens"]) == 29.0


def _opt_case(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (256, 160), "stack": (2, 130, 128), "b": (8,),
              "emb": (40, 12)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = {k: rng.standard_normal(s).astype(np.float32) * 3
             for k, s in shapes.items()}
    return params, grads


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_matches_jax(name):
    params, grads = _opt_case()
    sched = (1e-3, 10, 1000)
    jo = getattr(jopt, name)(jopt.cosine_schedule(*sched))
    to = getattr(topt, name)(topt.cosine_schedule(*sched))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jo.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = to.init(tparams)
    for step in (0, 5, 37):
        jparams, jstate = jo.update({k: jnp.asarray(v)
                                     for k, v in grads.items()},
                                    jstate, jparams,
                                    jnp.asarray(step, jnp.int32))
        to.update({k: torch.from_numpy(v.copy()) for k, v in grads.items()},
                  tstate, tparams, torch.tensor(step, dtype=torch.int32))
    for k in params:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    for path, w in _jax_paths(jstate).items():
        node = tstate
        for part in path.split("/"):
            node = node[part]
        np.testing.assert_allclose(node.numpy(), w, rtol=1e-5, atol=1e-12,
                                   err_msg=path)
    if name == "adafactor":
        assert set(tstate["w"]) == {"vr", "vc"} and set(tstate["b"]) == {"v"}
        assert tstate["w"]["vr"].shape == (256,)


def test_schedule_and_clip_match_jax():
    jl = jopt.cosine_schedule(3e-4, 200, 10_000)
    tl = topt.cosine_schedule(3e-4, 200, 10_000)
    for step in (0, 1, 150, 200, 201, 5000, 9999, 12000):
        np.testing.assert_allclose(
            float(tl(torch.tensor(step, dtype=torch.int32))),
            float(jl(jnp.asarray(step, jnp.int32))), rtol=1e-6, atol=0)
    assert float(tl(torch.tensor(0))) == 0.0
    _, grads = _opt_case(1)
    for max_norm in (1.0, 1e4):
        jg, jn = jopt.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in grads.items()}, max_norm)
        tg, tn = topt.clip_by_global_norm(
            {k: torch.from_numpy(v.copy()) for k, v in grads.items()},
            max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for k in grads:
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                       rtol=1e-6, atol=1e-9)


def test_data_tokens_bit_identical(tmp_path):
    for kw in (dict(global_batch=4, seq_len=16, vocab_size=101, seed=3),
               dict(global_batch=2, seq_len=64, vocab_size=151936, seed=0)):
        tp, jp = DataPipeline(DataConfig(**kw)), JDataPipeline(
            JDataConfig(**kw))
        for step in (0, 7, 42):
            tb, jb = tp.batch_for_step(step), jp.batch_for_step(step)
            assert set(tb) == set(jb)
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k])
                assert tb[k].dtype == jb[k].dtype
    path = os.path.join(tmp_path, "tokens.bin")
    np.arange(4 * 17 * 3, dtype=np.int32).tofile(path)
    kw = dict(global_batch=4, seq_len=16, vocab_size=1 << 30,
              token_file=path)
    tb = DataPipeline(DataConfig(**kw)).batch_for_step(1)
    jb = JDataPipeline(JDataConfig(**kw)).batch_for_step(1)
    np.testing.assert_array_equal(tb["tokens"], jb["tokens"])


def _small_setup(jp_np, cfg, micro=1):
    opt = topt.adamw(topt.cosine_schedule(1e-3, 10, 1000))
    step = make_train_step(cfg, TCTX, opt, TrainSettings(microbatches=micro))
    params = params_from_numpy(jp_np, device="cpu")
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    return step, state


def test_train_trajectory_matches_jax(qwen):
    jcfg, jp, npp = qwen
    cfg = get_smoke("qwen2_0_5b")
    pipe = DataPipeline(DataConfig(global_batch=4, seq_len=32,
                                   vocab_size=cfg.vocab_size))
    jo = jopt.adamw(jopt.cosine_schedule(1e-3, 10, 1000))
    jstep = jax.jit(j_make_train_step(jcfg, JCTX, jo, JSettings()))
    jstate = {"params": jp, "opt": jo.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    tstep, tstate = _small_setup(npp, cfg)
    for i in range(5):
        batch = pipe.batch_for_step(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        rtol = 1e-4 if i == 0 else 1e-3
        for key in ("loss", "xent", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=rtol, err_msg=f"{key} step {i}")
        assert float(tm["tokens"]) == float(jm["tokens"]) == 128.0
    assert int(tstate["step"]) == 5


def test_microbatch_equivalence(qwen):
    _, _, npp = qwen
    cfg = get_smoke("qwen2_0_5b")
    batch = DataPipeline(DataConfig(global_batch=4, seq_len=32,
                                    vocab_size=cfg.vocab_size)
                         ).batch_for_step(0)
    step1, s1 = _small_setup(npp, cfg, micro=1)
    step4, s4 = _small_setup(npp, cfg, micro=4)
    s1, m1 = step1(s1, batch)
    s4, m4 = step4(s4, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]),
                               float(m4["grad_norm"]), rtol=1e-4)
    assert float(m4["tokens"]) == 128.0
    for (path, a), (_, b) in zip(tree_items(s1["params"]),
                                 tree_items(s4["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-4, err_msg=path)


def test_checkpoint_roundtrip_gc_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"params": {"w": torch.arange(12.0).reshape(3, 4)},
             "step": torch.tensor(7, dtype=torch.int32)}
    for s in (1, 2, 3):
        mgr.save(s, state, blocking=True)
    assert mgr.all_steps() == [2, 3]
    out = mgr.restore(3, state)
    assert torch.equal(out["params"]["w"], state["params"]["w"])
    assert out["step"].dtype == torch.int32 and int(out["step"]) == 7
    # async: the host copy is taken before save returns, so an in-place
    # update right after it does not reach the checkpoint
    mgr.save(4, state)
    state["params"]["w"].add_(100.0)
    mgr.wait()
    assert mgr.latest_step() == 4
    out = mgr.restore(4, state)
    np.testing.assert_array_equal(out["params"]["w"].numpy(),
                                  np.arange(12.0).reshape(3, 4))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(4, {"params": {"w": torch.zeros(2, 2)},
                        "step": state["step"]})


def test_checkpoint_corruption_detected_and_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    for s in (1, 2):
        mgr.save(s, {"w": torch.full((4, 4), float(s))}, blocking=True)
    like = {"w": torch.zeros(4, 4)}
    # a changed value: CRC mismatch, and no earlier step to fall back to
    one = CheckpointManager(str(tmp_path / "one"))
    one.save(1, {"w": torch.ones(8, 8)}, blocking=True)
    leaf = os.path.join(one.directory, "step_00000001", "w.npy")
    arr = np.load(leaf)
    arr[0, 0] = 999.0
    np.save(leaf, arr)
    with pytest.raises(IOError, match="checksum"):
        one.restore(1, {"w": torch.zeros(8, 8)})
    # a truncated leaf: quarantined, the previous step restored
    leaf = os.path.join(str(tmp_path), "step_00000002", "w.npy")
    with open(leaf, "r+b") as fh:
        fh.truncate(os.path.getsize(leaf) // 2)
    out = mgr.restore(2, like)
    np.testing.assert_array_equal(out["w"].numpy(), np.full((4, 4), 1.0))
    assert mgr.last_restored_step == 1
    assert mgr.all_steps() == [1]
    assert os.path.isdir(os.path.join(str(tmp_path), "step_00000002.corrupt"))


def test_failure_recovery_matches_uninterrupted_run(tmp_path):
    """The resilience contract: a run with an injected failure, restore
    and replay gives the uninterrupted run's losses bit for bit, and its
    goodput ledger has the reference trainer's shape."""
    cfg = get_smoke("qwen2_0_5b")
    kw = dict(batch=4, seq=32, checkpoint_every=5, device="cpu")
    tr1, st1 = build_trainer(cfg, ckpt_dir=str(tmp_path / "a"), **kw)
    _, led1, losses1 = tr1.run(st1, 14)
    tr2, st2 = build_trainer(cfg, ckpt_dir=str(tmp_path / "b"),
                             failures={9: 3}, **kw)
    _, led2, losses2 = tr2.run(st2, 14)
    assert len(losses1) == 14 and losses1 == losses2
    assert led2.totals().get("rework", 0) > 0
    assert led2.goodput < 1.0 and led1.goodput > led2.goodput
    assert tr2.replay_summary() == {"executions": 18, "replayed_steps": 4,
                                    "effective_steps": 14, "rescales": 0}
    replays = [r for r in tr2.records if r.replayed]
    assert [r.step for r in replays] == [5, 6, 7, 8]
    first = {r.step: r.loss for r in tr2.records if not r.replayed}
    assert all(r.loss == first[r.step] for r in replays)
    assert tr2.metrics.counter("train_restores").value == 1
    # the reference trainer's ledger on the same plan
    jtr, jst = j_build_trainer(j_get_smoke("qwen2_0_5b"), batch=4, seq=32,
                               ckpt_dir=str(tmp_path / "j"),
                               checkpoint_every=5, failures={9: 3})
    _, jled, _ = jtr.run(jst, 14)
    assert led2.structure() == jled.structure()
    assert tr2.replay_summary() == jtr.replay_summary()


def test_deterministic_mode_refuses_a_late_cublas_workspace(monkeypatch):
    """The fixed cuBLAS workspace must precede the process's first CUDA
    work: unset once CUDA has started, deterministic mode raises instead
    of setting it too late (and leaves torch's mode untouched)."""
    # setenv first so that teardown restores the variable's absence too
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    calls = []
    monkeypatch.setattr(torch, "use_deterministic_algorithms", calls.append)
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        train_launch.deterministic_mode()
    assert calls == [] and "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    train_launch.deterministic_mode()
    assert calls == [True]
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
