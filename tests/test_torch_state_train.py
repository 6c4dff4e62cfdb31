"""Training through the state families (rwkv6: RWKV-6 time and channel
mix; Jamba: Mamba + attention + MoE) on the port, against the JAX package
on the CPU.

* ``lm_loss`` and its gradient per leaf against
  ``jax.value_and_grad(api.loss_fn)`` on rwkv6 smoke and jamba smoke (the
  MoE capacity dispatch with its aux losses), same params through
  ``params_from_numpy``, at the trainer's chunks (Mamba 64, RWKV 16) and
  at short ones (Mamba 8, RWKV 4: several chunks a sequence): loss rtol
  2e-5, each gradient leaf within 1e-4 of its largest entry
  (``test_torch_train.py``'s limits).
* A 5-step ``make_train_step`` loss trajectory on rwkv6 smoke: rtol 1e-4
  on step 0 and 1e-3 after (fp32 differences compound through the
  updates).
* ``build_trainer``'s Mamba and RWKV chunks are the reference's.
* The resilient trainer on rwkv6 smoke and jamba smoke: a failure
  replays to the uninterrupted run's losses exactly.
* The launcher trains both archs at smoke size.

fp32 with ``jax_default_matmul_precision="highest"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as j_get_smoke
from repro.launch import train as j_train_launch
from repro.models import api as japi
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
from repro_torch.models.blocks import ModelContext
from repro_torch.models.params import params_from_numpy, tree_items
from repro_torch.optim import optimizers as topt
from repro_torch.train.step import TrainSettings, make_train_step

jax.config.update("jax_default_matmul_precision", "highest")

ARCHS = ("rwkv6_1_6b", "jamba_v01_52b")
# (Mamba chunk, RWKV chunk): the trainer's, and short ones
CHUNKS = {"trainer": (64, 16), "short": (8, 4)}

_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        cfg = j_get_smoke(arch)
        jp = j_init_params(jax.random.key(0), japi.model_specs(cfg))
        _MODELS[arch] = (cfg, jp, jax.tree.map(np.asarray, jp))
    return _MODELS[arch]


def _ctxs(chunks):
    mamba, rwkv = CHUNKS[chunks]
    kw = dict(q_chunk=16, mamba_chunk=mamba, rwkv_chunk=rwkv)
    return (JCtx(compute_dtype=jnp.float32, **kw),
            ModelContext(compute_dtype=torch.float32, device="cpu", **kw))


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in flat}


def _batch(cfg, b=2, s=32, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("chunks", sorted(CHUNKS))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, chunks):
    cfg, jp, npp = _model(arch)
    jctx, tctx = _ctxs(chunks)
    batch = _batch(cfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: japi.loss_fn(p, b, cfg, jctx), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_numpy(npp, device="cpu")
    for _, leaf in tree_items(tp):
        leaf.requires_grad_()
    tl, tm = tapi.loss_fn(tp, {k: torch.from_numpy(v)
                               for k, v in batch.items()}, cfg, tctx)
    tl.backward()
    assert set(tm) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=2e-5, atol=1e-7, err_msg=key)
    if arch == "jamba_v01_52b":
        assert float(tm["load_balance"]) > 0 and float(tm["router_z"]) > 0
    want = _jax_paths(jg)
    assert {path for path, _ in tree_items(tp)} == set(want)
    for path, leaf in tree_items(tp):
        w = want[path]
        assert float(np.abs(leaf.grad.numpy()).max()) > 0, path
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=path)


def test_train_trajectory_matches_jax():
    jcfg, jp, npp = _model("rwkv6_1_6b")
    cfg = get_smoke("rwkv6_1_6b")
    jctx, tctx = _ctxs("trainer")
    pipe = DataPipeline(DataConfig(global_batch=4, seq_len=32,
                                   vocab_size=cfg.vocab_size))
    jo = jopt.adamw(jopt.cosine_schedule(1e-3, 10, 1000))
    jstep = jax.jit(j_make_train_step(jcfg, jctx, jo, JSettings()))
    jstate = {"params": jp, "opt": jo.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    opt = topt.adamw(topt.cosine_schedule(1e-3, 10, 1000))
    tstep = make_train_step(cfg, tctx, opt, TrainSettings())
    params = params_from_numpy(npp, device="cpu")
    tstate = {"params": params, "opt": opt.init(params),
              "step": torch.zeros((), dtype=torch.int32)}
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


def test_build_trainer_uses_the_reference_chunks(monkeypatch, tmp_path):
    """The trainer's Mamba and RWKV chunks are the reference
    ``build_trainer``'s (64 and 16), not ModelContext's defaults."""
    seen = {}

    def spy(side):
        def make(cfg, ctx, *args, **kwargs):
            seen[side] = (ctx.q_chunk, ctx.mamba_chunk, ctx.rwkv_chunk)
            raise StopIteration
        return make

    monkeypatch.setattr(train_launch, "make_train_step", spy("torch"))
    monkeypatch.setattr(j_train_launch, "make_train_step", spy("jax"))
    for side, build in (("torch", build_trainer),
                        ("jax", j_train_launch.build_trainer)):
        kw = {"device": "cpu"} if side == "torch" else {}
        with pytest.raises(StopIteration):
            build(get_smoke("rwkv6_1_6b"), batch=2, seq=16,
                  ckpt_dir=str(tmp_path / side), **kw)
    assert seen["torch"] == seen["jax"] == (2048, 64, 16)


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
def test_train_launcher_smoke(arch, capsys, tmp_path):
    train_launch.main(["--arch", arch, "--smoke", "--steps", "3",
                       "--batch", "2", "--seq", "16", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "trained 3 effective steps" in out
    assert "replayed=0" in out
