"""The DLRM embedding-bag example of the port against the JAX package's
``examples/dlrm_sparsecore.py``.

The JAX example is loaded from its file (nothing in it changes). Its
``init(jax.random.key(0))`` and ``make_batch(jax.random.key(100 + i))``
give numpy params and batches for both sides; 10 SGD steps each side at
``jax_default_matmul_precision="highest"``: each step's loss within rtol
1e-5, each final leaf within 1e-5 of its largest |value| (fp32 rounding
of the same sums in another order, through 10 updates)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.examples import dlrm_sparsecore as tdlrm
from repro_torch.models.params import params_from_numpy

jax.config.update("jax_default_matmul_precision", "highest")

EXAMPLE = Path(__file__).resolve().parent.parent / "examples" / \
    "dlrm_sparsecore.py"


@pytest.fixture(scope="module")
def jdlrm():
    spec = importlib.util.spec_from_file_location("_jax_dlrm", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_constants_are_the_reference_s(jdlrm):
    assert tdlrm.TABLES == jdlrm.TABLES
    assert tdlrm.BAG == jdlrm.BAG and tdlrm.MLP == jdlrm.MLP


def test_ten_sgd_steps_match_jax(jdlrm):
    jp = jdlrm.init(jax.random.key(0))
    step = jax.jit(lambda p, b: jax.tree.map(
        lambda x, g: x - 0.05 * g, p, jax.grad(jdlrm.loss_fn)(p, b)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert sorted(tp) == sorted(jp)
    for i in range(10):
        jb = jdlrm.make_batch(jax.random.key(100 + i))
        tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
        assert tb["idx_user"].dtype == torch.int32
        want = float(jdlrm.loss_fn(jp, jb))
        jp = step(jp, jb)
        tp, loss = tdlrm.sgd_step(tp, tb, "ref")
        np.testing.assert_allclose(float(loss), want, rtol=1e-5,
                                   err_msg=f"step {i}")
    for name, leaf in jp.items():
        want = np.asarray(leaf)
        err = np.abs(tp[name].numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (name, err)


def test_main_on_the_cpu_shows_the_loss_falling(capsys):
    losses = tdlrm.main(["--device", "cpu", "--steps", "20"])
    assert len(losses) == 20 and losses[-1] < losses[0]
    out = capsys.readouterr().out
    assert "DLRM embedding-bag training: loss" in out
    assert "OK: SparseCore-path (gather/scatter) model trains" in out


def test_a_step_runs_the_bag_forward_three_times(monkeypatch):
    """One forward and backward per step: three embedding bags, so the
    kernel route launches 3 x steps times."""
    calls = []
    real = tdlrm.kops.sparse_gather_sum

    def counted(*args, **kw):
        calls.append(kw["impl"])
        return real(*args, **kw)

    monkeypatch.setattr(tdlrm.kops, "sparse_gather_sum", counted)
    gen = torch.Generator().manual_seed(0)
    params = tdlrm.init(gen, "cpu")
    _, losses = tdlrm.train(params, 4, impl="ref", device="cpu")
    assert calls == ["ref"] * 12 and len(losses) == 4


def test_data_is_the_same_on_every_device():
    """Drawn on CPU generators and moved: the batches of seeds 100.. and
    the init of seed 0 do not depend on the device they land on."""
    a = tdlrm.make_batch(torch.Generator().manual_seed(100), 8, "cpu")
    b = tdlrm.make_batch(torch.Generator().manual_seed(100), 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["label"].tolist() == (a["idx_user"].sum(-1) % 2).tolist()
    assert torch.all(a["w_cat"] == 0.25)
