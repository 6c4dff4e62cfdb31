"""The compressed cross-pod gradient exchange of the port
(``repro_torch.train.compress``) against the JAX package on the CPU: int8
quantization, the int8 error-feedback mean over 2 and 4 gloo ranks for
three steps (the reference's ``_compressed_mean_one`` run under
``jax.vmap`` over a "pod" axis), ``make_compressed_grad_fn`` of a linear
least-squares loss against ``jax.value_and_grad`` and the same vmapped
exchange, ``init_error_state`` and ``wire_bytes_per_step``. The ranks run
the tasks of tests/torch_rank_tasks.py as task jobs of
``serve_on_mesh``; each group forms through a file store under the
test's ``tmp_path``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compress as jc
from repro_torch.serve.sharded import serve_on_mesh
from repro_torch.train import compress as tc

jax.config.update("jax_default_matmul_precision", "highest")

LIMIT = 1e-6
RANK_TIMEOUT_S = 120.0
STEPS = 3


@pytest.mark.parametrize("shape,scale", [((7,), 1.0), ((3, 5), 1e-3),
                                         ((4, 6, 2), 250.0), ((1,), 0.0)])
def test_quantize_int8_matches_reference(shape, scale):
    x = (np.random.default_rng(0).standard_normal(shape)
         * scale).astype(np.float32)
    jq, js = jc.quantize_int8(jnp.asarray(x))
    tq, ts = tc.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert float(ts) == float(js)
    np.testing.assert_array_equal(
        tc.dequantize_int8(tq, ts).numpy(),
        np.asarray(jc.dequantize_int8(jq, js)))


def _reference_steps(grads):
    """The reference's exchange: ``_compressed_mean_one`` under
    ``jax.vmap`` over the pod axis, the error state carried; returns each
    step's (mean, error) per rank."""
    fn = jax.vmap(lambda g, e: jc._compressed_mean_one(g, e, "pod"),
                  axis_name="pod")
    err = jnp.zeros((len(grads[0]),) + grads[0][0].shape, jnp.float32)
    out = []
    for step in grads:
        mean, err = fn(jnp.asarray(np.stack(step)), err)
        out.append((np.asarray(mean), np.asarray(err)))
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_mean_matches_reference(world, tmp_path):
    """Three steps of error feedback: every rank's mean and new error
    state within 1e-6 of the reference's, and the mean the same on
    every rank. The same ranks run make_compressed_grad_fn and
    wire_bytes_per_step."""
    rng = np.random.default_rng(world)
    grads = [[(rng.standard_normal((5, 3)) * (r + 1)).astype(np.float32)
              for r in range(world)] for _ in range(STEPS)]
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal((3,)).astype(np.float32)}
    batches = [{"x": rng.standard_normal((6, 4)).astype(np.float32),
                "y": rng.standard_normal((6, 3)).astype(np.float32)}
               for _ in range(world)]
    res = serve_on_mesh([
        {"task": "torch_rank_tasks:compressed_means",
         "kwargs": dict(grads=grads)},
        {"task": "torch_rank_tasks:compressed_grads",
         "kwargs": dict(params=params, batches=batches, steps=STEPS)},
        {"task": "torch_rank_tasks:wire_bytes",
         "kwargs": dict(n_params=123457)},
    ], (world, 1), "cpu", timeout_s=RANK_TIMEOUT_S, store_dir=str(tmp_path))

    want = _reference_steps(grads)
    for rank, (means, _, wire) in enumerate(res):
        for step, ((mean, err), (jmean, jerr)) in enumerate(zip(means,
                                                                want)):
            np.testing.assert_allclose(mean, jmean[rank], rtol=0,
                                       atol=LIMIT, err_msg=f"step {step}")
            np.testing.assert_allclose(err, jerr[rank], rtol=0, atol=LIMIT,
                                       err_msg=f"step {step}")
            np.testing.assert_array_equal(mean, res[0][0][step][0])
        assert wire == [jc.wire_bytes_per_step(123457, world, c)
                        for c in (True, False)]

    # make_compressed_grad_fn: jax.value_and_grad per rank, then the
    # vmapped exchange, with the loss and metrics averaged over the pods
    def loss_fn(p, b):
        pred = b["x"] @ p["w"] + p["b"]
        loss = jnp.mean((pred - b["y"]) ** 2)
        return loss, {"mse": loss, "y_mean": jnp.mean(b["y"])}

    vg = jax.value_and_grad(loss_fn, has_aux=True)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    per_rank = [vg(jp, {k: jnp.asarray(v) for k, v in b.items()})
                for b in batches]
    for name in ("w", "b"):
        g = [np.asarray(pr[1][name]) for pr in per_rank]
        steps = _reference_steps([g] * STEPS)
        for rank, (_, grads_out, _) in enumerate(res):
            for step, (jmean, jerr) in enumerate(steps):
                _, _, gm, ge = grads_out[step]
                np.testing.assert_allclose(gm[name], jmean[rank], rtol=0,
                                           atol=LIMIT)
                np.testing.assert_allclose(ge[name], jerr[rank], rtol=0,
                                           atol=LIMIT)
    loss = np.mean([float(pr[0][0]) for pr in per_rank])
    y_mean = np.mean([float(pr[0][1]["y_mean"]) for pr in per_rank])
    for _, grads_out, _ in res:
        for lval, metrics, _, _ in grads_out:
            assert abs(lval - loss) <= LIMIT * max(1.0, abs(loss))
            assert abs(metrics["mse"] - loss) <= LIMIT * max(1.0, abs(loss))
            assert abs(metrics["y_mean"] - y_mean) <= LIMIT


def test_error_state_and_wire_bytes_match_reference():
    tree = {"a": torch.ones(3, 2, dtype=torch.bfloat16),
            "b": {"c": torch.ones(4)}}
    err = tc.init_error_state(tree)
    assert err["a"].dtype == torch.float32 and err["a"].shape == (3, 2)
    assert float(err["b"]["c"].abs().sum()) == 0.0
    for n, pods in ((1, 2), (10 ** 9, 2), (494032768, 4), (7, 16)):
        for compressed in (True, False):
            assert tc.wire_bytes_per_step(n, pods, compressed) == \
                jc.wire_bytes_per_step(n, pods, compressed)
