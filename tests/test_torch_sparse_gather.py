"""The embedding bag of the port against the JAX package.

The torch twin of the oracle (``ref.sparse_gather_sum_ref``), the plain
version of the CUDA kernel (``sparse_gather_sum_plain``, the bag walked in
order) and the wrapper on CPU tensors, against JAX's
``ops.sparse_gather_sum`` in ``impl="interpret"`` (the Pallas kernel) and
``impl="ref"`` on the same numpy inputs: rtol 1e-5, atol 1e-5 in f32, as
tests/test_kernels.py holds the Pallas kernel; bf16 tables within one
bf16 step of the result (both sides round an f32 sum once). Shapes: the
JAX tests', the DLRM example's three tables (N 256, bag 4) and repeated
indices inside a bag.

Index semantics: ``table[idx]`` in jnp wraps a negative index once and
clamps the result to [0, V-1]; ``jax.grad`` of that gather drops an index
still outside [0, V) from the table's gradient. The port's forward and
its autograd route (``_EmbeddingBag``) hold both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.examples.dlrm_sparsecore import _EmbeddingBag
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from repro_torch.kernels import sparse_gather as sg

jax.config.update("jax_default_matmul_precision", "highest")

BF16_STEP = 2.0 ** -7  # bf16 keeps 8 significant bits


def _inputs(v, d, n, bag, seed, repeat=False):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(0, v, (n, bag)).astype(np.int32)
    if repeat:  # every bag names its first row again at its end
        idx[:, -1] = idx[:, 0]
        idx[::2, 1] = idx[::2, 0]
    w = rng.standard_normal((n, bag)).astype(np.float32)
    return table, idx, w


def _torch_sides(table, idx, w, dtype=torch.float32):
    t = torch.from_numpy(table).to(dtype)
    i, ww = torch.from_numpy(idx), torch.from_numpy(w)
    return {"ref twin": ref.sparse_gather_sum_ref(t, i, ww),
            "plain": sg.sparse_gather_sum_plain(t, i, ww),
            "wrapper": sg.sparse_gather_sum(t, i, ww),
            "ops ref": tops.sparse_gather_sum(t, i, ww, impl="ref")}


@pytest.mark.parametrize("v,d,n,bag,impl", [
    (128, 64, 16, 4, "interpret"), (512, 128, 8, 8, "interpret"),
    (128, 64, 16, 4, "ref"), (512, 128, 8, 8, "ref"),
    (5000, 32, 256, 4, "ref"), (20000, 32, 256, 4, "ref"),
    (200, 16, 256, 4, "ref"), (64, 16, 12, 5, "interpret")])
def test_matches_jax_f32(v, d, n, bag, impl):
    table, idx, w = _inputs(v, d, n, bag, seed=v + d)
    want = np.asarray(jops.sparse_gather_sum(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w), impl=impl))
    for name, got in _torch_sides(table, idx, w).items():
        assert got.dtype == torch.float32 and got.shape == (n, d)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("impl", ["interpret", "ref"])
def test_repeated_indices_in_a_bag(impl):
    table, idx, w = _inputs(40, 24, 10, 6, seed=3, repeat=True)
    want = np.asarray(jops.sparse_gather_sum(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w), impl=impl))
    for name, got in _torch_sides(table, idx, w).items():
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("v,d,n,bag", [(128, 64, 16, 4), (200, 16, 256, 4),
                                       (300, 40, 32, 7)])
def test_bf16_table_within_one_step(v, d, n, bag):
    table, idx, w = _inputs(v, d, n, bag, seed=11)
    table = np.array(jnp.asarray(table, jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(jops.sparse_gather_sum(
        jnp.asarray(table, jnp.bfloat16), jnp.asarray(idx), jnp.asarray(w),
        impl="ref").astype(jnp.float32))
    top = np.abs(want).max(axis=-1, keepdims=True)
    for name, got in _torch_sides(table, idx, w, torch.bfloat16).items():
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - want) / top
        assert err.max() <= BF16_STEP, (name, err.max())


def test_bag_of_one_with_weight_one_is_the_row():
    table, _, _ = _inputs(127, 32, 1, 1, seed=4)
    idx = np.arange(127, dtype=np.int32)[:, None]
    w = np.ones((127, 1), np.float32)
    for name, got in _torch_sides(table, idx, w).items():
        assert torch.equal(got, torch.from_numpy(table)), name


def test_negative_and_out_of_range_indices_match_jax():
    """-1 -> V-1, V+2 -> V-1, -V-4 -> 0, -V -> 0: wrap once, then clamp."""
    table, _, w = _inputs(9, 8, 3, 4, seed=5)
    idx = np.asarray([[-1, 11, -13, 2], [-9, 8, 0, -2], [100, -100, 4, 4]],
                     np.int32)
    want = np.asarray(jops.sparse_gather_sum(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w), impl="ref"))
    for name, got in _torch_sides(table, idx, w).items():
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    rows = sg.table_rows(torch.from_numpy(idx), 9).numpy()
    np.testing.assert_array_equal(rows, [[8, 8, 0, 2], [0, 8, 0, 7],
                                         [8, 0, 4, 4]])


def _jax_grads(table, idx, w, g):
    def f(t, ww):
        out = jops.sparse_gather_sum(t, jnp.asarray(idx), ww, impl="ref")
        return jnp.sum(out * jnp.asarray(g))
    gt, gw = jax.grad(f, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(w))
    return np.asarray(gt), np.asarray(gw)


def _torch_grads(table, idx, w, g):
    t = torch.from_numpy(table).requires_grad_()
    ww = torch.from_numpy(w).requires_grad_()
    out = _EmbeddingBag.apply(t, torch.from_numpy(idx), ww, "ref")
    (out * torch.from_numpy(g)).sum().backward()
    return t.grad.numpy(), ww.grad.numpy()


def test_gradient_drops_what_the_forward_clamps():
    """A (5, 2) table and the bag [-1, 7, -9, 2, 2] of ones: jax.grad puts
    1 in row 4 (from -1) and 2 in row 2; 7 and -9 (wrapped to -4) add
    nothing, though the forward read rows 4 and 0 for them."""
    table = np.arange(10, dtype=np.float32).reshape(5, 2)
    idx = np.asarray([[-1, 7, -9, 2, 2]], np.int32)
    w = np.ones((1, 5), np.float32)
    g = np.ones((1, 2), np.float32)
    jt, jw = _jax_grads(table, idx, w, g)
    tt, tw = _torch_grads(table, idx, w, g)
    np.testing.assert_array_equal(jt[:, 0], [0, 0, 2, 0, 1])
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tw, jw, rtol=1e-6)
    # the weights' gradient reads the clamped rows: 8+9, 8+9, 0+1, 4+5
    np.testing.assert_array_equal(tw[0], [17, 17, 1, 9, 9])


def test_gradients_match_jax_on_random_bags():
    table, idx, w = _inputs(50, 12, 20, 6, seed=6, repeat=True)
    idx[0, 2], idx[3, 1], idx[7, 5] = -3, 77, -60
    g = np.random.default_rng(7).standard_normal((20, 12)).astype(np.float32)
    jt, jw = _jax_grads(table, idx, w, g)
    tt, tw = _torch_grads(table, idx, w, g)
    np.testing.assert_allclose(tt, jt, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-5)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    t = torch.zeros((4, 8))
    i = torch.zeros((2, 3), dtype=torch.int32)
    w = torch.ones((2, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.sparse_gather_sum(t, i, w, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        tops.sparse_gather_sum(t, i, w, impl="pallas")
    with pytest.raises(ValueError, match="fault"):
        sg.sparse_gather_sum(t, i, w, skip_last=True)
    with pytest.raises(ValueError, match="want both"):
        sg.sparse_gather_sum(t, i, torch.ones((2, 4)))
    with pytest.raises(ValueError, match="want"):
        sg.sparse_gather_sum(t[0], i, w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sg._check(t, i, w)
