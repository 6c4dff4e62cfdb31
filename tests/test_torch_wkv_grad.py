"""The contract of the WKV backward kernel on the CPU:
``rwkv_scan.wkv_backward_plain`` (the gradient of ``chunked_wkv_plain``
written out chunk by chunk) and ``WkvFunction`` (the autograd function of
the kernel route), against the JAX package and float64 autograd.

* ``wkv_backward_plain`` against ``jax.vjp`` of the reference's
  ``rwkv6._chunked_wkv`` with random cotangents of out and the final
  state, at hd 16 and 64 and chunks 4, 8 and 16, from a zero initial state
  (with no final-state cotangent) and a nonzero one, and with every other
  token's log decay at the -4 clamp: all six results.
* ``wkv_backward_plain`` against float64 autograd through
  ``ref.rwkv_wkv_ref``, the token-serial recurrence.
* ``WkvFunction`` on CPU tensors (both wrappers run their plain versions,
  the kernel's stand-in) against autograd through ``chunked_wkv_plain``,
  and ``torch.autograd.gradcheck`` of it in float64 at a tiny size.
* The routes of ``ops.rwkv_wkv``: "ref" is autograd through the plain
  version; the CUDA kernels' planted fault is refused on the CPU.

Limit: WKV_GRAD_TOL = 2e-5 of each result's largest |value| (at least 1):
fp32 sums in another order, and the cumulative log decay's rounding, which
the factors exp(cum_excl) and exp(-cum) (up to e^64 at chunk 16) carry.
fp32 with ``jax_default_matmul_precision="highest"``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv6 as jrwkv
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv_scan

jax.config.update("jax_default_matmul_precision", "highest")

WKV_GRAD_TOL = 2e-5
NAMES = ("dr", "dk", "dv", "dlogw", "du", "ds0")


def _inputs(seed, b, s, h, hd, *, clamped=False, dtype=np.float32):
    """r, k, v ~ N(0, 1), logw = clip(-exp(N(0, 1)), -4, 0) (every other
    token at -4 when ``clamped``), u ~ N(0, 0.25), s0 ~ N(0, 0.09), and
    cotangents dout ~ N(0, 1), d_state ~ N(0, 0.25): numpy."""
    rng = np.random.default_rng(seed)
    shape = (b, s, h, hd)
    r, k, v = (rng.standard_normal(shape) for _ in range(3))
    lw = np.clip(-np.exp(rng.standard_normal(shape)), -4.0, 0.0)
    if clamped:
        lw[:, ::2] = -4.0
    u = rng.standard_normal((h, hd)) * 0.5
    s0 = rng.standard_normal((b, h, hd, hd)) * 0.3
    dout = rng.standard_normal(shape)
    dstate = rng.standard_normal((b, h, hd, hd)) * 0.5
    return [x.astype(dtype) for x in (r, k, v, lw, u, s0, dout, dstate)]


def _close(name, got, want, tol=WKV_GRAD_TOL):
    """max |got - want| <= tol * max(1, max |want|)."""
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    assert got.shape == want.shape, name
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (name, err)


def _t(*xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("init", ["zero", "random", "clamped"])
@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("hd", [16, 64])
def test_plain_backward_matches_jax_vjp(hd, chunk, init):
    r, k, v, lw, u, s0, dout, dstate = _inputs(
        hd + chunk, 2, 64, 3, hd, clamped=init == "clamped")
    if init == "zero":
        s0, dstate = np.zeros_like(s0), None
    (_, s_final), vjp = jax.vjp(
        lambda *a: jrwkv._chunked_wkv(*a, chunk=chunk),
        *(jnp.asarray(x) for x in (r, k, v, lw, u, s0)))
    want = vjp((jnp.asarray(dout), jnp.zeros_like(s_final)
                if dstate is None else jnp.asarray(dstate)))
    got = rwkv_scan.wkv_backward_plain(
        *_t(r, k, v, lw, u, None if init == "zero" else s0, dout, dstate),
        chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        _close(name, g.numpy(), w)


@pytest.mark.parametrize("s,hd,chunk", [(64, 16, 16), (48, 16, 8),
                                        (32, 64, 16), (30, 16, 5)])
def test_plain_backward_matches_float64_recurrence(s, hd, chunk):
    r, k, v, lw, u, _, dout, _ = _inputs(s, 2, s, 2, hd)
    got = rwkv_scan.wkv_backward_plain(*_t(r, k, v, lw, u), None,
                                       torch.from_numpy(dout), None,
                                       chunk=chunk)

    def heads(x):  # (B,S,H,hd) -> (B*H,S,hd)
        return x.permute(0, 2, 1, 3).reshape(-1, s, hd)

    leaves = [x.double().requires_grad_() for x in _t(r, k, v, lw, u)]
    b, h = r.shape[0], r.shape[2]
    out = tref.rwkv_wkv_ref(*(heads(x) for x in leaves[:4]),
                            leaves[4].repeat(b, 1))
    want = torch.autograd.grad(out, leaves, heads(torch.from_numpy(
        dout).double()).reshape(out.shape))
    for name, g, w in zip(NAMES, got, want):
        _close(name, g.numpy(), w.numpy())
    assert float(got[5].abs().max()) > 0  # ds0: r reads the initial state


def _autograd_plain(r, k, v, lw, u, s0, dout, dstate, chunk):
    leaves = [x.clone().requires_grad_() for x in (r, k, v, lw, u, s0)]
    out, s_final = rwkv_scan.chunked_wkv_plain(*leaves, chunk=chunk)
    return torch.autograd.grad((out, s_final), leaves, (dout, dstate))


@pytest.mark.parametrize("chunk", [1, 4, 16])
def test_wkv_function_matches_autograd_through_plain(chunk):
    r, k, v, lw, u, s0, dout, dstate = _t(*_inputs(chunk, 2, 32, 2, 16))
    want = _autograd_plain(r, k, v, lw, u, s0, dout, dstate, chunk)
    leaves = [x.clone().requires_grad_() for x in (r, k, v, lw, u, s0)]
    out, s_final = rwkv_scan.WkvFunction.apply(*leaves, chunk)
    got = torch.autograd.grad((out, s_final), leaves, (dout, dstate))
    for name, g, w in zip(NAMES, got, want):
        _close(name, g.numpy(), w.numpy())
    # no final-state cotangent, and s0 without a gradient or no s0 at all
    for init in (s0, None):
        leaves = [x.clone().requires_grad_() for x in (r, k, v, lw, u)]
        out, _ = rwkv_scan.WkvFunction.apply(*leaves, init, chunk)
        got = torch.autograd.grad(out, leaves, dout)
        plain = [x.clone().requires_grad_() for x in (r, k, v, lw, u)]
        want_out, _ = rwkv_scan.chunked_wkv_plain(*plain, init, chunk=chunk)
        want = torch.autograd.grad(want_out, plain, dout)
        for name, g, w in zip(NAMES, got, want):
            _close(name, g.numpy(), w.numpy())


def test_wkv_function_gradcheck_float64():
    r, k, v, lw, u, s0, _, _ = _inputs(7, 1, 8, 2, 4, dtype=np.float64)
    leaves = [x.requires_grad_() for x in _t(r, k, v, lw, u, s0)]
    assert torch.autograd.gradcheck(
        lambda *a: rwkv_scan.WkvFunction.apply(*a, 4), leaves,
        eps=1e-6, atol=1e-7, rtol=1e-5)


def test_ops_routes_and_refused_fault():
    """"ref" on inputs that need a gradient is plain autograd; "cuda" needs
    CUDA tensors; the backward's planted fault is the kernel's alone."""
    r, k, v, lw, u, s0, dout, dstate = _t(*_inputs(3, 1, 16, 2, 16))
    leaves = [x.clone().requires_grad_() for x in (r, k, v, lw, u)]
    out, _ = tops.rwkv_wkv(*leaves, chunk=4, impl="ref")
    assert out.grad_fn is not None
    assert "WkvFunction" not in type(out.grad_fn).__name__
    with pytest.raises(ValueError, match="CUDA"):
        tops.rwkv_wkv(*leaves, chunk=4, impl="cuda")
    with pytest.raises(ValueError, match="drop_carry"):
        rwkv_scan.rwkv_wkv_backward(r, k, v, lw, u, s0, dout, dstate,
                                    chunk=4, drop_carry=True)
    got = rwkv_scan.rwkv_wkv_backward(r, k, v, lw, u, s0, dout, dstate,
                                      chunk=4, need_ds0=False)
    assert got[5] is None and got[0].shape == r.shape
