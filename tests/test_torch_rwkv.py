"""The RWKV-6 WKV and the rwkv6 model functions of the port against the
JAX package: the same numpy inputs through both sides.

* ``ref.rwkv_wkv_ref`` (the token-serial oracle) against JAX
  ``ops.rwkv_wkv`` with ``impl="ref"`` and with ``impl="interpret"`` (the
  Pallas kernel in interpret mode), at the shapes of the JAX kernel tests.
* ``chunked_wkv_plain`` (the CUDA kernel's plain version) against JAX
  ``rwkv6._chunked_wkv`` from a nonzero initial state at chunks 1, 4, 8,
  13 and 16: the output and the final state.
* ``rwkv_time_mix`` and ``rwkv_channel_mix`` with state in and out; a
  prefill split into a shorter prefill plus decode steps equals the whole
  prefill; the constant-decay closed form.

Tolerances: 1e-5 for the WKV, of the largest |value| of the compared
tensor (at least 1): fp32 rounding of the same sums in another order, and
of the cumulative log decay, whose rounding (up to ~64 * eps at chunk 16)
the factors exp(cum_excl) and exp(-cum) carry into every score; 2e-4
against the Pallas kernel in interpret mode (the JAX kernel tests' own);
1e-4 for the sublayer outputs, as the JAX serve tests hold logits. fp32
with ``jax_default_matmul_precision="highest"``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as j_get_smoke
from repro.kernels import ops as jops
from repro.models import rwkv6 as jrwkv
from repro.models.params import init_params as j_init_params
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv_scan
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.blocks import ModelContext as TCtx
from repro_torch.models.params import params_from_numpy

jax.config.update("jax_default_matmul_precision", "highest")

WKV_TOL = 1e-5


def _inputs(seed, shape, hd):
    """r, k, v ~ N(0, 1), logw = clip(-exp(N(0, 1)), -4, 0), u ~ N(0,
    0.25) over heads: numpy f32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    lw = np.clip(-np.exp(rng.standard_normal(shape)), -4.0,
                 0.0).astype(np.float32)
    u = (rng.standard_normal((shape[-2] if len(shape) == 4 else shape[0],
                              hd)) * 0.5).astype(np.float32)
    return r, k, v, lw, u


def _close(got, want, tol=WKV_TOL):
    """max |got - want| <= tol * max(1, max |want|)."""
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("s,hd,chunk", [(64, 16, 16), (128, 32, 16),
                                        (48, 16, 8)])
def test_serial_oracle_matches_jax_ref_and_interpret(s, hd, chunk):
    """(BH, S, hd) layout, zero initial state."""
    r, k, v, lw, u = _inputs(s + hd, (3, s, hd), hd)
    got = tref.rwkv_wkv_ref(*_t(r, k, v, lw, u)).numpy()
    jargs = [jnp.asarray(x) for x in (r, k, v, lw, u)]
    want = np.asarray(jops.rwkv_wkv(*jargs, impl="ref"))
    np.testing.assert_allclose(got, want, rtol=WKV_TOL, atol=WKV_TOL)
    pallas = np.asarray(jops.rwkv_wkv(*jargs, impl="interpret",
                                      chunk=chunk))
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("chunk", [1, 4, 8, 13, 16])
def test_chunked_plain_matches_jax_chunked_wkv(chunk):
    """(B, S, H, hd) with a nonzero initial state: out and s_final."""
    b, h, hd = 2, 3, 16
    s = 4 * chunk if chunk != 13 else 26
    r, k, v, lw, u = _inputs(chunk, (b, s, h, hd), hd)
    s0 = np.random.default_rng(99).standard_normal(
        (b, h, hd, hd)).astype(np.float32)
    out, sf = rwkv_scan.chunked_wkv_plain(*_t(r, k, v, lw, u, s0),
                                          chunk=chunk)
    jout, jsf = jrwkv._chunked_wkv(*[jnp.asarray(x) for x in
                                     (r, k, v, lw, u, s0)], chunk=chunk)
    _close(out.numpy(), jout)
    _close(sf.numpy(), jsf)
    # ops.rwkv_wkv("ref") is the same function; state_out takes the state
    # in place, here the initial state's own tensor
    ts0 = torch.from_numpy(s0.copy())
    out2, sf2 = tops.rwkv_wkv(*_t(r, k, v, lw, u), ts0, chunk=chunk,
                              impl="ref", state_out=ts0)
    assert sf2 is ts0
    assert torch.equal(out2, out) and torch.equal(ts0, sf)


def test_chunked_plain_zero_state_is_the_serial_oracle():
    b, s, h, hd = 2, 32, 2, 16
    r, k, v, lw, u = _inputs(5, (b, s, h, hd), hd)
    out, _ = rwkv_scan.chunked_wkv_plain(*_t(r, k, v, lw, u), chunk=16)
    flat = lambda x: torch.from_numpy(x).permute(0, 2, 1, 3).reshape(
        b * h, s, hd)
    want = tref.rwkv_wkv_ref(flat(r), flat(k), flat(v), flat(lw),
                             torch.from_numpy(np.tile(u, (b, 1))))
    np.testing.assert_allclose(
        out.permute(0, 2, 1, 3).reshape(b * h, s, hd).numpy(),
        want.numpy(), rtol=WKV_TOL, atol=WKV_TOL)


def test_chunked_plain_refuses_bad_chunks():
    r, k, v, lw, u = _t(*_inputs(0, (1, 32, 2, 16), 16))
    with pytest.raises(ValueError, match="chunk"):
        rwkv_scan.chunked_wkv_plain(r, k, v, lw, u, chunk=32)
    with pytest.raises(ValueError, match="%"):
        rwkv_scan.chunked_wkv_plain(r, k, v, lw, u, chunk=5)
    with pytest.raises(ValueError, match="CUDA"):
        tops.rwkv_wkv(r, k, v, lw, u, chunk=16, impl="cuda")


@pytest.mark.parametrize("decay", [-4.0, -1.0, -0.3, -0.01])
@pytest.mark.parametrize("s", [16, 48])
def test_constant_decay_is_ema(decay, s):
    """With constant decay, r = k = e_0 and v = 1 the WKV is a 1-channel
    exponentially weighted sum: out_t = (1 - w^t) / (1 - w)."""
    hd = 16
    r = torch.zeros((1, s, 1, hd))
    r[..., 0] = 1.0
    k = r.clone()
    v = torch.ones((1, s, 1, hd))
    lw = torch.full((1, s, 1, hd), decay)
    u = torch.zeros((1, hd))
    out, _ = rwkv_scan.chunked_wkv_plain(r, k, v, lw, u, chunk=16)
    w = np.exp(decay)
    t = np.arange(s)
    np.testing.assert_allclose(out[0, :, 0, 0].numpy(),
                               (1 - w ** t) / (1 - w), rtol=1e-4, atol=1e-4)
    serial = tref.rwkv_wkv_ref(r[:, :, 0], k[:, :, 0], v[:, :, 0],
                               lw[:, :, 0], u)
    np.testing.assert_allclose(serial[0, :, 0].numpy(),
                               (1 - w ** t) / (1 - w), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ model functions


@pytest.fixture(scope="module")
def layer():
    """One rwkv6-smoke layer's time-mix and channel-mix params, both
    sides."""
    cfg = j_get_smoke("rwkv6_1_6b")
    specs = {"core": jrwkv.rwkv_param_specs(cfg),
             "mlp": jrwkv.rwkv_channel_specs(cfg)}
    jp = j_init_params(jax.random.key(3), specs)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _ctx(chunk):
    return TCtx(compute_dtype=torch.float32, rwkv_chunk=chunk, device="cpu")


@pytest.mark.parametrize("s,chunk", [(12, 4), (13, 16), (16, 8)])
def test_time_mix_and_channel_mix_with_state(layer, s, chunk):
    cfg, jp, tp = layer
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    tok = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    wkv = (rng.standard_normal((2, h, hd, hd)) * 0.3).astype(np.float32)
    jout, (jtok, jwkv) = jrwkv.rwkv_time_mix(
        jp["core"], jnp.asarray(x), cfg, jnp.float32, chunk=chunk,
        init_state=(jnp.asarray(tok), jnp.asarray(wkv)), return_state=True)
    tout, (ttok, twkv) = trwkv.rwkv_time_mix(
        tp["core"], torch.from_numpy(x), cfg, _ctx(chunk),
        init_state=(torch.from_numpy(tok), torch.from_numpy(wkv)),
        return_state=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(twkv.numpy(), np.asarray(jwkv), rtol=1e-4,
                               atol=1e-4)
    # from a zero state, no state returned
    jz = jrwkv.rwkv_time_mix(jp["core"], jnp.asarray(x), cfg, jnp.float32,
                             chunk=chunk)
    tz = trwkv.rwkv_time_mix(tp["core"], torch.from_numpy(x), cfg,
                             _ctx(chunk))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-4,
                               atol=1e-4)
    jcm, jprev = jrwkv.rwkv_channel_mix(
        jp["mlp"], jnp.asarray(x), cfg, jnp.float32, prev=jnp.asarray(tok),
        return_state=True)
    tcm, tprev = trwkv.rwkv_channel_mix(
        tp["mlp"], torch.from_numpy(x), cfg, torch.float32,
        prev=torch.from_numpy(tok), return_state=True)
    np.testing.assert_allclose(tcm.numpy(), np.asarray(jcm), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(tprev.numpy(), np.asarray(jprev))


def test_prefill_plus_decode_steps_equals_whole_prefill(layer):
    """16 tokens in one call equal 10 tokens, then 6 one-token steps that
    carry (token shift, WKV state)."""
    cfg, _, tp = layer
    ctx = _ctx(4)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    whole, (tok, wkv) = trwkv.rwkv_time_mix(tp["core"], x, cfg, ctx,
                                            return_state=True)
    part, state = trwkv.rwkv_time_mix(tp["core"], x[:, :10], cfg, ctx,
                                      return_state=True)
    outs = [part]
    for t in range(10, 16):
        o, state = trwkv.rwkv_time_mix(tp["core"], x[:, t:t + 1], cfg, ctx,
                                       init_state=state, return_state=True)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), whole.numpy(),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(state[0], tok)
    np.testing.assert_allclose(state[1].numpy(), wkv.numpy(), rtol=1e-4,
                               atol=1e-4)
