"""The Mamba layer of the port against the JAX package: the same numpy
inputs and params through ``mamba_forward`` (with and without an initial
state, at several scan chunks), the decode step, the front-pad property
(a zero state passes a masked pad prefix exactly) and the S4D-real
``a_log`` init. Outputs within 1e-4, as the JAX serve tests hold logits;
states within 1e-5 (fp32 rounding: the port's log-step in-chunk scan adds
the reference's terms in another order). fp32 with
``jax_default_matmul_precision="highest"``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as j_get_smoke
from repro.models import mamba as jmamba
from repro.models.params import init_params as j_init_params
from repro_torch.models import mamba as tmamba
from repro_torch.models.params import init_params, params_from_numpy

jax.config.update("jax_default_matmul_precision", "highest")


@pytest.fixture(scope="module")
def layer():
    """One jamba-smoke Mamba layer, with a nonzero conv bias (zero at
    init) so the pad mask has work."""
    cfg = j_get_smoke("jamba_v01_52b")
    jp = j_init_params(jax.random.key(1), jmamba.mamba_param_specs(cfg))
    jp["conv_b"] = jax.random.normal(jax.random.key(2),
                                     jp["conv_b"].shape) * 0.3
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _state(cfg, rng, b):
    conv = rng.standard_normal((b, cfg.ssm_conv_width - 1,
                                cfg.d_inner)).astype(np.float32)
    ssm = (rng.standard_normal((b, cfg.d_inner, cfg.ssm_state_dim))
           * 0.5).astype(np.float32)
    return conv, ssm


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s,chunk", [(12, 4), (13, 8), (16, 256), (9, 1)])
def test_mamba_forward_matches_jax(layer, s, chunk, with_state):
    cfg, jp, tp = layer
    rng = np.random.default_rng(s * 10 + chunk)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    state = _state(cfg, rng, 2) if with_state else None
    jout, (jconv, jssm) = jmamba.mamba_forward(
        jp, jnp.asarray(x), cfg, jnp.float32, chunk=chunk,
        init_state=None if state is None else tuple(map(jnp.asarray, state)),
        return_state=True)
    tout, (tconv, tssm) = tmamba.mamba_forward(
        tp, torch.from_numpy(x), cfg, torch.float32, chunk=chunk,
        init_state=None if state is None else tuple(
            map(torch.from_numpy, state)), return_state=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(tconv.numpy(), np.asarray(jconv))
    np.testing.assert_allclose(tssm.numpy(), np.asarray(jssm), rtol=1e-5,
                               atol=1e-5)


def test_decode_step_matches_jax(layer):
    cfg, jp, tp = layer
    rng = np.random.default_rng(3)
    conv, ssm = _state(cfg, rng, 3)
    jstate = (jnp.asarray(conv), jnp.asarray(ssm))
    tstate = (torch.from_numpy(conv), torch.from_numpy(ssm))
    for step in range(4):
        x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        jout, jstate = jmamba.mamba_decode_step(jp, jnp.asarray(x), jstate,
                                                cfg, jnp.float32)
        tout, tstate = tmamba.mamba_decode_step(tp, torch.from_numpy(x),
                                                tstate, cfg, torch.float32)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {step}")
        for got, want in zip(tstate, jstate):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)


def test_prefill_then_decode_equals_whole_prefill(layer):
    cfg, _, tp = layer
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 10, cfg.d_model)).astype(np.float32))
    whole, (conv, ssm) = tmamba.mamba_forward(tp, x, cfg, torch.float32,
                                              chunk=4, return_state=True)
    part, state = tmamba.mamba_forward(tp, x[:, :7], cfg, torch.float32,
                                       chunk=4, return_state=True)
    outs = [part]
    for t in range(7, 10):
        o, state = tmamba.mamba_decode_step(tp, x[:, t:t + 1], state, cfg,
                                            torch.float32)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), whole.numpy(),
                               rtol=1e-5, atol=1e-5)
    for got, want in zip(state, (conv, ssm)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("pad", [1, 2, 5])
def test_front_pad_mask_keeps_state_exact(layer, pad):
    """The port of the JAX serve test: a front-padded, masked prefill
    reproduces the unpadded output and final state; at the pads the
    output and the scan state stay exactly zero."""
    cfg, _, tp = layer
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32))
    out, (conv, ssm) = tmamba.mamba_forward(tp, x, cfg, torch.float32,
                                            chunk=2, return_state=True)
    xp = torch.cat([torch.zeros((2, pad, cfg.d_model)), x], dim=1)
    mask = (torch.arange(6 + pad)[None, :] >= pad).float().expand(2, -1)
    outp, (convp, ssmp) = tmamba.mamba_forward(
        tp, xp, cfg, torch.float32, chunk=2, return_state=True,
        seq_mask=mask)
    assert torch.all(outp[:, :pad] == 0)
    np.testing.assert_allclose(outp[:, pad:].numpy(), out.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(convp.numpy(), conv.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ssmp.numpy(), ssm.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_fit_chunk_and_init_laws(layer):
    cfg = layer[0]
    assert [tmamba.fit_chunk(s, 8) for s in (1, 7, 12, 13, 16, 40)] == \
        [jmamba.fit_chunk(s, 8) for s in (1, 7, 12, 13, 16, 40)] == \
        [1, 7, 6, 1, 8, 8]
    p = init_params(tmamba.mamba_param_specs(cfg), seed=0, device="cpu")
    want = np.log(np.arange(1, cfg.ssm_state_dim + 1, dtype=np.float32))
    np.testing.assert_array_equal(p["a_log"].numpy(),
                                  np.broadcast_to(want, p["a_log"].shape))
    dt_bias = p["dt_bias"]
    assert float(dt_bias.min()) >= -4.6 and float(dt_bias.max()) <= -2.3
    assert float(dt_bias.std()) > 0.3  # uniform over a 2.3-wide range
    assert torch.all(p["conv_b"] == 0) and torch.all(p["d_skip"] == 1)
