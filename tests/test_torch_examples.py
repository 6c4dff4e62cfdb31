"""The port's ``serve_decode`` and ``failure_recovery`` examples against
the reference's ``examples/serve_decode.py`` and
``examples/failure_recovery.py``, loaded from their files (nothing in
them changes).

* ``serve_decode``: at temperature 0, each family's engine (qwen2.5-3B
  paged, Mixtral paged with fp8 weights, rwkv6 on the dense slots) gives
  the reference engine's greedy tokens on the same parameters, with the
  reference example's engine settings and prompts; ``main`` prints the
  reference's three lines (the same fields, the reference engine's 3
  host syncs).
* ``failure_recovery``: ``main`` prints ``loss trajectories identical:
  True``; from the reference's weights, the clean run's 30 losses equal
  the reference's ``run({}, ...)`` to f32 rounding (rtol 1e-5 at every
  step; they read within 3e-7 on the CPU).

fp32 with ``jax_default_matmul_precision="highest"``."""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import api as japi
from repro.models.params import init_params as j_init_params
from repro_torch.examples import failure_recovery as tfr
from repro_torch.examples import serve_decode as tsd
from repro_torch.launch import train as train_launch
from repro_torch.models.params import params_from_numpy

jax.config.update("jax_default_matmul_precision", "highest")

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jsd():
    return _load("serve_decode")


@pytest.fixture(scope="module")
def jfr():
    return _load("failure_recovery")


def _prompts():
    """The reference example's prompts: one numpy generator seeded 0,
    drawn family after family."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, tsd.get_smoke(arch).vocab_size,
                         (tsd.PROMPTS, tsd.PROMPT_LEN)).astype(np.int32)
            for arch, _ in tsd.FAMILIES]


def test_families_are_the_reference_s():
    assert [a for a, _ in tsd.FAMILIES] == ["qwen2_5_3b", "mixtral_8x22b",
                                            "rwkv6_1_6b"]
    assert tsd.FAMILIES[1][1] == torch.float8_e4m3fn
    assert (tsd.WINDOW, tsd.MAX_BATCH, tsd.CHUNK) == (48, 4, 8)
    assert (tsd.PROMPTS, tsd.PROMPT_LEN, tsd.MAX_NEW) == (4, 16, 24)


@pytest.mark.parametrize("family", range(3))
def test_greedy_tokens_match_the_reference_engine(family, jsd):
    arch, quant = tsd.FAMILIES[family]
    prompts = _prompts()[family]
    cfg = jsd.get_smoke(arch)
    jp = j_init_params(jax.random.key(0), japi.model_specs(cfg))
    npp = jax.tree.map(np.asarray, jp)
    if quant is not None:
        jp = jsd.quantize_weights(jp, jnp.float8_e4m3fn)
    ctx = jsd.ModelContext(compute_dtype=jnp.float32, q_chunk=512,
                           mamba_chunk=16, rwkv_chunk=8)
    je = jsd.ServeEngine(cfg, ctx, window=48, max_batch=4, chunk=8)
    want = np.asarray(je.generate(jp, {"tokens": jnp.asarray(prompts)},
                                  max_new=24, temperature=0.0))
    engine = tsd.make_engine(arch, "cpu")
    got, _ = tsd.serve(engine, params_from_numpy(npp, device="cpu"), quant,
                       prompts, 0.0)
    assert engine.paged == je.paged == (arch != "rwkv6_1_6b")
    np.testing.assert_array_equal(got.numpy(), want)
    assert engine.counters["host_syncs"] == je.counters["host_syncs"] == 3


LINE = re.compile(r"^(\S+) +\[(fp8|fp32) weights *\|(paged|dense)\] "
                  r"4x24 tokens in +[\d.]+s \( *[\d.]+ tok/s, (\d+) host "
                  r"syncs\) sample=\[[\d ]+\]$")


def test_main_prints_the_reference_lines(capsys):
    lines = tsd.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out == lines and len(lines) == 3
    want = (("qwen2_5_3b", "fp32", "paged"), ("mixtral_8x22b", "fp8",
                                              "paged"),
            ("rwkv6_1_6b", "fp32", "dense"))
    for line, (arch, q, mode) in zip(lines, want):
        m = LINE.match(line)
        assert m, line
        assert m.groups()[:3] == (arch, q, mode)
        assert line.startswith(f"{arch:18s} [{q} weights")
        # one host sync a chunk: 24 new tokens in chunks of 8, as the
        # reference engine's greedy run counts them
        assert int(m.group(4)) == 3


def test_failure_recovery_main_replays_exactly(capsys):
    assert tfr.main(["--device", "cpu"]) is True
    out = capsys.readouterr().out
    assert "loss trajectories identical: True" in out
    assert "OK: failures recovered with exact-replay semantics" in out
    assert re.search(r"failure goodput: [\d.]+ \(rework [\d.]+s, restore "
                     r"[\d.]+s, detect [\d.]+s\)", out)


def test_failure_recovery_clean_losses_match_the_reference(
        jfr, tmp_path, monkeypatch):
    """The twin's trainer starts from the reference's seed-0 weights (the
    port draws its own from seed 0 otherwise)."""
    assert tfr.STEPS == jfr.STEPS == 30
    want, _ = jfr.run({}, str(tmp_path / "jax"))
    cfg = jfr.get_smoke("internlm2_1_8b")
    npp = jax.tree.map(np.asarray, j_init_params(jax.random.key(0),
                                                 japi.model_specs(cfg)))
    init = train_launch.init_train_state

    def from_reference(*args, **kwargs):
        state = init(*args, **kwargs)
        state["params"] = params_from_numpy(npp, device="cpu")
        return state

    monkeypatch.setattr(train_launch, "init_train_state", from_reference)
    got, _ = tfr.run({}, str(tmp_path / "torch"), device="cpu")
    assert len(got) == len(want) == 30
    np.testing.assert_allclose(got, want, rtol=1e-5)
