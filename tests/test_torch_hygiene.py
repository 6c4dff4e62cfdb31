"""The port stands alone: no file under src/repro_torch imports JAX or the
JAX package, every module imports with both blocked, and its entry points
refuse to fall back to the CPU silently."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.registry import get_smoke
from repro_torch.core.sdc import FBIST
from repro_torch.examples import (dlrm_sparsecore, failure_recovery,
                                  quickstart, serve_decode)
from repro_torch.fleet import run_bridge
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import trace_gate
from repro_torch.launch import train as launch_train
from repro_torch.models import api
from repro_torch.models.blocks import ModelContext
from repro_torch.models.params import init_params
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.faults import startup_bist

SRC = Path(__file__).resolve().parent.parent / "src"
PKG = SRC / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import jax|from jax|import repro\.|from repro\.|import repro$"
    r"|from repro import)", re.M)


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_no_file_imports_jax_or_the_reference():
    bad = [str(p.relative_to(SRC)) for p in PKG.rglob("*.py")
           if FORBIDDEN.search(p.read_text())]
    assert not bad, bad


def test_every_module_imports_with_jax_and_repro_blocked():
    mods = list(_modules())
    assert "repro_torch.serve.engine" in mods
    assert "repro_torch.examples.dlrm_sparsecore" in mods
    assert "repro_torch.fleet.sim" in mods
    assert "repro_torch.launch.trace_gate" in mods
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = get_smoke("qwen2_0_5b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(api.model_specs(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, ModelContext(), window=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "qwen2_0_5b", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "qwen2_0_5b", "--smoke", "--bist"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        startup_bist()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dlrm_sparsecore.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_decode.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        failure_recovery.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FBIST().run(lambda a, b: a @ b)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_bridge()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trace_gate.main(["serve_trace.json", "serve_steptrace.json"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main(["--steps", "1"])
    with pytest.raises(ValueError, match="CUDA"):
        startup_bist(device="cpu")  # the kernels need CUDA tensors
    with pytest.raises(ValueError, match="CUDA device"):
        ModelContext(attn_impl="cuda", device="cpu")
    ctx = ModelContext(device="cpu")
    assert ctx.attn_impl == "ref" and ctx.device.type == "cpu"


def test_launcher_serves_a_trace_on_the_cpu(capsys):
    launch_serve.main(["--arch", "qwen2_0_5b", "--smoke", "--trace", "4",
                       "--device", "cpu", "--draft-k", "2", "--kv-int8"])
    out = capsys.readouterr().out
    assert "4 requests" in out and "host_syncs=" in out
    assert "prefix_hit_rate=" in out


def test_train_launcher_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "qwen2_0_5b", "--smoke",
                           "--ckpt-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_train_launcher_trains_a_smoke_trace_on_the_cpu(tmp_path, capsys):
    launch_train.main(["--arch", "qwen2_0_5b", "--smoke", "--steps", "6",
                       "--batch", "2", "--seq", "16", "--ckpt-every", "2",
                       "--fail-at", "3", "--ckpt-dir", str(tmp_path),
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "trained 6 effective steps" in out
    assert "replayed=1" in out and "goodput=" in out and "tok/s" in out
    carbon = [line for line in out.splitlines()
              if line.startswith("carbon:")]
    assert len(carbon) == 1
    assert "the paper's Ironwood CCI" in carbon[0]
    assert "not a measurement of this device" in carbon[0]
    flops = 6.0 * get_smoke("qwen2_0_5b").active_params() * 2 * 16 * 6
    assert f"'flops': '{flops:.3e}'" in carbon[0]
    for key in ("'gco2e_market'", "'gco2e_location'"):
        assert key in carbon[0]
