import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def run_in_subprocess(code: str, devices: int = 8, timeout: int = 420) -> str:
    """Run python code in a fresh process with N fake XLA devices.

    Multi-device tests must not pollute this process (jax locks the device
    count at first init), so anything needing a mesh > 1 runs here.
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={devices} "
                        + env.get("XLA_FLAGS", ""))
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(
            f"subprocess failed (rc={proc.returncode}):\n--- stdout ---\n"
            f"{proc.stdout[-4000:]}\n--- stderr ---\n{proc.stderr[-4000:]}")
    return proc.stdout


@pytest.fixture
def subproc():
    return run_in_subprocess


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU with nvcc (hand-written CUDA "
        "kernels have no CPU mode); skipped where torch sees no card")
