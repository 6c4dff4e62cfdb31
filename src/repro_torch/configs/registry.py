"""Architecture registry of the PyTorch port.

A copy of ``repro/configs/registry.py`` trimmed to the architectures:
each lives in ``repro_torch/configs/<id>.py`` and exposes ``CONFIG`` (the
published numbers) and ``SMOKE`` (a reduced same-family config for CPU
tests). Every architecture of the reference resolves.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

# every architecture of the reference registry (repro/configs/registry.py)
ARCH_IDS = (
    "whisper_small",
    "kimi_k2_1t_a32b",
    "mixtral_8x22b",
    "jamba_v01_52b",
    "qwen2_vl_7b",
    "internlm2_1_8b",
    "qwen2_0_5b",
    "phi4_mini_3_8b",
    "qwen2_5_3b",
    "rwkv6_1_6b",
)


def canonical(arch: str) -> str:
    """Public ids use dashes and dots; module names use underscores."""
    return arch.replace("-", "_").replace(".", "_")


def _module(arch: str):
    name = canonical(arch)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch!r}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_arch(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
