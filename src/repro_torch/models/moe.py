"""Dense FFN (``repro.models.moe.dense_ffn``). The MoE dispatch paths of
the reference are not ported yet."""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.ops import gelu, swiglu
from repro_torch.models.params import ParamSpec


def dense_ffn(params: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig, compute_dtype: torch.dtype) -> torch.Tensor:
    up = x @ params["w_up"].to(compute_dtype)
    if cfg.mlp_act == "swiglu":
        h = swiglu(x @ params["w_gate"].to(compute_dtype), up)
    else:
        h = gelu(up)
    return h @ params["w_down"].to(compute_dtype)


def dense_ffn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    specs = {
        "w_up": ParamSpec((d, f), ("embed", "mlp")),
        "w_down": ParamSpec((f, d), ("mlp", "embed")),
    }
    if cfg.mlp_act == "swiglu":
        specs["w_gate"] = ParamSpec((d, f), ("embed", "mlp"))
    return specs
