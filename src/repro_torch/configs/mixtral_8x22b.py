"""Mixtral 8x22B [arXiv:2401.04088]: 56L, d_model=6144, 48H GQA kv=8
(head_dim 128), d_ff=16384, vocab=32768, 8 experts top-2, sliding-window
attention (4096), untied lm head. Same numbers as
``repro/configs/mixtral_8x22b.py``."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=32768, head_dim=128,
    rope_theta=1e6, sliding_window=4096,
    n_experts=8, experts_per_token=2, capacity_factor=1.25,
)

SMOKE = ModelConfig(
    name="mixtral-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=96,
    vocab_size=211, head_dim=8, sliding_window=8,
    n_experts=4, experts_per_token=2,
)
