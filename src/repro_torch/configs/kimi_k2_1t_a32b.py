"""Kimi K2: trillion-parameter MoE. 61L, d_model=7168, 64H GQA kv=8
(head_dim 112), expert d_ff=2048, vocab=163840, 384 experts top-8.
Same numbers as ``repro/configs/kimi_k2_1t_a32b.py``; the port runs its
smoke config only (the CPU parity tests)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab_size=163840, head_dim=112,
    rope_theta=5e4,
    n_experts=384, experts_per_token=8, capacity_factor=1.25,
)

SMOKE = ModelConfig(
    name="kimi-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=32,
    vocab_size=211, head_dim=8,
    n_experts=8, experts_per_token=2, capacity_factor=1.25,
)
