"""Jamba v0.1 [arXiv:2403.19887]: hybrid Mamba+attention, 1:7 interleave.
32L, d_model=4096, 32H GQA kv=8 (head_dim 128), d_ff=14336, vocab=65536,
MoE 16e top-2 on every 2nd sublayer. Scan unit = 8-sublayer Jamba block
(attention at position 4, Mamba elsewhere).
Same numbers as ``repro/configs/jamba_v01_52b.py``."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=65536, head_dim=128,
    pos_emb="none",  # Jamba uses no positional encoding (Mamba provides it)
    n_experts=16, experts_per_token=2, moe_every=2, moe_offset=1,
    block_len=8, attn_positions=(4,), default_kind="mamba",
    ssm_state_dim=16, ssm_expand=2, ssm_conv_width=4,
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=211, head_dim=16, pos_emb="none",
    n_experts=4, experts_per_token=2, moe_every=2, moe_offset=1,
    block_len=4, attn_positions=(1,), default_kind="mamba",
    ssm_state_dim=4,
)
