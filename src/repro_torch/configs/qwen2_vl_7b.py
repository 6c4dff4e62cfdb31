"""Qwen2-VL-7B backbone [arXiv:2409.12191]: 28L, d_model=3584, 28H GQA kv=4
(head_dim 128), d_ff=18944, vocab=152064. M-RoPE with (16,24,24) sections
over the 64 rotary frequencies; QKV bias. The vision encoder is a STUB —
``input_specs`` supplies merged token embeddings + (3,B,S) position ids.
Same numbers as ``repro/configs/qwen2_vl_7b.py``."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab_size=152064, head_dim=128,
    qkv_bias=True, rope_theta=1e6,
    pos_emb="mrope", mrope_sections=(16, 24, 24),
)

SMOKE = ModelConfig(
    name="qwen2vl-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=211, head_dim=16,
    qkv_bias=True, pos_emb="mrope", mrope_sections=(4, 2, 2),
)
