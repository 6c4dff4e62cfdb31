"""Qwen2.5-3B [hf:Qwen/Qwen2.5-3B]: 36L, d_model=2048, 16H GQA kv=2
(head_dim 128), d_ff=11008, vocab=151936, QKV bias, tied embeddings.
Same numbers as ``repro/configs/qwen2_5_3b.py``."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_ff=11008,
    vocab_size=151936, head_dim=128, qkv_bias=True, rope_theta=1e6,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen25-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=211, head_dim=16, qkv_bias=True, tie_embeddings=True,
)
