"""Qwen2-0.5B [arXiv:2407.10671]: 24L, d_model=896, 14H GQA kv=2
(head_dim 64), d_ff=4864, vocab=151936, QKV bias, tied embeddings.
Same numbers as ``repro/configs/qwen2_0_5b.py``."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab_size=151936, head_dim=64, qkv_bias=True, rope_theta=1e6,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2-smoke", family="dense",
    n_layers=2, d_model=48, n_heads=6, n_kv_heads=2, d_ff=96,
    vocab_size=211, head_dim=8, qkv_bias=True, tie_embeddings=True,
)
