"""Phi-4-mini-3.8B [arXiv:2412.08905]: 32L, d_model=3072, 24H GQA kv=8
(head_dim 128), d_ff=8192, vocab=200064, RoPE + SwiGLU + GQA, tied
embeddings.
Same numbers as ``repro/configs/phi4_mini_3_8b.py``."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192,
    vocab_size=200064, head_dim=128, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="phi4-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=211, head_dim=16, tie_embeddings=True,
)
