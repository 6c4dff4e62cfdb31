"""InternLM2-1.8B [arXiv:2403.17297]: 24L, d_model=2048, 16H GQA kv=8
(head_dim 128), d_ff=8192, vocab=92544, SwiGLU, RoPE theta 1e6.
Same numbers as ``repro/configs/internlm2_1_8b.py``."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
    vocab_size=92544, head_dim=128, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="internlm2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=211, head_dim=16,
)
