"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892]: 24L, d_model=2048, attention-
free (32 heads x 64 head_dim WKV state), channel-mix d_ff=7168,
vocab=65536. Data-dependent decay linear recurrence; constant-size decode
state.
Same numbers as ``repro/configs/rwkv6_1_6b.py``."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=0, n_kv_heads=0, d_ff=7168,
    vocab_size=65536,
    attn_positions=(), default_kind="rwkv", rwkv_head_dim=64,
    pos_emb="none",
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=128,
    vocab_size=211, attn_positions=(), default_kind="rwkv",
    rwkv_head_dim=16, pos_emb="none",
)
