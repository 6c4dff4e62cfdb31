"""Whisper-small backbone [arXiv:2212.04356]: 12L enc + 12L dec, d=768,
12H (MHA), d_ff=3072, vocab=51865. Conv audio frontend is a STUB —
``input_specs`` feeds precomputed 1500-frame embeddings (3000 mel frames /
conv stride 2). GELU MLP, learned positions, LayerNorm, biases.
Same numbers as ``repro/configs/whisper_small.py``."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab_size=51865, head_dim=64,
    attn_type="causal", qkv_bias=True, pos_emb="learned", mlp_act="gelu",
    encoder_layers=12, encoder_seq=1500, cross_attention=True,
    norm_eps=1e-5,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=211, head_dim=16,
    attn_type="causal", qkv_bias=True, pos_emb="learned", mlp_act="gelu",
    encoder_layers=2, encoder_seq=12, cross_attention=True, norm_eps=1e-5,
)
