"""Unified model configuration covering all assigned architecture families.

One ``ModelConfig`` describes any of: dense decoder-only transformers (GQA,
optional QKV bias, RoPE/M-RoPE), MoE transformers (top-k routing, optional
sliding-window attention), hybrid Mamba/attention stacks (Jamba-style block
patterns), attention-free RWKV6, and encoder-decoder audio models (Whisper)
whose modality frontend is a stub (precomputed frame/patch embeddings).

Layer stacks are described as repeated *blocks* of ``block_len`` sublayers
(scan runs over blocks). ``sublayer_kinds()`` expands the per-block pattern:
most archs are 1 block-layer of kind "attn"; Jamba uses block_len=8 with
attention at one position and Mamba elsewhere, MoE on every 2nd sublayer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # attention
    attn_type: str = "causal"  # causal | bidirectional
    qkv_bias: bool = False
    sliding_window: Optional[int] = None  # tokens; None = full attention
    rope_theta: float = 1e4
    pos_emb: str = "rope"  # rope | mrope | learned | none
    mrope_sections: Tuple[int, ...] = ()  # head_dim/2 split for M-RoPE

    # mlp
    mlp_act: str = "swiglu"  # swiglu | gelu

    # moe
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1  # MoE on sublayers where (idx % moe_every)==moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # ssm (mamba) / rwkv
    ssm_state_dim: int = 16
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_dt_rank: int = 0  # 0 -> ceil(d_model/16)
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 128

    # block structure (scan unit)
    block_len: int = 1
    attn_positions: Tuple[int, ...] = (0,)  # which sublayers are attention
    default_kind: str = "attn"  # kind of non-attention sublayers

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0  # precomputed frames fed to the encoder stub
    cross_attention: bool = False

    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # ------------------------------------------------------------------

    def __post_init__(self) -> None:
        if self.n_layers % self.block_len:
            raise ValueError("n_layers must be a multiple of block_len")
        if self.n_heads and self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must divide by n_kv_heads")

    @property
    def n_blocks(self) -> int:
        return self.n_layers // self.block_len

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode against a 500k context with bounded state?

        True for attention-free (rwkv), hybrid (jamba: only 1-in-8 layers
        keep KV), and sliding-window attention (bounded KV)."""
        kinds = set(self.sublayer_kinds())
        if "attn" not in kinds:
            return True
        if kinds - {"attn"}:
            return True  # hybrid
        return self.sliding_window is not None

    def sublayer_kinds(self) -> Tuple[str, ...]:
        """Kinds of the ``block_len`` sublayers inside one scan block."""
        return tuple(
            "attn" if i in self.attn_positions else self.default_kind
            for i in range(self.block_len)
        )

    def sublayer_has_moe(self, idx: int) -> bool:
        if not self.n_experts:
            return False
        return idx % self.moe_every == self.moe_offset

    def moe_mask(self) -> Tuple[bool, ...]:
        return tuple(self.sublayer_has_moe(i) for i in range(self.block_len))

    # ---- parameter counting (used for 6*N*D and config validation) -------

    def attn_params(self) -> int:
        hd = self.resolved_head_dim
        q = self.d_model * self.n_heads * hd
        kv = 2 * self.d_model * self.n_kv_heads * hd
        o = self.n_heads * hd * self.d_model
        bias = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + bias

    def dense_mlp_params(self) -> int:
        mult = 3 if self.mlp_act == "swiglu" else 2
        return mult * self.d_model * self.d_ff

    def expert_mlp_params(self) -> int:
        mult = 3 if self.mlp_act == "swiglu" else 2
        return mult * self.d_model * self.d_ff

    def mamba_params(self) -> int:
        di, n, dr = self.d_inner, self.ssm_state_dim, self.dt_rank
        return (self.d_model * 2 * di  # in_proj (x and gate)
                + di * self.ssm_conv_width  # depthwise conv
                + di * (dr + 2 * n)  # x -> (dt, B, C)
                + dr * di  # dt_proj
                + di * n  # A_log
                + di  # D
                + di * self.d_model)  # out_proj

    def rwkv_params(self) -> int:
        d = self.d_model
        # r,k,v,g,o projections + data-dependent decay lora + time-mix params
        lora = d * 64 * 2 + d * 32 * 2
        return 5 * d * d + lora + 4 * d

    def params_per_sublayer(self, idx: int) -> int:
        kind = self.sublayer_kinds()[idx]
        if kind == "attn":
            core = self.attn_params()
        elif kind == "mamba":
            core = self.mamba_params()
        elif kind == "rwkv":
            core = self.rwkv_params()
        else:
            raise ValueError(kind)
        if kind == "rwkv":
            # rwkv channel-mix replaces the MLP (2 mats)
            mlp = 2 * self.d_model * self.d_ff
        elif self.sublayer_has_moe(idx):
            mlp = self.n_experts * self.expert_mlp_params() + (
                self.d_model * self.n_experts)  # router
        else:
            mlp = self.dense_mlp_params()
        norms = 2 * self.d_model
        return core + mlp + norms

    def total_params(self) -> int:
        per_block = sum(self.params_per_sublayer(i)
                        for i in range(self.block_len))
        total = per_block * self.n_blocks
        total += self.vocab_size * self.d_model  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model  # lm head
        total += self.d_model  # final norm
        if self.is_encoder_decoder:
            enc_layer = (self.attn_params() + self.dense_mlp_params()
                         + 2 * self.d_model)
            total += self.encoder_layers * enc_layer
            # decoder cross-attention blocks
            total += self.n_layers * (self.attn_params() + self.d_model)
            total += self.encoder_seq * self.d_model  # learned enc pos emb
        if self.pos_emb == "learned":
            total += 32768 * self.d_model  # learned decoder pos table
            # (models/encdec.MAX_DEC_POSITIONS, sized for decode_32k)
        return int(total)

    def active_params(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if not self.n_experts:
            total = self.total_params()
        else:
            per_block = 0
            for i in range(self.block_len):
                p = self.params_per_sublayer(i)
                if self.sublayer_has_moe(i):
                    p -= (self.n_experts - self.experts_per_token) * \
                        self.expert_mlp_params()
                per_block += p
            total = per_block * self.n_blocks
            total += self.vocab_size * self.d_model * (
                1 if self.tie_embeddings else 2)
            total += self.d_model
        return int(total)
