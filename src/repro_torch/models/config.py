"""Model configuration schema for the assigned architectures (a copy of
``repro.models.config`` for the port: pure dataclasses, field for field).

One ``ModelConfig`` describes any of the 10 assigned LM-family archs (plus
reduced smoke variants).  The layer stack is a *super-block pattern*: a
tuple of ``LayerSpec`` repeated ``n_layers / len(pattern)`` times, which
keeps heterogeneous stacks (gemma2 local/global alternation, zamba2 shared
attention, xLSTM mLSTM/sLSTM mix) scannable.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0       # deepseek: always-on shared experts
    dense_residual: bool = False    # arctic: dense MLP in parallel with MoE
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2
    router_z_weight: float = 1e-3


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) / mLSTM / sLSTM block geometry."""

    state_dim: int = 64             # N
    head_dim: int = 64              # P
    expand: int = 2                 # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 256                # SSD / chunked-mLSTM chunk length
    n_groups: int = 1               # B/C groups (mamba2)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer of a super-block: a sequence mixer + an MLP kind."""

    mixer: str          # attn | attn_local | mla | mamba2 | mlstm | slstm
                        # | shared_attn (weights shared across repeats)
    mlp: str = "dense"  # dense | moe | moe_dense | none


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    block_pattern: Tuple[LayerSpec, ...] = (LayerSpec("attn"),)

    # attention details
    head_pad_to: int = 0            # pad q heads so TP divides (0 = off)
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0      # stablelm: 0.25 partial rotary
    qkv_bias: bool = False          # qwen2
    attn_softcap: float = 0.0       # gemma2: 50.0
    final_softcap: float = 0.0      # gemma2: 30.0
    local_window: int = 0           # attn_local blocks (gemma2: 4096)
    post_norms: bool = False        # gemma2 pre+post sandwich norms
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    norm_eps: float = 1e-6
    mlp_act: str = "silu"           # silu | gelu (gated unless *_plain)
    mlp_gated: bool = True
    tie_embeddings: bool = False
    scale_embeddings: bool = False  # gemma: x * sqrt(d_model)

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # encoder-decoder (whisper): encoder is bidirectional, decoder adds
    # cross-attention to the encoder output.
    encoder_layers: int = 0
    encoder_seq: int = 1500         # post-conv stub frames
    # vlm stub: vision embeddings occupy the first `vision_tokens` slots.
    vision_tokens: int = 0
    vision_dim: int = 0

    # numerics / execution
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    seq_parallel: bool = False      # shard boundary activations on seq
    attn_chunk_q: int = 1024        # blocked-attention chunk sizes
    attn_chunk_k: int = 1024
    blocked_attn_threshold: int = 8192   # use blocked attn for S >= this
    loss_chunk: int = 2048          # CE computed per seq chunk (0 = off)
    # layers outside the scanned pattern (deepseek-v2 dense layer 0)
    prologue: Tuple[LayerSpec, ...] = ()

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_pattern_layers(self) -> int:
        return self.n_layers - len(self.prologue)

    @property
    def n_super(self) -> int:
        p = len(self.block_pattern)
        if self.n_pattern_layers % p:
            raise ValueError(
                f"{self.name}: {self.n_pattern_layers} layers not divisible "
                f"by pattern length {p}")
        return self.n_pattern_layers // p

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if no mixer needs a full O(S^2) attention at 500k context."""
        mixers = {s.mixer for s in self.block_pattern + self.prologue}
        full_attn = {"attn", "mla"}
        return not (mixers & full_attn)

    def validate(self) -> None:
        _ = self.n_super
        if self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be divisible by n_kv_heads")
        for spec in self.block_pattern + self.prologue:
            if spec.mlp in ("moe", "moe_dense") and self.moe is None:
                raise ValueError("moe layers require MoEConfig")
            if spec.mixer == "mla" and self.mla is None:
                raise ValueError("mla mixer requires MLAConfig")
            if spec.mixer in ("mamba2", "mlstm", "slstm") and self.ssm is None:
                raise ValueError(f"{spec.mixer} requires SSMConfig")
