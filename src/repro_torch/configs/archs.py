"""The 10 assigned architectures, exact published configs (copied field
for field from ``repro.configs.archs`` for the port).

Sources per the assignment brief (arXiv ids / HF cards in comments).
Deviations forced by the substrate are marked DEVIATION and mirrored in
DESIGN.md §Arch-applicability.
"""

from __future__ import annotations

from repro_torch.configs.base import register
from repro_torch.models.config import (LayerSpec, MLAConfig, ModelConfig,
                                 MoEConfig, SSMConfig)

_A = LayerSpec("attn", "dense")


@register("xlstm-125m")
def xlstm_125m() -> ModelConfig:
    """xLSTM-125M [arXiv:2405.04517]: sLSTM + mLSTM blocks, no separate
    FFN (d_ff=0 — the blocks carry their own up/down projections).
    Pattern 5 mLSTM : 1 sLSTM per super-block (the paper's 7:1 ratio
    rounded to divide 12 layers)."""
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
        head_dim=192, d_ff=0, vocab_size=50304,
        block_pattern=(LayerSpec("mlstm", "none"),) * 5
        + (LayerSpec("slstm", "none"),),
        ssm=SSMConfig(state_dim=384, head_dim=384, expand=2, chunk=256),
        tie_embeddings=False,
        norm_type="layernorm",
    )


@register("qwen2-0.5b")
def qwen2_0_5b() -> ModelConfig:
    """Qwen2-0.5B [arXiv:2407.10671]: GQA kv=2, QKV bias, tied embed."""
    return ModelConfig(
        name="qwen2-0.5b", family="dense",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        head_dim=64, d_ff=4864, vocab_size=151936,
        block_pattern=(_A,),
        qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
        head_pad_to=16,     # 14 q heads padded so TP16 divides
        mlp_act="silu", mlp_gated=True,
    )


@register("gemma2-2b")
def gemma2_2b() -> ModelConfig:
    """Gemma2-2B [arXiv:2408.00118]: local(4096)/global alternating,
    attn/final logit softcaps, pre+post sandwich norms, GeGLU."""
    return ModelConfig(
        name="gemma2-2b", family="dense",
        n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
        head_dim=256, d_ff=9216, vocab_size=256000,
        block_pattern=(LayerSpec("attn_local", "dense"), _A),
        local_window=4096, attn_softcap=50.0, final_softcap=30.0,
        post_norms=True, scale_embeddings=True, tie_embeddings=True,
        head_pad_to=16, mlp_act="gelu", mlp_gated=True,
    )


@register("starcoder2-15b")
def starcoder2_15b() -> ModelConfig:
    """StarCoder2-15B [arXiv:2402.19173]: GQA kv=4, RoPE, LayerNorm,
    plain-GELU MLP, biases."""
    return ModelConfig(
        name="starcoder2-15b", family="dense",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
        head_dim=128, d_ff=24576, vocab_size=49152,
        block_pattern=(_A,),
        qkv_bias=True, rope_theta=1e5, norm_type="layernorm",
        mlp_act="gelu", mlp_gated=False, tie_embeddings=True,
    )


@register("stablelm-1.6b")
def stablelm_1_6b() -> ModelConfig:
    """StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b]: MHA (kv=32),
    partial rotary 25%, LayerNorm."""
    return ModelConfig(
        name="stablelm-1.6b", family="dense",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        head_dim=64, d_ff=5632, vocab_size=100352,
        block_pattern=(_A,),
        rope_fraction=0.25, norm_type="layernorm",
        mlp_act="silu", mlp_gated=True, tie_embeddings=False,
    )


@register("arctic-480b")
def arctic_480b() -> ModelConfig:
    """Snowflake Arctic [hf:Snowflake/snowflake-arctic-base]: dense-MoE
    hybrid — 128 experts top-2 in parallel with a dense residual MLP.
    bf16 params + Adafactor-style bf16 optimizer states (the reference
    sized this for its TPU mesh; DESIGN.md §6)."""
    return ModelConfig(
        name="arctic-480b", family="moe",
        n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
        head_dim=128, d_ff=4864, vocab_size=32000,
        block_pattern=(LayerSpec("attn", "moe_dense"),),
        moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                      dense_residual=True),
        head_pad_to=64,     # 56 q heads padded so TP16 divides
        rope_theta=1e6, param_dtype="bfloat16", tie_embeddings=False,
    )


@register("deepseek-v2-lite-16b")
def deepseek_v2_lite() -> ModelConfig:
    """DeepSeek-V2-Lite [arXiv:2405.04434]: MLA (kv_lora=512), 64 routed
    experts top-6 + 2 shared, dense layer 0 (prologue)."""
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        head_dim=128, d_ff=1408, vocab_size=102400,
        prologue=(LayerSpec("mla", "dense"),),
        block_pattern=(LayerSpec("mla", "moe"),),
        mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                      n_shared_experts=2),
        tie_embeddings=False,
    )


@register("internvl2-76b")
def internvl2_76b() -> ModelConfig:
    """InternVL2-Llama3-76B [arXiv:2404.16821]: Llama3-70B-shape LM
    backbone; InternViT frontend is a STUB — input_specs supplies
    precomputed patch embeddings (vision_dim=3200) occupying the first
    256 token slots."""
    return ModelConfig(
        name="internvl2-76b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        head_dim=128, d_ff=28672, vocab_size=128256,
        block_pattern=(_A,),
        rope_theta=5e5, vision_tokens=256, vision_dim=3200,
        tie_embeddings=False,
    )


@register("whisper-large-v3")
def whisper_large_v3() -> ModelConfig:
    """Whisper-large-v3 [arXiv:2212.04356]: 32+32 encoder-decoder,
    MHA (kv=20), LayerNorm, plain GELU.  DEVIATION: RoPE replaces
    learned/sinusoidal positions so the assigned 32k decode shapes are
    well-defined (orig max_target_positions=448); conv frontend is a STUB
    (input_specs supplies 1500 post-conv frames)."""
    return ModelConfig(
        name="whisper-large-v3", family="audio",
        n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
        head_dim=64, d_ff=5120, vocab_size=51866,
        block_pattern=(_A,),
        encoder_layers=32, encoder_seq=1500,
        head_pad_to=32,     # 20 heads padded so TP16 divides
        norm_type="layernorm", mlp_act="gelu", mlp_gated=False,
        tie_embeddings=True,
    )


@register("zamba2-1.2b")
def zamba2_1_2b() -> ModelConfig:
    """Zamba2-1.2B [arXiv:2411.15242]: Mamba2 backbone with a shared-
    weight attention(+MLP) block every 6 layers.  38 layers = 2 mamba
    prologue + 6 x (shared_attn + 5 mamba).  DEVIATION: the shared block
    takes the residual stream directly (no concat-with-embedding)."""
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        head_dim=64, d_ff=8192, vocab_size=32000,
        prologue=(LayerSpec("mamba2", "none"),) * 2,
        block_pattern=(LayerSpec("shared_attn", "dense"),)
        + (LayerSpec("mamba2", "none"),) * 5,
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk=256),
        tie_embeddings=True,
    )
