"""Config registry + smoke reduction (port of ``repro.configs.base``).

Every assigned architecture registers its exact published config under its
id (``--arch <id>``).  ``smoke(cfg)`` produces a structurally identical
but tiny variant (same family, same block pattern, same special features —
MoE stays MoE, MLA stays MLA) for the CPU smoke tests.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from repro_torch.models.config import MLAConfig, ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    cfg.validate()
    return cfg


def list_archs():
    return sorted(_REGISTRY)


def smoke(cfg: ModelConfig, *, d_model: int = 64, n_super: int = 2,
          vocab: int = 512) -> ModelConfig:
    """Reduced same-family config: tiny widths, few layers, few experts."""
    n_heads = min(cfg.n_heads, 4)
    head_dim = max(d_model // n_heads, 8)
    n_kv = min(cfg.n_kv_heads, n_heads)
    while n_heads % n_kv:
        n_kv -= 1
    repl: dict = dict(
        n_layers=len(cfg.prologue) + n_super * len(cfg.block_pattern),
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        head_pad_to=0,
        d_ff=4 * d_model,
        vocab_size=vocab,
        remat=False,
        blocked_attn_threshold=256,
        attn_chunk_q=64,
        attn_chunk_k=64,
        local_window=min(cfg.local_window, 64) if cfg.local_window else 0,
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.moe is not None:
        repl["moe"] = dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2), d_ff_expert=2 * d_model)
    if cfg.mla is not None:
        repl["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_dim=16,
                                qk_rope_dim=8, v_head_dim=16)
    if cfg.ssm is not None:
        hd = 16
        repl["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=8, head_dim=hd, chunk=32)
    if cfg.encoder_layers:
        repl["encoder_layers"] = 2
        repl["encoder_seq"] = 16
    if cfg.vision_tokens:
        repl["vision_tokens"] = 8
        repl["vision_dim"] = 24
    out = dataclasses.replace(cfg, **repl)
    out.validate()
    return out
