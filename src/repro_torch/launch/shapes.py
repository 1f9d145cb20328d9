"""Assigned input shapes, per-cell configs and abstract inputs (port of
``repro.launch.shapes``).

Each LM arch pairs with the four assigned shapes.  ``long_500k`` requires
sub-quadratic attention; pure full-attention archs are skipped per the
brief — ``applicable()`` encodes that rule.  The paper's own TM workload
is exposed as extra ``imbue-tm`` cells (``launch.dryrun``'s ``TM_SHAPES``)
so it runs through the same dry-run machinery.

Abstract means the ``meta`` device: tensors that carry a shape and a
dtype, on which every op dispatches and nothing is allocated or computed.
``input_specs``, ``abstract_params`` and ``abstract_decode_state`` return
meta tensors only.  One recorded difference from the reference: token
ids are int64 (the port's models index with them), where the
reference's are int32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    s.name: s for s in [
        ShapeSpec("train_4k", "train", 4096, 256),
        ShapeSpec("prefill_32k", "prefill", 32768, 32),
        ShapeSpec("decode_32k", "decode", 32768, 128),
        ShapeSpec("long_500k", "decode", 524288, 1),
    ]
}

LM_ARCHS = ["xlstm-125m", "qwen2-0.5b", "gemma2-2b", "starcoder2-15b",
            "stablelm-1.6b", "arctic-480b", "deepseek-v2-lite-16b",
            "internvl2-76b", "whisper-large-v3", "zamba2-1.2b"]


def applicable(arch: str, shape: str) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) per the brief's shape rules."""
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k context needs "
                       "sub-quadratic attention (skip per brief)")
    return True, ""


def cells(include_skipped: bool = False):
    """All (arch, shape, runnable, reason) dry-run cells."""
    out = []
    for a in LM_ARCHS:
        for s in SHAPES:
            ok, why = applicable(a, s)
            if ok or include_skipped:
                out.append((a, s, ok, why))
    return out


# Per-arch execution overrides for the big shapes (memory fitting; they
# change the execution strategy, not the architecture): the reference's,
# rule for rule.  blocked_attn_threshold=4096 switches train_4k to the
# online-softmax blocked attention where the unchunked float32 scores
# (3+ local heads x [B, 4096, 4096]) threaten the memory fit.
_BLOCKED = dict(blocked_attn_threshold=4096)
_EXEC_OVERRIDES = {
    "gemma2-2b": dict(loss_chunk=1024),
    "starcoder2-15b": dict(seq_parallel=True, **_BLOCKED),
    "internvl2-76b": dict(seq_parallel=True, **_BLOCKED),
    "arctic-480b": dict(seq_parallel=True, **_BLOCKED),
}

# gradient-accumulation microbatches for train_4k (bounds live activation
# temps: the MoE dispatch buffers at 480B scale)
TRAIN_MICROBATCHES = {
    "arctic-480b": 4,
    "internvl2-76b": 2,
}


def cell_config(arch: str, shape: str) -> ModelConfig:
    cfg = get_config(arch)
    over = dict(_EXEC_OVERRIDES.get(arch, {}))
    return dataclasses.replace(cfg, **over) if over else cfg


def input_specs(cfg: ModelConfig, shape: str) -> dict:
    """Abstract (meta) inputs for the cell's step function: the global
    batch (a train or prefill step's rows, each rank's cut by the dry
    run), or a decode step's ``token`` and ``pos``."""
    spec = SHAPES[shape]
    b, s = spec.global_batch, spec.seq
    if spec.kind in ("train", "prefill"):
        out = {"tokens": torch.empty((b, s), dtype=torch.int64,
                                     device=META)}
        if cfg.vision_tokens:
            out["vision_embeds"] = torch.empty(
                (b, cfg.vision_tokens, cfg.vision_dim), dtype=torch.float32,
                device=META)
        if cfg.is_encoder_decoder:
            out["audio_frames"] = torch.empty(
                (b, cfg.encoder_seq, cfg.d_model), dtype=torch.float32,
                device=META)
        return out
    # decode: one new token against a seq_len cache (pos: the first slot)
    return {"token": torch.empty((b, 1), dtype=torch.int64, device=META),
            "pos": 0}


def abstract_params(cfg: ModelConfig) -> tf.Transformer:
    """The model of ``cfg`` on the meta device (nothing drawn)."""
    return tf.init_params(torch.Generator(), cfg, META)


def abstract_decode_state(cfg: ModelConfig, shape: str,
                          dtype=torch.bfloat16) -> dict:
    """Empty decode caches of the cell on the meta device, bf16 by default
    as in the reference.  Under ``kv_seq`` tensor parallelism
    (``sharding.use_sharding``) a KV or MLA cache holds this rank's slice
    of the sequence, as ``cache_pspec`` places it, and a Mamba2 or mLSTM
    cache this rank's heads."""
    spec = SHAPES[shape]
    return tf.init_decode_state(cfg, spec.global_batch, spec.seq, dtype,
                                META)


# sub-1B archs whose train cells use pure data parallelism (the model
# axis folds into the batch); empty, as the reference's.
PURE_DP_ARCHS: set = set()
