"""Shared building blocks: norms, MLPs, embeddings, initializers (port of
``repro.models.layers``).

Each block is an ``nn.Module`` built on an explicit ``device`` and
parameter ``dtype`` (default: the config's ``param_dtype``) and drawn
from an explicit ``torch.Generator`` on that device.  Leaf parameter
names are the reference's (``w_up`` / ``w_down`` / ``w_gate`` / ``embed``
/ ``unembed`` / ``scale`` ...): they are the contract with
``distributed/sharding.py``'s partition rules and with
``convert.lm_params_from_numpy``.  The config is passed to every apply
function, as in the reference, so one set of parameters serves configs
that differ only in execution settings (the blocked-attention threshold,
the MoE capacity factor).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import gather
from repro_torch.models.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def normal_init(gen: torch.Generator, shape, scale: float,
                dtype: torch.dtype, device) -> nn.Parameter:
    """``scale`` times a standard normal truncated to [-2, 2], drawn in
    float32 on ``device`` and cast to ``dtype`` (the reference's
    ``normal_init``)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return nn.Parameter((t * scale).to(dtype))


def fan_in_init(gen: torch.Generator, shape, fan_in: int,
                dtype: torch.dtype, device) -> nn.Parameter:
    return normal_init(gen, shape, fan_in ** -0.5, dtype, device)


def const(shape, value: float, device, dtype=torch.float32) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device))


def param_dtype(cfg: ModelConfig, dtype: Optional[torch.dtype]):
    return dtype if dtype is not None else dtype_of(cfg.param_dtype)


def full(t: torch.Tensor) -> torch.Tensor:
    """A parameter, whole, as the models read it: a leaf placed on a mesh
    (``sharding.shard_module``: a ``DTensor`` of this rank's block) is
    all-gathered at its use, FSDP-style; a plain tensor passes as it
    is."""
    return gather(t)


# ----------------------------------------------------------------- norms

class Norm(nn.Module):
    """RMSNorm or LayerNorm over the last axis; float32 ``scale`` (and
    ``bias`` for LayerNorm unless ``with_bias`` says otherwise)."""

    def __init__(self, cfg: ModelConfig, *, device,
                 with_bias: Optional[bool] = None):
        super().__init__()
        with_bias = (cfg.norm_type == "layernorm") if with_bias is None \
            else with_bias
        self.scale = const((cfg.d_model,), 1.0, device)
        if with_bias:
            self.bias = const((cfg.d_model,), 0.0, device)
        else:
            self.register_parameter("bias", None)


def apply_norm(p: Norm, x: torch.Tensor, cfg: ModelConfig, *,
               seq_split: bool = False) -> torch.Tensor:
    """``seq_split``: ``x`` is this rank's slice of a sequence split over
    the model group (sequence parallelism), so the parameters' gradients
    are partial sums there, summed over the group."""
    def prm(t):
        return sharding.copy_to_model(full(t)) if seq_split else full(t)
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + cfg.norm_eps) * prm(p.scale)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps) * prm(p.scale)
        if p.bias is not None:
            out = out + prm(p.bias)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ------------------------------------------------------------------ MLPs

def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(x, approximate="tanh")


def _act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


class MLP(nn.Module):
    """``w_up`` [d, f], ``w_down`` [f, d] and, when gated, ``w_gate``."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, *, device,
                 dtype: Optional[torch.dtype] = None,
                 d_ff: Optional[int] = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        pd = param_dtype(cfg, dtype)
        self.w_up = fan_in_init(gen, (d, f), d, pd, device)
        self.w_down = fan_in_init(gen, (f, d), f, pd, device)
        if cfg.mlp_gated:
            self.w_gate = fan_in_init(gen, (d, f), d, pd, device)
        else:
            self.register_parameter("w_gate", None)


def tp_splits(flag: str, n: int) -> bool:
    """True when the active tensor parallelism carries logical axis
    ``flag`` and ``n`` items of it divide over the model group (a layer
    whose axis does not divide computes whole on every rank)."""
    tp = sharding.tensor_parallel()
    return tp is not None and getattr(tp, flag) and n % tp.size == 0


def apply_mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``x`` replicated over the model group; under tensor parallelism on
    ``mlp`` the hidden units split (column-parallel ``w_up`` / ``w_gate``,
    row-parallel ``w_down``, one all-reduce)."""
    cd = dtype_of(cfg.compute_dtype)
    act = _act(cfg.mlp_act)
    xc = x.to(cd)
    if tp_splits("mlp", p.w_up.shape[1]):
        xc = sharding.copy_to_model(xc)
        h = xc @ sharding.model_block(p.w_up, 1).to(cd)
        if p.w_gate is not None:
            h = act(xc @ sharding.model_block(p.w_gate, 1).to(cd)) * h
        else:
            h = act(h)
        return sharding.reduce_from_model(
            h @ sharding.model_block(p.w_down, 0).to(cd))
    h = xc @ full(p.w_up).to(cd)
    if p.w_gate is not None:
        h = act(xc @ full(p.w_gate).to(cd)) * h
    else:
        h = act(h)
    return h @ full(p.w_down).to(cd)


# ------------------------------------------------------- embeddings / head

class Embeddings(nn.Module):
    """``embed`` [V, d]; ``unembed`` [d, V] unless tied; ``w_vision``
    [vision_dim, d] for the VLM stub."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, *, device,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        pd = param_dtype(cfg, dtype)
        self.embed = normal_init(gen, (cfg.vocab_size, cfg.d_model), 0.02,
                                 pd, device)
        if not cfg.tie_embeddings:
            self.unembed = normal_init(gen, (cfg.d_model, cfg.vocab_size),
                                       cfg.d_model ** -0.5, pd, device)
        else:
            self.register_parameter("unembed", None)
        if cfg.vision_tokens:
            self.w_vision = fan_in_init(gen, (cfg.vision_dim, cfg.d_model),
                                        cfg.vision_dim, pd, device)
        else:
            self.register_parameter("w_vision", None)


def embed_tokens(p: Embeddings, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    cd = dtype_of(cfg.compute_dtype)
    if tp_splits("vocab", p.embed.shape[0]):
        # vocab-parallel: this rank's rows of the table; the tokens
        # outside them read zeros, and the ranks' rows sum to the whole
        sl = sharding.tensor_parallel().block(p.embed.shape[0])
        local = tokens - sl.start
        inside = (local >= 0) & (local < sl.stop - sl.start)
        w = sharding.model_block(p.embed, 0)
        x = F.embedding(torch.where(inside, local, 0), w) \
            * inside[..., None].to(w.dtype)
        x = sharding.reduce_from_model(x).to(cd)
    else:
        # Gather, then cast: the same values as casting the table first.
        x = F.embedding(tokens, full(p.embed)).to(cd)
    if cfg.scale_embeddings:
        # the factor rounded to the compute dtype first, as the reference;
        # made on the device (a host scalar tensor would be a copy)
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=cd,
                           device=x.device)
    return x


def vocab_parallel(cfg: ModelConfig) -> bool:
    """True when the logits split over the model group by vocab."""
    return tp_splits("vocab", cfg.vocab_size)


def unembed_block(p: Embeddings, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """The float32 logits of ``x`` (replicated over the model group) over
    this rank's vocab block under :func:`vocab_parallel`, else whole."""
    cd = dtype_of(cfg.compute_dtype)
    if vocab_parallel(cfg):
        xc = sharding.copy_to_model(x.to(cd))
        if cfg.tie_embeddings:
            logits = xc @ sharding.model_block(p.embed, 0).to(cd).T
        else:
            logits = xc @ sharding.model_block(p.unembed, 1).to(cd)
    elif cfg.tie_embeddings:
        logits = x.to(cd) @ full(p.embed).to(cd).T
    else:
        logits = x.to(cd) @ full(p.unembed).to(cd)
    logits = softcap(logits, cfg.final_softcap)
    return logits.float()


def unembed(p: Embeddings, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The whole float32 logits (the vocab blocks joined)."""
    logits = unembed_block(p, x, cfg)
    return sharding.gather_along(logits, -1) if vocab_parallel(cfg) \
        else logits
