"""Model assembly: layer stacks, loss, decode (port of
``repro.models.transformer``).

The stack is ``prologue`` (e.g. DeepSeek's dense layer 0) followed by
``n_super`` repeats of the config's super-block pattern.  The reference
scans stacked per-superblock parameters; here each superblock is its own
``nn.ModuleDict`` of layers (``blocks.<i>.<j>``) and a Python loop runs
them.  With ``cfg.remat`` and autograd on, each superblock (and each
encoder block, and each chunk of the chunked CE) runs under
``torch.utils.checkpoint`` (non-reentrant): its activations are
recomputed in the backward, where the reference wraps the same bodies in
``jax.checkpoint``.

Top-level API (functions over a :class:`Transformer`, with the config
passed explicitly as in the reference):

  init_params(gen, cfg, device)          -> Transformer
  forward(params, batch, cfg)            -> logits [B, S, V]
  loss_fn(params, batch, cfg)            -> (loss, metrics)
  init_decode_state(cfg, batch, max_len) -> caches
  decode_step(params, state, token, pos, cfg) -> (logits [B,1,V], state)

Under tensor parallelism (``sharding.use_sharding`` with a model axis
of more than one rank) the residual stream stays replicated over the
model group, or, where ``rules.seq`` is set and the sequence divides the
group, split on the sequence: norms and residual adds then run on the
rank's slice, the stream is all-gathered before each mixer / MLP and
reduced and sliced after it (``sharding.gather_along`` /
``slice_along``).  The loss is a vocab-parallel chunked CE, and
``forward`` / ``decode_step`` join the vocab blocks of the logits.

``batch`` is a dict: tokens [B, S] (+ ``vision_embeds`` for the VLM stub,
``audio_frames`` for the audio stub).  Entry points run on the card
unless the caller passes ``device="cpu"``.  ``loss_fn`` builds the
autograd graph when the caller has grad enabled (the train step
differentiates it); ``forward`` and the decode functions serve, and run
without autograd (``torch.no_grad``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import constrain
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import (MLP, Embeddings, Norm, apply_mlp,
                                       apply_norm, dtype_of, embed_tokens,
                                       full, unembed, unembed_block,
                                       vocab_parallel)

_MIXERS = {"attn": attn.Attention, "attn_local": attn.Attention,
           "mla": attn.MLA, "mamba2": ssm.Mamba2, "mlstm": ssm.MLSTM,
           "slstm": ssm.SLSTM}

# ------------------------------------------------------------- one layer


class Layer(nn.Module):
    """One layer of a super-block: ``norm1`` + ``mix`` (none for
    ``shared_attn``, whose weights live in the model's ``shared``);
    ``cross_norm`` + ``cross`` in an encoder-decoder; ``norm2`` + ``mlp``
    or ``moe`` unless the spec's MLP is ``none``; ``post1`` / ``post2``
    sandwich norms."""

    def __init__(self, gen: torch.Generator, spec: LayerSpec,
                 cfg: ModelConfig, *, device,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm1 = Norm(cfg, device=device)
        if spec.mixer == "shared_attn":
            self.mix = None
        elif spec.mixer in _MIXERS:
            self.mix = _MIXERS[spec.mixer](gen, cfg, device=device,
                                           dtype=dtype)
        else:
            raise ValueError(f"unknown mixer {spec.mixer}")
        self.cross_norm = self.cross = None
        if cfg.is_encoder_decoder:
            self.cross_norm = Norm(cfg, device=device)
            self.cross = attn.Attention(gen, cfg, device=device, dtype=dtype)
        self.norm2 = self.mlp = self.moe = None
        if spec.mlp != "none":
            self.norm2 = Norm(cfg, device=device)
            if spec.mlp == "dense":
                self.mlp = MLP(gen, cfg, device=device, dtype=dtype)
            else:                                   # moe | moe_dense
                self.moe = moe_mod.MoE(gen, cfg, device=device, dtype=dtype)
        self.post1 = self.post2 = None
        if cfg.post_norms:
            self.post1 = Norm(cfg, device=device)
            if spec.mlp != "none":
                self.post2 = Norm(cfg, device=device)


class EncoderLayer(nn.Module):
    """Encoder layers: bidirectional attention + dense MLP, no cross."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, *, device,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm1 = Norm(cfg, device=device)
        self.mix = attn.Attention(gen, cfg, device=device, dtype=dtype)
        self.norm2 = Norm(cfg, device=device)
        self.mlp = MLP(gen, cfg, device=device, dtype=dtype)


def _mix(p: Layer, spec, x, cfg, positions, shared):
    if spec.mixer == "attn":
        return attn.attention(p.mix, x, cfg, positions=positions)
    if spec.mixer == "attn_local":
        return attn.attention(p.mix, x, cfg, positions=positions,
                              window=cfg.local_window)
    if spec.mixer == "mla":
        return attn.mla_attention(p.mix, x, cfg, positions=positions)
    if spec.mixer == "mamba2":
        return ssm.apply_mamba2(p.mix, x, cfg)
    if spec.mixer == "mlstm":
        return ssm.apply_mlstm(p.mix, x, cfg)
    if spec.mixer == "slstm":
        return ssm.apply_slstm(p.mix, x, cfg)
    if spec.mixer == "shared_attn":
        return attn.attention(shared["attn"], x, cfg, positions=positions)
    raise ValueError(spec.mixer)


def _seq_parallel(s: int) -> bool:
    """True when the residual stream of a sequence of ``s`` splits on the
    sequence over the model group (``rules.seq``)."""
    tp = sharding.tensor_parallel()
    return tp is not None and tp.seq and s % tp.size == 0


def _sublayer(norm, fn, x, cfg: ModelConfig, sp: bool):
    """``fn`` of the normed stream ``x``: under sequence parallelism
    (``sp``) the rank's slice is normed, all-gathered for ``fn`` (which
    takes and returns the whole sequence, replicated) and ``fn``'s output
    sliced back."""
    h = apply_norm(norm, x, cfg, seq_split=sp)
    if not sp:
        return fn(h)
    return sharding.slice_along(fn(sharding.gather_along(h, 1)), 1)


def _ffn(p: Layer, spec: LayerSpec, x, cfg: ModelConfig, sp=False):
    """The layer's MLP half: ``(x, aux)``."""
    aux = _aux_zero(cfg, x.device)
    if spec.mlp == "none":
        return x, aux

    def ffn(h):
        nonlocal aux
        if spec.mlp == "dense":
            f = apply_mlp(p.mlp, h, cfg)
        else:
            f, aux = moe_mod.apply_moe(p.moe, h, cfg)
        return apply_norm(p.post2, f, cfg) if cfg.post_norms else f
    x = x + _sublayer(p.norm2, ffn, x, cfg, sp)
    return x, aux


def apply_layer(p: Layer, spec: LayerSpec, x, cfg: ModelConfig, positions,
                shared=None, enc_out=None, sp=False):
    """Returns (x, aux_dict).  ``sp``: ``x`` is this rank's slice of the
    sequence (:func:`_seq_parallel`); ``positions`` are the whole
    sequence's."""
    def mix(h):
        m = _mix(p, spec, h, cfg, positions, shared)
        return apply_norm(p.post1, m, cfg) if cfg.post_norms else m
    x = x + _sublayer(p.norm1, mix, x, cfg, sp)
    if enc_out is not None:
        ck, cv = attn._project_kv(p.cross, enc_out, cfg, positions=None,
                                  use_rope=False)
        x = x + _sublayer(p.cross_norm, lambda h: attn.attention(
            p.cross, h, cfg, positions=positions, cross_kv=(ck, cv)),
            x, cfg, sp)
    x, aux = _ffn(p, spec, x, cfg, sp)
    x = constrain(x, "batch", "seq", "embed")
    return x, aux


def _aux_zero(cfg: ModelConfig, device) -> dict:
    if cfg.moe is None:
        return {}
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("moe_aux_loss", "moe_z_loss", "moe_drop_frac")}


def _aux_add(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


# ----------------------------------------------------------------- stacks

class Encoder(nn.Module):
    """The whisper encoder: ``blocks.<i>.0`` layers and a final ``norm``."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, *, device,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.blocks = nn.ModuleList(
            nn.ModuleDict({"0": EncoderLayer(gen, cfg, device=device,
                                             dtype=dtype)})
            for _ in range(cfg.encoder_layers))
        self.norm = Norm(cfg, device=device)


class Transformer(nn.Module):
    """The parameters of one model, under the reference's names:
    ``embeddings``, ``final_norm``, ``blocks.<superblock>.<layer>``,
    ``prologue.<i>``, ``shared.attn`` (zamba2) and ``encoder`` (whisper)."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, *, device,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        cfg.validate()
        self.embeddings = Embeddings(gen, cfg, device=device, dtype=dtype)
        self.final_norm = Norm(cfg, device=device)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({str(i): Layer(gen, spec, cfg, device=device,
                                         dtype=dtype)
                           for i, spec in enumerate(cfg.block_pattern)})
            for _ in range(cfg.n_super))
        self.prologue = nn.ModuleList(
            Layer(gen, spec, cfg, device=device, dtype=dtype)
            for spec in cfg.prologue) if cfg.prologue else None
        self.shared = nn.ModuleDict(
            {"attn": attn.Attention(gen, cfg, device=device, dtype=dtype)}) \
            if any(s.mixer == "shared_attn" for s in cfg.block_pattern) \
            else None
        self.encoder = Encoder(gen, cfg, device=device, dtype=dtype) \
            if cfg.is_encoder_decoder else None


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> Transformer:
    """A model of ``cfg`` on ``device`` (the card unless ``"cpu"``), drawn
    from ``gen`` (a generator on that device).  ``dtype`` overrides the
    config's ``param_dtype`` for the weights; norms, scalars and the router
    stay float32.  On ``"meta"`` (shapes and dtypes only, nothing
    allocated: the dry run's abstract model) no value is drawn, and ``gen``
    may be any generator."""
    device = resolve_device(device)
    if device.type != "meta" and gen.device.type != device.type:
        raise ValueError(f"the generator is on {gen.device}, the model on "
                         f"{device}: draw on the model's device")
    with torch.no_grad():
        return Transformer(gen, cfg, device=device, dtype=dtype)


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, under activation checkpointing when ``cfg.remat``
    and autograd are on (the reference's ``jax.checkpoint`` sites)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _encode(params: Transformer, batch, cfg: ModelConfig):
    """Whisper encoder over stub audio frames [B, T_enc, D]."""
    x = batch["audio_frames"].to(dtype_of(cfg.compute_dtype))
    b, t, _ = x.shape
    positions = attn._positions(b, t, x.device)

    def block(p, x):
        h = apply_norm(p.norm1, x, cfg)
        x = x + attn.attention(p.mix, h, cfg, positions=positions,
                               causal=False)
        h = apply_norm(p.norm2, x, cfg)
        return x + apply_mlp(p.mlp, h, cfg)

    for blk in params.encoder.blocks:
        x = _remat(cfg, block, blk["0"], x)
    return apply_norm(params.encoder.norm, x, cfg)


def _embed_input(params: Transformer, batch, cfg: ModelConfig):
    x = embed_tokens(params.embeddings, batch["tokens"], cfg)
    if cfg.vision_tokens:
        cd = dtype_of(cfg.compute_dtype)
        w = full(params.embeddings.w_vision).to(cd)
        v = batch["vision_embeds"].to(cd) @ w
        x = torch.cat([v, x[:, v.shape[1]:]], dim=1)
    return x


def forward_hidden(params: Transformer, batch, cfg: ModelConfig):
    """Stack output after final norm (pre-unembed): ([B,S,D], aux)."""
    b, s = batch["tokens"].shape
    x = _embed_input(params, batch, cfg)
    positions = attn._positions(b, s, x.device)
    sp = _seq_parallel(s)
    if sp:
        x = sharding.slice_along(x, 1)
    x = constrain(x, "batch", "seq", "embed")
    enc_out = _encode(params, batch, cfg) if cfg.is_encoder_decoder else None
    shared = params.shared
    aux = _aux_zero(cfg, x.device)
    for p, spec in zip(params.prologue or (), cfg.prologue):
        x, a = apply_layer(p, spec, x, cfg, positions, shared=shared,
                           enc_out=enc_out, sp=sp)
        aux = _aux_add(aux, a)

    def superblock(blk, x, a, enc_out):
        for i, spec in enumerate(cfg.block_pattern):
            x, ai = apply_layer(blk[str(i)], spec, x, cfg, positions,
                                shared=shared, enc_out=enc_out, sp=sp)
            a = _aux_add(a, ai)
        return x, a

    # the stack's aux sums run from zero, then join the prologue's (the
    # reference's scan carry)
    stack_aux = _aux_zero(cfg, x.device)
    for blk in params.blocks:
        x, stack_aux = _remat(cfg, superblock, blk, x, stack_aux, enc_out)
    aux = _aux_add(aux, stack_aux)
    x = apply_norm(params.final_norm, x, cfg, seq_split=sp)
    if sp:
        x = sharding.gather_along(x, 1)
    return x, aux


@torch.no_grad()
def forward(params: Transformer, batch, cfg: ModelConfig, *,
            return_aux=False, last_only=False):
    """Full forward: logits [B, S, vocab] (or [B, 1, vocab] if
    ``last_only`` — prefill uses this to avoid materializing a
    [B, S, vocab] logit tensor)."""
    x, aux = forward_hidden(params, batch, cfg)
    if last_only:
        x = x[:, -1:]
    logits = unembed(params.embeddings, x, cfg)
    logits = constrain(logits, "batch", None, "vocab")
    if return_aux:
        return logits, aux
    return logits


def _ce_chunk(params, x_chunk, tgt_chunk, mask_chunk, cfg: ModelConfig):
    b, s, d = x_chunk.shape
    lg = unembed_block(params.embeddings, x_chunk.reshape(b * s, d), cfg)
    lg = constrain(lg, "batch", "vocab")
    tgt = tgt_chunk.reshape(b * s)
    if vocab_parallel(cfg):
        # vocab-parallel CE over this rank's logit columns: the max (no
        # gradient) and the sum of exps all-reduced, the target logit
        # taken by the rank holding it; [rows, V] is never joined
        tp = sharding.tensor_parallel()
        m = sharding.model_all_reduce(lg.detach().amax(-1), tp,
                                      torch.distributed.ReduceOp.MAX)
        logz = m + torch.log(sharding.reduce_from_model(
            torch.exp(lg - m[:, None]).sum(-1)))
        sl = tp.block(cfg.vocab_size)
        local = tgt - sl.start
        inside = (local >= 0) & (local < sl.stop - sl.start)
        gold = torch.gather(lg, 1, torch.where(inside, local, 0)[:, None])
        gold = sharding.reduce_from_model(gold[:, 0] * inside.float())
    else:
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, 1, tgt[:, None])[:, 0]
    nll = (logz - gold) * mask_chunk.reshape(b * s)
    return nll.sum()


def loss_fn(params: Transformer, batch, cfg: ModelConfig):
    """Next-token CE (+ MoE aux losses).  Vision slots are masked.

    The CE is computed over sequence chunks (``cfg.loss_chunk``) so the
    [B, S, vocab] logits are never materialized at once.  Differentiable
    when the caller has grad enabled; the value is the same either way."""
    x, aux = forward_hidden(params, batch, cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    # predict t+1 from position t; last position is masked out
    tgt = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    mask[:, -1] = 0.0
    if cfg.vision_tokens:
        pos = torch.arange(s, device=x.device)[None]
        mask = mask * (pos >= cfg.vision_tokens).float()

    cs = cfg.loss_chunk
    if cs and s % cs == 0 and s > cs:
        nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, s, cs):
            sl = slice(c0, c0 + cs)
            nll_sum = nll_sum + _remat(cfg, _ce_chunk, params, x[:, sl],
                                       tgt[:, sl], mask[:, sl], cfg)
    else:
        nll_sum = _ce_chunk(params, x, tgt, mask, cfg)
    loss = nll_sum / torch.clamp(mask.sum(), min=1.0)
    metrics = {"ce_loss": loss}
    total = loss
    if cfg.moe is not None:
        n_moe = cfg.n_super * sum(1 for sp in cfg.block_pattern
                                  if sp.mlp in ("moe", "moe_dense")) + \
            sum(1 for sp in cfg.prologue if sp.mlp in ("moe", "moe_dense"))
        total = total + aux["moe_aux_loss"] + aux["moe_z_loss"]
        metrics.update(
            moe_aux_loss=aux["moe_aux_loss"], moe_z_loss=aux["moe_z_loss"],
            moe_drop_frac=aux["moe_drop_frac"] / max(n_moe, 1))
    metrics["loss"] = total
    return total, metrics


# ------------------------------------------------------------------ decode

def _init_layer_cache(spec: LayerSpec, cfg: ModelConfig, batch: int,
                      max_len: int, dtype, device) -> dict:
    if spec.mixer in ("attn", "attn_local", "shared_attn"):
        c = attn.init_kv_cache(cfg, batch, attn.cache_len(max_len), dtype,
                               device)
    elif spec.mixer == "mla":
        c = attn.init_mla_cache(cfg, batch, attn.cache_len(max_len), dtype,
                                device)
    elif spec.mixer == "mamba2":
        c = ssm.init_mamba2_cache(cfg, batch, dtype, device)
    elif spec.mixer == "mlstm":
        c = ssm.init_mlstm_cache(cfg, batch, dtype, device)
    elif spec.mixer == "slstm":
        c = ssm.init_slstm_cache(cfg, batch, dtype, device)
    else:
        raise ValueError(spec.mixer)
    if cfg.is_encoder_decoder:
        kv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
        shape = (batch, cfg.encoder_seq, kv, dh)
        c = {"self": c,
             "cross_k": torch.zeros(shape, dtype=dtype, device=device),
             "cross_v": torch.zeros(shape, dtype=dtype, device=device)}
    return c


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device: DeviceLike = None) -> dict:
    """Empty caches: ``{"blocks": [{layer: cache} a superblock],
    "prologue": [cache a layer]}``.  Under ``kv_seq`` tensor parallelism
    (``sharding.use_sharding``) a KV or MLA cache holds this rank's slice
    of the ``max_len`` positions (``attention.cache_len``), and a Mamba2 or
    mLSTM cache the heads this rank computes: make the state under the
    sharding that decodes it.  sLSTM states, the B / C conv window and
    cross caches stay whole."""
    device = resolve_device(device)
    state = {"blocks": [
        {str(i): _init_layer_cache(spec, cfg, batch, max_len, dtype, device)
         for i, spec in enumerate(cfg.block_pattern)}
        for _ in range(cfg.n_super)]}
    if cfg.prologue:
        state["prologue"] = [
            _init_layer_cache(spec, cfg, batch, max_len, dtype, device)
            for spec in cfg.prologue]
    return state


@torch.no_grad()
def fill_cross_cache(params: Transformer, state: dict, batch,
                     cfg: ModelConfig) -> dict:
    """An encoder-decoder's decode ``state`` with every layer's cross K/V
    projected from the encoder output of ``batch["audio_frames"]`` (done
    once, before the first :func:`decode_step`)."""
    enc = _encode(params, batch, cfg)
    for blk, caches in zip(params.blocks, state["blocks"]):
        for i in range(len(cfg.block_pattern)):
            c = caches[str(i)]
            ck, cv = attn._project_kv(blk[str(i)].cross, enc, cfg, None,
                                      use_rope=False)
            c["cross_k"] = ck.to(c["cross_k"].dtype)
            c["cross_v"] = cv.to(c["cross_v"].dtype)
    return state


def _decode_layer(p: Layer, spec: LayerSpec, x, cache, pos: int,
                  cfg: ModelConfig, shared):
    full = cache
    cross_kv = None
    if cfg.is_encoder_decoder:
        cache = full["self"]
        cross_kv = (full["cross_k"], full["cross_v"])
    h = apply_norm(p.norm1, x, cfg)
    if spec.mixer in ("attn", "attn_local", "shared_attn"):
        prm = shared["attn"] if spec.mixer == "shared_attn" else p.mix
        w = cfg.local_window if spec.mixer == "attn_local" else 0
        m, cache = attn.attention_decode(prm, h, cache, pos, cfg, window=w)
    elif spec.mixer == "mla":
        m, cache = attn.mla_decode(p.mix, h, cache, pos, cfg)
    elif spec.mixer == "mamba2":
        m, cache = ssm.mamba2_decode(p.mix, h, cache, cfg)
    elif spec.mixer == "mlstm":
        m, cache = ssm.mlstm_decode(p.mix, h, cache, cfg)
    elif spec.mixer == "slstm":
        m, cache = ssm.slstm_decode(p.mix, h, cache, cfg)
    else:
        raise ValueError(spec.mixer)
    if cfg.post_norms:
        m = apply_norm(p.post1, m, cfg)
    x = x + m
    if cross_kv is not None:
        h = apply_norm(p.cross_norm, x, cfg)
        c, _ = attn.attention_decode(p.cross, h, None, pos, cfg,
                                     cross_kv=cross_kv)
        x = x + c
    x, _ = _ffn(p, spec, x, cfg)
    if cfg.is_encoder_decoder:
        cache = {"self": cache, "cross_k": full["cross_k"],
                 "cross_v": full["cross_v"]}
    return x, cache


@torch.no_grad()
def decode_step(params: Transformer, state: dict, token: torch.Tensor,
                pos: int, cfg: ModelConfig):
    """One autoregressive step.  token [B, 1], ``pos`` (a Python int) the
    current sequence length (the new token's position).  Returns (logits,
    state); attention caches are written in place."""
    pos = int(pos)
    x = embed_tokens(params.embeddings, token, cfg)
    x = constrain(x, "batch", None, "embed")
    shared = params.shared
    new_state = dict(state)
    if cfg.prologue:
        pro = []
        for p, spec, c in zip(params.prologue, cfg.prologue,
                              state["prologue"]):
            x, c = _decode_layer(p, spec, x, c, pos, cfg, shared)
            pro.append(c)
        new_state["prologue"] = pro
    blocks = []
    for blk, caches in zip(params.blocks, state["blocks"]):
        new = {}
        for i, spec in enumerate(cfg.block_pattern):
            x, new[str(i)] = _decode_layer(blk[str(i)], spec, x,
                                           caches[str(i)], pos, cfg, shared)
        blocks.append(new)
    new_state["blocks"] = blocks
    x = apply_norm(params.final_norm, x, cfg)
    return unembed(params.embeddings, x, cfg), new_state
