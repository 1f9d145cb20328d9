"""Mixture-of-Experts layer: top-k router, capacity-based dispatch (port of
``repro.models.moe``).

* tokens keep their ``[B, S, D]`` layout: the router, cumsum and dispatch
  are per batch row;
* dispatch is gather based (``[B, E, C, D]`` expert inputs, real
  active-FLOP cost ``B*S*K*cf*D*F``, not a one-hot einsum);
* per-row capacity ``C = ceil(K * S * capacity_factor / E)``; overflow
  tokens are dropped (Switch/GShard semantics), combine weights zero the
  dropped slots;
* DeepSeek shared experts and Arctic's dense residual MLP add in
  parallel.

Under tensor parallelism on ``expert`` (the experts dividing the model
group) the router and the dispatch run replicated, so every rank of the
group takes the same slot decisions; a rank computes its own experts'
slots and the combined output is summed over the group.

Expert choice matches ``jax.lax.top_k``: ties go to the lower expert
index (a stable descending sort), and the dropped tokens are written to
a spare slot column ``cap`` of a ``[B, E, cap + 1]`` table that is then
sliced off, as the reference's ``mode="drop"`` scatter does.  Returns the
load-balance auxiliary loss, the router z-loss and the drop fraction.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import batch_mean, constrain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (MLP, apply_mlp, dtype_of, fan_in_init,
                                       full, param_dtype, tp_splits)


def expert_capacity(cfg: ModelConfig, seq_len: int) -> int:
    m = cfg.moe
    cap = math.ceil(m.top_k * seq_len * m.capacity_factor / m.n_experts)
    return max(cap, 1)


class MoE(nn.Module):
    """``router`` [d, E] (float32), ``experts_up`` / ``experts_gate``
    [E, d, fe], ``experts_down`` [E, fe, d]; ``shared`` (an MLP of
    ``n_shared * fe``) and ``dense`` (an MLP of ``d_ff``) when the config
    has them."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, *, device,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        m = cfg.moe
        d, fe = cfg.d_model, m.d_ff_expert
        pd = param_dtype(cfg, dtype)
        router = fan_in_init(gen, (d, m.n_experts), d, pd, device)
        self.router = nn.Parameter(router.data.float())
        self.experts_up = fan_in_init(gen, (m.n_experts, d, fe), d, pd,
                                      device)
        self.experts_gate = fan_in_init(gen, (m.n_experts, d, fe), d, pd,
                                        device)
        self.experts_down = fan_in_init(gen, (m.n_experts, fe, d), fe, pd,
                                        device)
        self.shared = MLP(gen, cfg, device=device, dtype=dtype,
                          d_ff=m.n_shared_experts * fe) \
            if m.n_shared_experts else None
        self.dense = MLP(gen, cfg, device=device, dtype=dtype,
                         d_ff=cfg.d_ff) if m.dense_residual else None


def top_k(probs: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest along the last axis,
    ties to the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def dispatch(probs: torch.Tensor, k: int, cap: int):
    """Routing of router probabilities ``probs`` [B, S, E] to ``k``
    experts a token with ``cap`` slots an expert and batch row:
    ``(gate_vals [B,S,K], idx [B,S,K], assign [B,S,E], pos_k [B,S,K],
    valid [B,S,K], d_idx [B,E,C], live [B,E,C])``: the renormalised gates,
    the experts, each token's expert count, its place in each expert's
    queue, whether it got a slot, and for each slot the token it holds and
    whether one claimed it."""
    b, s, e = probs.shape
    dev = probs.device
    gate_vals, idx = top_k(probs, k)                          # [B,S,K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    # position of each token in its expert's queue (per batch row)
    # one_hot without F.one_hot's range check (a device sync)
    experts = torch.arange(e, device=dev)
    assign = (idx[..., None] == experts).to(torch.int64).sum(2)  # [B,S,E]
    pos_e = torch.cumsum(assign, dim=1) - assign              # pos before s
    pos_k = torch.gather(pos_e, 2, idx)                       # [B,S,K]
    valid = pos_k < cap
    # scatter token indices into [B, E, C] dispatch slots; column cap
    # takes the dropped tokens and is sliced off
    b_idx = torch.arange(b, device=dev)[:, None, None].expand(b, s, k)
    s_idx = torch.arange(s, device=dev)[None, :, None].expand(b, s, k)
    slot = torch.where(valid, pos_k, torch.full_like(pos_k, cap))
    d_idx = torch.zeros((b, e, cap + 1), dtype=torch.int64, device=dev)
    d_idx[b_idx, idx, slot] = s_idx
    # a slot is live iff some token claimed it
    live = torch.zeros((b, e, cap + 1), dtype=torch.bool, device=dev)
    live[b_idx, idx, slot] = True
    return (gate_vals, idx, assign, pos_k, valid, d_idx[:, :, :cap],
            live[:, :, :cap])


def apply_moe(p: MoE, x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """x [B, S, D] -> (y [B, S, D], aux metrics)."""
    m = cfg.moe
    cd = dtype_of(cfg.compute_dtype)
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    cap = expert_capacity(cfg, s)
    dev = x.device

    logits = (x.float() @ full(p.router)).float()
    probs = torch.softmax(logits, dim=-1)                     # [B,S,E]
    gate_vals, idx, assign, pos_k, valid, d_idx, live = dispatch(
        probs, k, cap)

    xc = constrain(x.to(cd), "batch", None, None)
    d_idx = constrain(d_idx, "batch", None, None)
    live = constrain(live, "batch", None, None)
    w = (gate_vals * valid.float()).to(cd)
    ep = tp_splits("expert", e)
    # the experts this rank computes: [lo, lo + el)
    lo, el = 0, e
    if ep:
        sl = sharding.tensor_parallel().block(e)
        lo, el = sl.start, sl.stop - sl.start
        # replicated tensors entering the rank's experts: their gradients
        # are the sums of the ranks' partial ones
        xc, w = sharding.copy_to_model(xc), sharding.copy_to_model(w)
        d_idx, live = d_idx[:, lo:lo + el], live[:, lo:lo + el]

    def experts(t):
        return sharding.model_block(t, 0) if ep else full(t)
    rows = torch.arange(b, device=dev)[:, None, None]
    expert_in = xc[rows, d_idx]                               # [B,E,C,D]
    expert_in = expert_in * live[..., None].to(cd)
    expert_in = constrain(expert_in, "batch", "expert", None, None)

    up = torch.einsum("becd,edf->becf", expert_in,
                      experts(p.experts_up).to(cd))
    gt = torch.einsum("becd,edf->becf", expert_in,
                      experts(p.experts_gate).to(cd))
    h = F.silu(gt) * up
    y_exp = torch.einsum("becf,efd->becd", h,
                         experts(p.experts_down).to(cd))      # [B,E,C,D]

    # combine: gather each token's (expert, slot) outputs from the
    # flattened slot table (the rank's experts' slots; the other
    # experts' choices weigh zero here)
    y_flat = y_exp.reshape(b, el * cap, d)
    y_flat = constrain(y_flat, "batch", None, None)
    p_flat = torch.where(valid, pos_k, torch.zeros_like(pos_k))
    slot_flat = ((idx - lo).clamp(0, el - 1) * cap
                 + p_flat).reshape(b, s * k)                  # [B,S*K]
    gathered = y_flat[torch.arange(b, device=dev)[:, None], slot_flat]
    gathered = gathered.reshape(b, s, k, d)
    if ep:
        w = w * ((idx >= lo) & (idx < lo + el)).to(cd)
    y = torch.einsum("bskd,bsk->bsd", gathered, w)
    if ep:
        y = sharding.reduce_from_model(y)       # the AG boundary
    y = constrain(y, "batch", None, None)

    if p.shared is not None:
        y = y + apply_mlp(p.shared, x, cfg)
    if p.dense is not None:
        y = y + apply_mlp(p.dense, x, cfg)

    # aux losses (Switch-style load balance + router z-loss).  Under a
    # data-parallel step the two batch means of the load-balance loss and
    # the drop fraction are averaged over the ranks first (a product of
    # means is not the mean of the ranks' products); the z-loss is a mean
    # and averages with the loss.
    me = batch_mean(probs.mean(dim=(0, 1)))                   # [E]
    ce = batch_mean((assign.float() / k).mean(dim=(0, 1)))    # [E]
    aux = {
        "moe_aux_loss": e * torch.sum(me * ce) * m.aux_loss_weight,
        "moe_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
        * m.router_z_weight,
        "moe_drop_frac": 1.0 - batch_mean(valid.float().mean()),
    }
    return y, aux
