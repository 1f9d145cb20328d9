"""The LM train step: loss and gradients by autograd, then the optimizer,
with optional microbatch gradient accumulation and int8 gradient
compression (port of ``repro.train.train_step``).

``make_train_step(cfg, opt, ...)`` returns ``step(model, step_idx, batch,
compress_state=None) -> metrics`` (with a compressor, ``(metrics,
compress_state)``), which updates ``model``'s parameters and ``opt``'s
state in place.  ``opt`` is one of the port's optimizers
(``optim.optimizers``) over ``model``'s parameters.

Gradient accumulation loops over contiguous microbatch slices of the
batch, accumulating in ``accum_dtype`` (float32 by default) and dividing
by their count; the metrics are the last microbatch's, with ``loss`` the
mean.  With compression the accumulated gradients are int8-quantized with
per-leaf scales and error feedback before the update
(``optim/compression.py``).

Data parallelism: with sharding rules active (``sharding.use_sharding``)
whose ``batch`` axes split the mesh, each rank takes the rows of the
global batch its coordinates give (ranks that differ only on other axes
share rows) and every gradient is the mean over those ranks: a whole
parameter's by one all-reduce after the backward, a parameter stored as
blocks inside its gather's backward (``sharding.gather``); the MoE
load-balance statistics average in the forward (``sharding.batch_mean``)
and the metrics are the global means.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed import sharding
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig


def _rows(batch: Dict[str, torch.Tensor], sl: slice):
    return {k: v[sl] for k, v in batch.items()}


def _mean_over(tensors: List[torch.Tensor], dp) -> List[torch.Tensor]:
    """Each tensor averaged over ``dp``'s ranks, one all-reduce a dtype."""
    out = list(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        flat = sharding.all_reduce_mean(flat, dp.mesh, dp.dims)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].reshape(tensors[i].shape)
            off += n
    return out


def make_train_step(cfg: ModelConfig, opt, *, microbatches: int = 1,
                    accum_dtype: torch.dtype = torch.float32,
                    compressor=None) -> Callable:
    """The train step of ``cfg`` with optimizer ``opt``.

    ``accum_dtype=torch.bfloat16`` halves the gradient accumulator (the
    480B-class configs need it; the ~3 decimal-digit accumulation error
    over <= 8 microbatches is below optimizer noise)."""
    names = opt.names
    params = opt.param_groups[0]["params"]

    def grads_of(model, batch):
        loss, metrics = tf.loss_fn(model, batch, cfg)
        gs = torch.autograd.grad(loss, params, allow_unused=True)
        gs = [sharding.local(p).new_zeros(sharding.local(p).shape)
              if g is None else sharding.local(g)
              for p, g in zip(params, gs)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, gs

    def step(model, step_idx: int, batch: Dict[str, torch.Tensor],
             compress_state=None):
        act = sharding.active()
        dp = sharding.data_parallel_of(act.mesh, act.rules) \
            if act is not None else None
        if dp is not None:
            n = next(iter(batch.values())).shape[0]
            batch = _rows(batch, sharding.batch_rows(n, dp))
        with sharding.data_parallel(dp):
            if microbatches > 1:
                b = next(iter(batch.values())).shape[0]
                if b % microbatches:
                    raise ValueError(f"a batch of {b} rows does not split "
                                     f"into {microbatches} microbatches")
                mb = b // microbatches
                acc = [torch.zeros_like(sharding.local(p),
                                        dtype=accum_dtype) for p in params]
                loss_sum = None
                for i in range(microbatches):
                    loss, metrics, gs = grads_of(
                        model, _rows(batch, slice(i * mb, (i + 1) * mb)))
                    acc = [a + g.to(accum_dtype) for a, g in zip(acc, gs)]
                    loss_sum = loss if loss_sum is None else loss_sum + loss
                grads = [a / microbatches for a in acc]
                metrics["loss"] = loss_sum / microbatches
            else:
                _, metrics, grads = grads_of(model, batch)
        if dp is not None:
            # whole parameters: the mean of the ranks' gradients (blocks
            # were averaged in their gather's backward)
            plain = [i for i, p in enumerate(params)
                     if not isinstance(p, DTensor)]
            for i, g in zip(plain, _mean_over([grads[i] for i in plain],
                                              dp)):
                grads[i] = g
            keys = sorted(metrics)
            vals = _mean_over([metrics[k].float() for k in keys], dp)
            metrics = dict(zip(keys, vals))
        named = {n: sharding.block_like(p, g)
                 for n, p, g in zip(names, params, grads)}
        if compressor is not None:
            named, compress_state = compressor.compress_decompress(
                named, compress_state)
        opt.step(step_idx, named)
        if compressor is not None:
            return metrics, compress_state
        return metrics

    return step
