"""AdamW and Adafactor (with a bf16-state option) as ``torch.optim``
optimizers (port of ``repro.optim.optimizers``).

The arithmetic is the reference's, not ``torch.optim.AdamW``'s: the
gradients are clipped by their global norm inside the update, weight
decay applies only to parameters of two or more dimensions, the bias
corrections use ``t = step + 1``, and Adafactor factors its second moment
over (all but the last axis, the last axis).  The step index comes from
the caller (``opt.step(step_idx)``), as in the reference's
``update(grads, state, params, step)``: a resumed run continues the
schedule and the bias corrections exactly.  The scalar factors are formed
in float32, as the reference forms them.

State is a name-keyed tree mirroring the parameters (``state_tree`` /
``load_state_tree``: ``{"m": {name: tensor}, "v": {name: tensor, or
{"row", "col"} / {"full"} for Adafactor}}``).  A parameter stored as
blocks on a mesh (a ``DTensor``, ``sharding.shard_module``) keeps its
state as blocks of the same placement (ZeRO-style); the global norm and
Adafactor's factored means reduce over the ranks that split them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed import sharding


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"   # bfloat16 halves m/v memory
    # adafactor
    factored_min_dim: int = 128    # factorize 2nd moment for dims >= this


_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

NamedParams = Union[nn.Module, Mapping[str, torch.Tensor],
                    Iterable[Tuple[str, torch.Tensor]]]
Schedule = Callable[[int], torch.Tensor]


def _named(params: NamedParams):
    if isinstance(params, nn.Module):
        return list(params.named_parameters())
    if isinstance(params, Mapping):
        return list(params.items())
    return list(params)


def _f32(x) -> float:
    """``x`` rounded to float32 (a Python float holding that value)."""
    return float(np.float32(x))


def cosine_schedule(lr: float, warmup: int, total: int) -> Schedule:
    """Linear warm-up to ``lr`` over ``warmup`` steps, then a cosine decay
    to 0 at ``total``; ``fn(step)`` is a float32 0-d tensor."""
    def fn(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = lr * torch.clamp(s / max(warmup, 1), max=1.0)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(s < warmup, warm, cos)
    return fn


def _shard_dims(p, dim: int):
    """Mesh dimensions (of more than one rank) that split ``p``'s
    dimension ``dim``."""
    return sharding.split_dims(p, dim % p.ndim)


def _reduce_sum(t: torch.Tensor, p, mesh_dims) -> torch.Tensor:
    if not mesh_dims:
        return t
    return sharding.all_reduce_sum(t, p.device_mesh, mesh_dims)


class _Optimizer(torch.optim.Optimizer):
    """Shared plumbing: names, the clip, the schedule, the state tree."""

    def __init__(self, params: NamedParams, cfg: OptimizerConfig,
                 lr_schedule: Optional[Schedule] = None):
        named = _named(params)
        if not named:
            raise ValueError("the optimizer got no parameters")
        self.cfg = cfg
        self.lr_schedule = lr_schedule
        self.names = [n for n, _ in named]
        self.state_dtype = _STATE_DTYPES[cfg.state_dtype]
        super().__init__([p for _, p in named], dict(lr=cfg.lr))
        with torch.no_grad():
            for _, p in named:
                self.state[p] = self._init_state(p)

    # -- state --------------------------------------------------------
    def _params(self):
        return self.param_groups[0]["params"]

    def _zeros(self, p, dtype, shape=None, placements=None):
        loc = sharding.local(p)
        z = torch.zeros(loc.shape if shape is None else shape, dtype=dtype,
                        device=loc.device)
        return sharding.block_like(p, z, placements)

    def state_tree(self) -> Dict[str, Dict[str, object]]:
        """``{"m": {name: m}, "v": {name: v}}`` (the tensors themselves)."""
        out = {"m": {}, "v": {}}
        for n, p in zip(self.names, self._params()):
            out["m"][n] = self.state[p]["m"]
            out["v"][n] = self.state[p]["v"]
        return out

    def load_state_tree(self, tree) -> None:
        """Copy ``tree`` (as :meth:`state_tree` gives it, with whole
        tensors or blocks) into the state, cast to the state's dtypes; a
        whole tensor of a block's state is cut to this rank's block."""
        def put(dst, src):
            if isinstance(dst, dict):
                if set(dst) != set(src):
                    raise ValueError(f"state keys {sorted(src)} != "
                                     f"{sorted(dst)}")
                for k in dst:
                    put(dst[k], src[k])
                return
            src = sharding.local(src)
            d = sharding.local(dst)
            if isinstance(dst, DTensor) and tuple(src.shape) != tuple(d.shape):
                src = src[sharding._block_slices(
                    tuple(dst.shape), dst.device_mesh, dst.placements)]
            if tuple(src.shape) != tuple(d.shape):
                raise ValueError(f"state shape {tuple(src.shape)} != "
                                 f"{tuple(d.shape)}")
            d.copy_(src.to(device=d.device, dtype=d.dtype))

        with torch.no_grad():
            for n, p in zip(self.names, self._params()):
                for k in ("m", "v"):
                    put(self.state[p][k], tree[k][n])

    # -- update -------------------------------------------------------
    def _lr(self, step: int) -> Tuple[float, bool]:
        """(lr as float32, whether it is a float32 tensor's value)."""
        if self.lr_schedule is None:
            return self.cfg.lr, False
        return float(self.lr_schedule(step)), True

    def _decay_factor(self, lr: float, from_schedule: bool,
                      wd: float) -> float:
        if from_schedule:       # float32 arithmetic on a float32 lr
            return _f32(np.float32(1.0) - np.float32(lr) * np.float32(wd))
        return _f32(1.0 - lr * wd)

    def _clipped(self, grads):
        """The grads (local blocks) as float32, scaled to global norm at
        most ``grad_clip``; the norm reduces over the ranks that split a
        block, one all-reduce per distinct set of mesh dimensions."""
        params = self._params()
        sums: Dict[tuple, list] = {}
        for p, g in zip(params, grads):
            dims = tuple(sorted({i for d in range(p.ndim)
                                 for i in _shard_dims(p, d)}))
            key = (id(p.device_mesh) if dims else None, dims)
            sums.setdefault(key, [p, []])[1].append(
                torch.sum(torch.square(g.float())))
        total = []
        for (_, dims), (p, parts) in sums.items():
            s = torch.stack(parts)
            total.append(_reduce_sum(s, p, list(dims)))
        norm = torch.sqrt(torch.sum(torch.cat(total)))
        scale = torch.clamp(self.cfg.grad_clip / torch.clamp(norm, min=1e-9),
                            max=1.0)
        return [g.float() * scale for g in grads], norm

    def _grads(self, grads: Optional[Mapping[str, torch.Tensor]]):
        """Local gradient blocks in parameter order: from ``grads`` (a
        name-keyed mapping) or each parameter's ``.grad`` (zeros where
        a parameter has none)."""
        out = []
        for n, p in zip(self.names, self._params()):
            g = grads.get(n) if grads is not None else p.grad
            if g is None:
                g = torch.zeros_like(sharding.local(p))
            out.append(sharding.local(g))
        return out

    @torch.no_grad()
    def step(self, step_idx: int,
             grads: Optional[Mapping[str, torch.Tensor]] = None):
        """One update at step ``step_idx`` (0-based) from ``grads`` or the
        parameters' ``.grad``; the parameters and state change in place.
        Returns the gradients' global norm before the clip."""
        gs, norm = self._clipped(self._grads(grads))
        lr, sched = self._lr(step_idx)
        t = np.float32(step_idx) + np.float32(1.0)
        for p, g in zip(self._params(), gs):
            wd = self.cfg.weight_decay if p.ndim >= 2 else 0.0
            self._update(p, g, self.state[p], t, lr,
                         self._decay_factor(lr, sched, wd), step_idx)
        return norm


class AdamW(_Optimizer):
    """AdamW with the reference's arithmetic (module docstring)."""

    def _init_state(self, p):
        return {"m": self._zeros(p, self.state_dtype),
                "v": self._zeros(p, self.state_dtype)}

    def _update(self, p, g, st, t, lr, decay, step_idx):
        c = self.cfg
        bc1 = _f32(np.float32(1.0) - np.float32(c.b1) ** t)
        bc2 = _f32(np.float32(1.0) - np.float32(c.b2) ** t)
        m, v, pl = (sharding.local(t) for t in (st["m"], st["v"], p))
        m_new = m.float() * c.b1 + g * (1 - c.b1)
        v_new = v.float() * c.b2 + g * (1 - c.b2) * g
        d = (m_new / bc1) / (torch.sqrt(v_new / bc2) + c.eps)
        pl.copy_((pl.float() * decay - _f32(lr) * d).to(pl.dtype))
        m.copy_(m_new.to(m.dtype))
        v.copy_(v_new.to(v.dtype))


class Adafactor(_Optimizer):
    """Adafactor with momentum in ``state_dtype`` and a factored second
    moment (row / col accumulators, float32) for large rank >= 2
    parameters."""

    def factored(self, p) -> bool:
        # factor over (everything-but-last, last): covers >2D params like
        # w_q [D, H, dh] whose natural 2D view is (D, H*dh)
        lead = 1
        for d in p.shape[:-1]:
            lead *= d
        n = self.cfg.factored_min_dim
        return p.ndim >= 2 and p.shape[-1] >= n and lead >= n

    @staticmethod
    def _dropped(p, dim: int):
        """Placements of ``p``'s state with dimension ``dim`` reduced
        away (the reference's ``.row`` / ``.col`` specs)."""
        if not isinstance(p, DTensor):
            return None
        out = []
        for pl in p.placements:
            if isinstance(pl, Shard) and pl.dim == dim:
                out.append(Replicate())
            elif isinstance(pl, Shard) and pl.dim > dim:
                out.append(Shard(pl.dim - 1))
            else:
                out.append(pl)
        return out

    def _init_state(self, p):
        m = self._zeros(p, self.state_dtype)
        loc = sharding.local(p)
        if self.factored(p):
            nd = p.ndim
            v = {"row": self._zeros(p, torch.float32, loc.shape[:-1],
                                    self._dropped(p, nd - 1)),
                 "col": self._zeros(p, torch.float32,
                                    loc.shape[:-2] + loc.shape[-1:],
                                    self._dropped(p, nd - 2))}
        else:
            v = {"full": self._zeros(p, torch.float32)}
        return {"m": m, "v": v}

    def _update(self, p, g, st, t, lr, decay, step_idx):
        c = self.cfg
        beta2t = np.float32(1.0) - t ** np.float32(-0.8)
        keep = _f32(np.float32(1.0) - beta2t)
        beta2t = _f32(beta2t)
        g2 = g * g + 1e-30
        if self.factored(p):
            nd = p.ndim
            row_v = sharding.local(st["v"]["row"])
            col_v = sharding.local(st["v"]["col"])
            # means over whole axes: a block sums its part, the ranks that
            # split the axis add theirs
            g2_row = _reduce_sum(g2.sum(-1), p, _shard_dims(p, nd - 1)) \
                / p.shape[-1]
            g2_col = _reduce_sum(g2.sum(-2), p, _shard_dims(p, nd - 2)) \
                / p.shape[-2]
            row = row_v * beta2t + g2_row * keep
            col = col_v * beta2t + g2_col * keep
            row_mean = _reduce_sum(row.sum(-1, keepdim=True), p,
                                   _shard_dims(p, nd - 2)) / p.shape[-2]
            vhat = (row / torch.clamp(row_mean, min=1e-30))[..., None] \
                * col[..., None, :]
            row_v.copy_(row)
            col_v.copy_(col)
        else:
            full = sharding.local(st["v"]["full"])
            vhat = full * beta2t + g2 * keep
            full.copy_(vhat)
        d = g / torch.sqrt(vhat + c.eps)
        m, pl = sharding.local(st["m"]), sharding.local(p)
        m_new = m.float() * c.b1 + d * (1 - c.b1)
        pl.copy_((pl.float() * decay - _f32(lr) * m_new).to(pl.dtype))
        m.copy_(m_new.to(m.dtype))


def make_adamw(params: NamedParams, cfg: OptimizerConfig,
               lr_schedule: Optional[Schedule] = None) -> AdamW:
    return AdamW(params, cfg, lr_schedule)


def make_adafactor(params: NamedParams, cfg: OptimizerConfig,
                   lr_schedule: Optional[Schedule] = None) -> Adafactor:
    return Adafactor(params, cfg, lr_schedule)


def make_optimizer(params: NamedParams, cfg: OptimizerConfig,
                   lr_schedule: Optional[Schedule] = None) -> _Optimizer:
    """The optimizer ``cfg.name`` names over ``params`` (a module, a
    name -> tensor mapping, or ``(name, tensor)`` pairs)."""
    if cfg.name == "adamw":
        return AdamW(params, cfg, lr_schedule)
    if cfg.name == "adafactor":
        return Adafactor(params, cfg, lr_schedule)
    raise ValueError(cfg.name)
