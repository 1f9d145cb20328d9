"""The registered forward backends + the uniform entry point (port of
``repro.api.backends``).

All backends share one contract:

    class_sums(state, lits, generator=None) -> int32 [..., M]

``lits`` is the ``[B, 2F]`` uint8 literal matrix (``core.tm.literals``)
or, for the ``packed_io`` backends, the ``[B, ceil(2F/32)]`` int32 word
plane (``ops.pack_literals``); ``ReplicaStackState`` inputs give
``[R, B, M]``, the others ``[B, M]``.  Backends run where the state's
tensors live.

==========================  ===================  ========================
name                        states               capability notes
==========================  ===================  ========================
``digital-torch``           Digital              the bit-exact reference
                                                 (``digital-jnp``)
``digital-cuda``            Digital              the ``tm_infer`` kernel
                                                 (``digital-pallas``)
``digital-cuda-packed``     Digital (packed)     ``tm_infer_packed``,
                                                 AND + popcount
                                                 (``digital-pallas-
                                                 packed``)
``analog-torch``            Crossbar,            eager, models C2C **and**
                            ReplicaStack         CSA offset
                                                 (``analog-jnp``)
``analog-cuda``             Crossbar,            the ``imbue_infer``
                            ReplicaStack         kernel on dense g / leak
                                                 planes, one launch per
                                                 stack (``analog-pallas``)
``analog-cuda-packed``      Crossbar,            ``imbue_infer_packed``,
                            ReplicaStack         packed literal words
                            (packed)             (``analog-pallas-packed``)
``analog-cuda-packed2``     Crossbar,            the ``imbue_infer_planes``
                            ReplicaStack         kernel, one launch per
                            (plane-packed)       stack (``analog-pallas-
                                                 packed2``)
``coalesced``               Coalesced            eager weighted tail
``coalesced-cuda``          Coalesced            ``tm_infer``, W as the
                                                 combine matrix
``coalesced-cuda-packed``   Coalesced (packed)   ``tm_infer_packed``
``coalesced-cuda-packed2``  Coalesced            ``tm_infer_planes``, the
                            (plane-packed)       resident include plane
                                                 on the b1 tensor cores
==========================  ===================  ========================

Within a family the packed backends outrank the dense ones and the
``*-packed2`` ones outrank both, each gated by its predicate (``packed``,
``plane_packed``), as in the reference.  The analog kernels threshold
against one scalar reference: none models the CSA offset, so such reads
fall back loudly to ``analog-torch``.  The reference's ``CAP_SHARDED``
comes with the multi-device slice.

:func:`class_sums` and :func:`predict` are the entry points with
capability-based selection; ``get_backend(name).fn`` pins a backend.
The eight fused backends (``CAP_FUSED_KERNEL``) also take ``tiles=``, the
kernel's launch-geometry override (``ops``; the tuning table's measured
tiles, which ``ServeEngine`` passes to every dispatch).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api.registry import (CAP_ANALOG, CAP_COALESCED,
                                      CAP_DIGITAL, CAP_FUSED_KERNEL,
                                      CAP_MODELS_C2C, CAP_MODELS_CSA_OFFSET,
                                      CAP_PACKED_IO, CAP_PACKED_PLANES,
                                      CAP_REPLICA_VMAP, register_backend,
                                      select_backend)
from repro_torch.api.states import (CoalescedState, CrossbarState,
                                    DigitalState, ReplicaStackState)
from repro_torch.core import coalesced as co
from repro_torch.core import imbue, tm
from repro_torch.kernels import ops


def _as_packed_lits(lits: torch.Tensor) -> torch.Tensor:
    """Accept either wire format: int32 inputs are already packed words,
    anything else is a dense 0/1 literal matrix packed here."""
    if lits.dtype == torch.int32:
        return lits
    return ops.pack_literals(lits)


@register_backend("digital-torch", state_types=(DigitalState,),
                  capabilities={CAP_DIGITAL}, priority=10)
def digital_torch(state: DigitalState, lits: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Boolean-domain reference: violation product + polarity counters."""
    del generator                            # digital path is noise-free
    fired = tm.clause_outputs_from_include(state.include, lits)
    return tm.class_sums(fired, state.tm_cfg)


@register_backend("digital-cuda", state_types=(DigitalState,),
                  capabilities={CAP_DIGITAL, CAP_FUSED_KERNEL}, priority=20)
def digital_cuda(state: DigitalState, lits: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 tiles: ops.Tiles = None) -> torch.Tensor:
    """Fused clause evaluation + polarity combine (``tm_infer``)."""
    del generator
    return ops.tm_class_sums(lits, state.include, state.combine,
                             device=state.device, tiles=tiles)


@register_backend("digital-cuda-packed", state_types=(DigitalState,),
                  capabilities={CAP_DIGITAL, CAP_FUSED_KERNEL,
                                CAP_PACKED_IO},
                  priority=30, predicate=lambda s: s.packed)
def digital_cuda_packed(state: DigitalState, lits: torch.Tensor,
                        generator: Optional[torch.Generator] = None, *,
                        tiles: ops.Tiles = None
                        ) -> torch.Tensor:
    """Packed-wire digital kernel: int32 words, AND + popcount
    (``tm_infer_packed``)."""
    del generator
    return ops.tm_class_sums_packed(_as_packed_lits(lits),
                                    state.include_packed, state.combine,
                                    device=state.device, tiles=tiles)


_ANALOG_STATES = (CrossbarState, ReplicaStackState)


def _as_stack(state):
    """``([R, C, L] resistances, whether the state is one chip)``: a
    ``CrossbarState`` reads as a stack of one (the same C2C draw per
    cell)."""
    if isinstance(state, ReplicaStackState):
        return state.r_stack, False
    return state.r_mem[None], True


@register_backend("analog-torch", state_types=_ANALOG_STATES,
                  capabilities={CAP_ANALOG, CAP_MODELS_C2C,
                                CAP_MODELS_CSA_OFFSET, CAP_REPLICA_VMAP},
                  priority=10)
def analog_torch(state, lits: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Eager KCL + per-column CSA compare (the full noise model)."""
    if isinstance(state, ReplicaStackState):
        cls = imbue.stacked_clause_outputs(
            state.r_stack, state.include, lits, state.tm_cfg, generator,
            state.vcfg, state.icfg)                          # [R, B, C]
    else:
        cls = imbue.analog_clause_outputs_raw(
            state.r_mem, state.include, lits, state.mapping, state.icfg,
            generator, state.vcfg)                           # [B, C]
    cls = cls * state.include.any(dim=-1).to(cls.dtype)
    return tm.class_sums(cls, state.tm_cfg)


@register_backend("analog-cuda", state_types=_ANALOG_STATES,
                  capabilities={CAP_ANALOG, CAP_FUSED_KERNEL,
                                CAP_MODELS_C2C, CAP_REPLICA_VMAP},
                  priority=20)
def analog_cuda(state, lits: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                tiles: ops.Tiles = None
                ) -> torch.Tensor:
    """Dense-plane analog kernel (``imbue_infer``): g and leak built per
    read, then one launch for the whole stack (a chip is a stack of
    one)."""
    r_stack, one_chip = _as_stack(state)
    sums = ops.imbue_class_sums_stack(
        lits, r_stack, state.include, state.icfg, state.tm_cfg, generator,
        vcfg=state.vcfg, device=state.device, tiles=tiles)
    return sums[0] if one_chip else sums


@register_backend("analog-cuda-packed", state_types=_ANALOG_STATES,
                  capabilities={CAP_ANALOG, CAP_FUSED_KERNEL,
                                CAP_MODELS_C2C, CAP_REPLICA_VMAP,
                                CAP_PACKED_IO},
                  priority=30, predicate=lambda s: s.packed)
def analog_cuda_packed(state, lits: torch.Tensor,
                       generator: Optional[torch.Generator] = None, *,
                       tiles: ops.Tiles = None
                       ) -> torch.Tensor:
    """Packed-wire analog kernel (``imbue_infer_packed``): literals as
    int32 words, g and leak dense float32 (noise as ``analog-cuda``)."""
    r_stack, one_chip = _as_stack(state)
    sums = ops.imbue_class_sums_stack_packed(
        _as_packed_lits(lits), r_stack, state.include, state.icfg,
        state.tm_cfg, generator, vcfg=state.vcfg, device=state.device,
        tiles=tiles)
    return sums[0] if one_chip else sums


@register_backend("analog-cuda-packed2", state_types=_ANALOG_STATES,
                  capabilities={CAP_ANALOG, CAP_FUSED_KERNEL,
                                CAP_MODELS_C2C, CAP_REPLICA_VMAP,
                                CAP_PACKED_IO, CAP_PACKED_PLANES},
                  priority=40, predicate=lambda s: s.plane_packed)
def analog_cuda_packed2(state, lits: torch.Tensor,
                        generator: Optional[torch.Generator] = None, *,
                        tiles: ops.Tiles = None
                        ) -> torch.Tensor:
    """Plane-packed analog kernel: the resident planes stay compressed
    (index bitplane + deviation plane, elided when nominal) and the CUDA
    kernel rebuilds g/leak per column (C2C per read, scalar v_ref — no
    CSA offset, so those reads fall back loudly)."""
    litw = _as_packed_lits(lits)
    l_valid = int(state.include.shape[-1])
    if isinstance(state, ReplicaStackState):
        return ops.imbue_class_sums_stack_planes(
            litw, state.plane_index, state.plane_dev, state.icfg,
            state.tm_cfg, generator, vcfg=state.vcfg, l_valid=l_valid,
            n_replicas=state.n_replicas, device=state.device, tiles=tiles)
    return ops.imbue_class_sums_planes(
        litw, state.plane_index, state.plane_dev, state.icfg, state.tm_cfg,
        generator, vcfg=state.vcfg, l_valid=l_valid, device=state.device,
        tiles=tiles)


@register_backend("coalesced", state_types=(CoalescedState,),
                  capabilities={CAP_DIGITAL, CAP_COALESCED}, priority=10)
def coalesced_torch(state: CoalescedState, lits: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Shared clause pool with a weighted digital tail, eager."""
    del generator
    cls = co.clause_outputs(state.ta_state, lits, state.cfg)
    return co.class_sums(cls, state.weights)


@register_backend("coalesced-cuda", state_types=(CoalescedState,),
                  capabilities={CAP_DIGITAL, CAP_COALESCED,
                                CAP_FUSED_KERNEL},
                  priority=20)
def coalesced_cuda(state: CoalescedState, lits: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   tiles: ops.Tiles = None
                   ) -> torch.Tensor:
    """Fused clause evaluation + weighted combine (``tm_infer`` with W in
    place of the polarity matrix)."""
    del generator
    return ops.tm_class_sums(lits, state.include, state.combine,
                             device=state.device, tiles=tiles)


@register_backend("coalesced-cuda-packed", state_types=(CoalescedState,),
                  capabilities={CAP_DIGITAL, CAP_COALESCED,
                                CAP_FUSED_KERNEL, CAP_PACKED_IO},
                  priority=30, predicate=lambda s: s.packed)
def coalesced_cuda_packed(state: CoalescedState, lits: torch.Tensor,
                          generator: Optional[torch.Generator] = None, *,
                          tiles: ops.Tiles = None
                          ) -> torch.Tensor:
    """Packed-wire coalesced kernel: AND + popcount, weighted combine
    (``tm_infer_packed``)."""
    del generator
    return ops.tm_class_sums_packed(_as_packed_lits(lits),
                                    state.include_packed, state.combine,
                                    device=state.device, tiles=tiles)


@register_backend("coalesced-cuda-packed2", state_types=(CoalescedState,),
                  capabilities={CAP_DIGITAL, CAP_COALESCED,
                                CAP_FUSED_KERNEL, CAP_PACKED_IO,
                                CAP_PACKED_PLANES},
                  priority=40, predicate=lambda s: s.plane_packed)
def coalesced_cuda_packed2(state: CoalescedState, lits: torch.Tensor,
                           generator: Optional[torch.Generator] = None, *,
                           tiles: ops.Tiles = None
                           ) -> torch.Tensor:
    """Plane-packed coalesced kernel: the resident include plane, staged
    whole and counted on the b1 tensor cores (``tm_infer_planes``; the
    same integers as ``coalesced-cuda-packed``)."""
    del generator
    return ops.tm_class_sums_planes(_as_packed_lits(lits),
                                    state.plane_index, state.combine,
                                    device=state.device, tiles=tiles)


def class_sums(state, lits: torch.Tensor,
               generator: Optional[torch.Generator] = None, *,
               backend: Optional[str] = None, require=()) -> torch.Tensor:
    """Class sums via capability-based backend selection; ``backend`` is
    a preference that falls back loudly if it cannot serve the state."""
    sel = select_backend(state, generator=generator, prefer=backend,
                         require=require)
    return sel.backend.fn(state, lits, generator)


def predict(state, x: torch.Tensor,
            generator: Optional[torch.Generator] = None, *,
            backend: Optional[str] = None) -> torch.Tensor:
    """Argmax classification from raw Boolean features ``[B, F]``.  A
    replica stack's class sums are summed over its chips before the
    argmax (``serve.ensemble_vote`` gives the majority vote)."""
    sums = class_sums(state, tm.literals(x), generator, backend=backend)
    if isinstance(state, ReplicaStackState):
        sums = sums.sum(dim=0)
    return torch.argmax(sums, dim=-1)
