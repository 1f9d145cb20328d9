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
fall back loudly to ``analog-torch``.

Every backend declares ``CAP_SHARDED``: given a state partitioned over
a mesh (``state.shard(mesh)``) or literal rows split over its ``batch``
axis, each computes this rank's block on plain local tensors (never on
``DTensor`` operands: a kernel launch on the rank's own replicas, its
class columns and its rows) and returns that block as a ``DTensor``
(``[R_local, B_local, M]`` for a stack, ``[B_local, M_local]`` for a
class-split coalesced pool); :func:`class_sums` gathers it whole, the
serving engine at collect.  An analog block draws its C2C and CSA noise
at the whole read's shape and keeps its own cells
(``variations.ReadBlock``), and the kernels compute each (replica, row)
independently of the launch's extent, so a partitioned read equals the
same backend's single-device read bit for bit.

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
                                      CAP_REPLICA_VMAP, CAP_SHARDED,
                                      register_backend, select_backend)
from repro_torch.api.states import (CoalescedState, CrossbarState,
                                    DigitalState, ReplicaStackState)
from repro_torch.core import coalesced as co
from repro_torch.core import imbue, tm
from repro_torch.core.variations import ReadBlock
from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.trace import span


def _as_packed_lits(lits: torch.Tensor) -> torch.Tensor:
    """Accept either wire format: int32 inputs are already packed words,
    anything else is a dense 0/1 literal matrix packed here."""
    if lits.dtype == torch.int32:
        return lits
    return ops.pack_literals(lits)


def _local(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of ``x`` (a plain tensor is its own)."""
    return sharding.local_block(x)[0]


def _rows_read(lits: torch.Tensor, fn) -> torch.Tensor:
    """``fn(rows)`` on this rank's literal rows, its ``[B, M]`` result
    returned as this rank's block of the whole read's."""
    layout = sharding.result_layout((lits, {0: 0}))
    sums = fn(_local(lits))
    return sums if layout is None else sharding.from_block(sums, layout)


def _coalesced_read(state: CoalescedState, lits: torch.Tensor, fn
                    ) -> torch.Tensor:
    """``fn(rows, local)`` on this rank's literal rows, ``local`` cutting
    the state's ``[C, M]`` matrices to its class columns; the ``[B, M]``
    result returned as this rank's block of the whole read's."""
    layout = sharding.result_layout((lits, {0: 0}), (state.weights, {1: 1}))
    sums = fn(_local(lits), _local)
    return sums if layout is None else sharding.from_block(sums, layout)


def _analog_read(state, lits: torch.Tensor, fn) -> torch.Tensor:
    """``fn(r_stack, rows, block)`` on this rank's part of an analog read:
    its replicas of the stack (a chip reads as a stack of one, with the
    same C2C draw per cell), its literal rows and the ``ReadBlock`` a
    partitioned read draws its noise for (None off a mesh).  The ``[R, B,
    M]`` result (``[B, M]`` for a chip) is returned as this rank's
    block."""
    if isinstance(state, ReplicaStackState):
        layout = sharding.result_layout((state.r_stack, {0: 0}),
                                        (lits, {0: 1}))
        r_stack, (r0, _, _), (n_rep, _, _) = sharding.local_block(
            state.r_stack)
    else:
        layout = sharding.result_layout((lits, {0: 0}))
        r_stack, r0, n_rep = state.r_mem[None], 0, 1
    lits, (b0, _), (n_rows, _) = sharding.local_block(lits)
    block = None if layout is None else ReadBlock(n_rep, r0, n_rows, b0)
    sums = fn(r_stack, lits, block)
    if not isinstance(state, ReplicaStackState):
        sums = sums[0]
    return sums if layout is None else sharding.from_block(sums, layout)


@register_backend("digital-torch", state_types=(DigitalState,),
                  capabilities={CAP_DIGITAL, CAP_SHARDED}, priority=10)
def digital_torch(state: DigitalState, lits: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Boolean-domain reference: violation product + polarity counters."""
    del generator                            # digital path is noise-free
    return _rows_read(lits, lambda x: tm.class_sums(
        tm.clause_outputs_from_include(state.include, x), state.tm_cfg))


@register_backend("digital-cuda", state_types=(DigitalState,),
                  capabilities={CAP_DIGITAL, CAP_FUSED_KERNEL, CAP_SHARDED},
                  priority=20)
def digital_cuda(state: DigitalState, lits: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 tiles: ops.Tiles = None) -> torch.Tensor:
    """Fused clause evaluation + polarity combine (``tm_infer``)."""
    del generator
    return _rows_read(lits, lambda x: ops.tm_class_sums(
        x, state.include, state.combine, device=state.device, tiles=tiles))


@register_backend("digital-cuda-packed", state_types=(DigitalState,),
                  capabilities={CAP_DIGITAL, CAP_FUSED_KERNEL,
                                CAP_PACKED_IO, CAP_SHARDED},
                  priority=30, predicate=lambda s: s.packed)
def digital_cuda_packed(state: DigitalState, lits: torch.Tensor,
                        generator: Optional[torch.Generator] = None, *,
                        tiles: ops.Tiles = None
                        ) -> torch.Tensor:
    """Packed-wire digital kernel: int32 words, AND + popcount
    (``tm_infer_packed``)."""
    del generator
    return _rows_read(lits, lambda x: ops.tm_class_sums_packed(
        _as_packed_lits(x), state.include_packed, state.combine,
        device=state.device, tiles=tiles))


_ANALOG_STATES = (CrossbarState, ReplicaStackState)


@register_backend("analog-torch", state_types=_ANALOG_STATES,
                  capabilities={CAP_ANALOG, CAP_MODELS_C2C,
                                CAP_MODELS_CSA_OFFSET, CAP_REPLICA_VMAP,
                                CAP_SHARDED},
                  priority=10)
def analog_torch(state, lits: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Eager KCL + per-column CSA compare (the full noise model)."""
    nonempty = state.include.any(dim=-1)
    if isinstance(state, CrossbarState):
        cls = imbue.analog_clause_outputs_raw(
            state.r_mem, state.include, lits, state.mapping, state.icfg,
            generator, state.vcfg)                           # [B, C]
        return tm.class_sums(cls * nonempty.to(cls.dtype), state.tm_cfg)

    def read(r_stack, x, block):
        cls = imbue.stacked_clause_outputs(
            r_stack, state.include, x, state.tm_cfg, generator, state.vcfg,
            state.icfg, block)                               # [R, B, C]
        return tm.class_sums(cls * nonempty.to(cls.dtype), state.tm_cfg)
    return _analog_read(state, lits, read)


@register_backend("analog-cuda", state_types=_ANALOG_STATES,
                  capabilities={CAP_ANALOG, CAP_FUSED_KERNEL,
                                CAP_MODELS_C2C, CAP_REPLICA_VMAP,
                                CAP_SHARDED},
                  priority=20)
def analog_cuda(state, lits: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                tiles: ops.Tiles = None
                ) -> torch.Tensor:
    """Dense-plane analog kernel (``imbue_infer``): g and leak built per
    read, then one launch for the whole stack (a chip is a stack of
    one)."""
    return _analog_read(state, lits, lambda r, x, block:
                        ops.imbue_class_sums_stack(
                            x, r, state.include, state.icfg, state.tm_cfg,
                            generator, vcfg=state.vcfg, device=r.device,
                            tiles=tiles, block=block))


@register_backend("analog-cuda-packed", state_types=_ANALOG_STATES,
                  capabilities={CAP_ANALOG, CAP_FUSED_KERNEL,
                                CAP_MODELS_C2C, CAP_REPLICA_VMAP,
                                CAP_PACKED_IO, CAP_SHARDED},
                  priority=30, predicate=lambda s: s.packed)
def analog_cuda_packed(state, lits: torch.Tensor,
                       generator: Optional[torch.Generator] = None, *,
                       tiles: ops.Tiles = None
                       ) -> torch.Tensor:
    """Packed-wire analog kernel (``imbue_infer_packed``): literals as
    int32 words, g and leak dense float32 (noise as ``analog-cuda``)."""
    return _analog_read(state, lits, lambda r, x, block:
                        ops.imbue_class_sums_stack_packed(
                            _as_packed_lits(x), r, state.include, state.icfg,
                            state.tm_cfg, generator, vcfg=state.vcfg,
                            device=r.device, tiles=tiles, block=block))


@register_backend("analog-cuda-packed2", state_types=_ANALOG_STATES,
                  capabilities={CAP_ANALOG, CAP_FUSED_KERNEL,
                                CAP_MODELS_C2C, CAP_REPLICA_VMAP,
                                CAP_PACKED_IO, CAP_PACKED_PLANES,
                                CAP_SHARDED},
                  priority=40, predicate=lambda s: s.plane_packed)
def analog_cuda_packed2(state, lits: torch.Tensor,
                        generator: Optional[torch.Generator] = None, *,
                        tiles: ops.Tiles = None
                        ) -> torch.Tensor:
    """Plane-packed analog kernel: the resident planes stay compressed
    (index bitplane + deviation plane, elided when nominal) and the CUDA
    kernel rebuilds g/leak per column (C2C per read, scalar v_ref — no
    CSA offset, so those reads fall back loudly)."""
    dev = state.plane_dev
    if dev is not None:
        dev = (_local(dev) if isinstance(state, ReplicaStackState)
               else dev[None])

    def read(r_stack, x, block):
        return ops.imbue_class_sums_stack_planes(
            _as_packed_lits(x), state.plane_index, dev, state.icfg,
            state.tm_cfg, generator, vcfg=state.vcfg,
            l_valid=int(state.include.shape[-1]),
            n_replicas=int(r_stack.shape[0]), device=r_stack.device,
            tiles=tiles, block=block)
    return _analog_read(state, lits, read)


@register_backend("coalesced", state_types=(CoalescedState,),
                  capabilities={CAP_DIGITAL, CAP_COALESCED, CAP_SHARDED},
                  priority=10)
def coalesced_torch(state: CoalescedState, lits: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Shared clause pool with a weighted digital tail, eager."""
    del generator
    return _coalesced_read(state, lits, lambda x, local: co.class_sums(
        co.clause_outputs(state.ta_state, x, state.cfg),
        local(state.weights)))


@register_backend("coalesced-cuda", state_types=(CoalescedState,),
                  capabilities={CAP_DIGITAL, CAP_COALESCED,
                                CAP_FUSED_KERNEL, CAP_SHARDED},
                  priority=20)
def coalesced_cuda(state: CoalescedState, lits: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   tiles: ops.Tiles = None
                   ) -> torch.Tensor:
    """Fused clause evaluation + weighted combine (``tm_infer`` with W in
    place of the polarity matrix)."""
    del generator
    return _coalesced_read(state, lits, lambda x, local: ops.tm_class_sums(
        x, state.include, local(state.combine), device=state.device,
        tiles=tiles))


@register_backend("coalesced-cuda-packed", state_types=(CoalescedState,),
                  capabilities={CAP_DIGITAL, CAP_COALESCED,
                                CAP_FUSED_KERNEL, CAP_PACKED_IO,
                                CAP_SHARDED},
                  priority=30, predicate=lambda s: s.packed)
def coalesced_cuda_packed(state: CoalescedState, lits: torch.Tensor,
                          generator: Optional[torch.Generator] = None, *,
                          tiles: ops.Tiles = None
                          ) -> torch.Tensor:
    """Packed-wire coalesced kernel: AND + popcount, weighted combine
    (``tm_infer_packed``)."""
    del generator
    return _coalesced_read(
        state, lits, lambda x, local: ops.tm_class_sums_packed(
            _as_packed_lits(x), state.include_packed, local(state.combine),
            device=state.device, tiles=tiles))


@register_backend("coalesced-cuda-packed2", state_types=(CoalescedState,),
                  capabilities={CAP_DIGITAL, CAP_COALESCED,
                                CAP_FUSED_KERNEL, CAP_PACKED_IO,
                                CAP_PACKED_PLANES, CAP_SHARDED},
                  priority=40, predicate=lambda s: s.plane_packed)
def coalesced_cuda_packed2(state: CoalescedState, lits: torch.Tensor,
                           generator: Optional[torch.Generator] = None, *,
                           tiles: ops.Tiles = None
                           ) -> torch.Tensor:
    """Plane-packed coalesced kernel: the resident include plane, staged
    whole and counted on the b1 tensor cores (``tm_infer_planes``; the
    same integers as ``coalesced-cuda-packed``)."""
    del generator
    return _coalesced_read(
        state, lits, lambda x, local: ops.tm_class_sums_planes(
            _as_packed_lits(x), state.plane_index, local(state.combine),
            device=state.device, tiles=tiles))


def class_sums(state, lits: torch.Tensor,
               generator: Optional[torch.Generator] = None, *,
               backend: Optional[str] = None, require=()) -> torch.Tensor:
    """Class sums via capability-based backend selection; ``backend`` is
    a preference that falls back loudly if it cannot serve the state.  A
    partitioned read's blocks are gathered whole (a collective: every
    rank of the mesh calls this)."""
    with span("repro_torch.api.class_sums"):
        with span("repro_torch.api.select_backend"):
            sel = select_backend(state, generator=generator, prefer=backend,
                                 require=require)
        return sharding.gather(sel.backend.fn(state, lits, generator))


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
