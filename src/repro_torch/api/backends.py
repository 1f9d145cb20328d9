"""The registered forward backends + the uniform entry point (port of
``repro.api.backends``).

All backends share one contract:

    class_sums(state, lits, generator=None) -> int32 [..., M]

``lits`` is the ``[B, 2F]`` uint8 literal matrix (``core.tm.literals``)
or, for the ``packed_io`` backend, the ``[B, ceil(2F/32)]`` int32 word
plane (``ops.pack_literals``); ``ReplicaStackState`` inputs give
``[R, B, M]``.  Backends run where the state's tensors live.

=======================  ===================  ===========================
name                     states               capability notes
=======================  ===================  ===========================
``digital-torch``        Digital              the bit-exact reference
                                              (``digital-jnp``)
``analog-torch``         ReplicaStack         eager, models C2C **and**
                                              CSA offset (``analog-jnp``)
``analog-cuda-packed2``  ReplicaStack         the ``imbue_infer_planes``
                         (plane-packed)       CUDA kernel, one launch per
                                              stack (``analog-pallas-
                                              packed2``); no CSA offset
=======================  ===================  ===========================
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api.registry import (CAP_ANALOG, CAP_DIGITAL,
                                      CAP_FUSED_KERNEL, CAP_MODELS_C2C,
                                      CAP_MODELS_CSA_OFFSET, CAP_PACKED_IO,
                                      CAP_PACKED_PLANES, CAP_REPLICA_VMAP,
                                      register_backend, select_backend)
from repro_torch.api.states import DigitalState, ReplicaStackState
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


@register_backend("analog-torch", state_types=(ReplicaStackState,),
                  capabilities={CAP_ANALOG, CAP_MODELS_C2C,
                                CAP_MODELS_CSA_OFFSET, CAP_REPLICA_VMAP},
                  priority=10)
def analog_torch(state: ReplicaStackState, lits: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Eager KCL + per-column CSA compare (the full noise model)."""
    cls = imbue.stacked_clause_outputs(
        state.r_stack, state.include, lits, state.tm_cfg, generator,
        state.vcfg, state.icfg)                              # [R, B, C]
    cls = cls * state.include.any(dim=-1).to(cls.dtype)
    return tm.class_sums(cls, state.tm_cfg)


@register_backend("analog-cuda-packed2", state_types=(ReplicaStackState,),
                  capabilities={CAP_ANALOG, CAP_FUSED_KERNEL,
                                CAP_MODELS_C2C, CAP_REPLICA_VMAP,
                                CAP_PACKED_IO, CAP_PACKED_PLANES},
                  priority=40, predicate=lambda s: s.plane_packed)
def analog_cuda_packed2(state: ReplicaStackState, lits: torch.Tensor,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """Plane-packed analog kernel: the resident stack stays compressed
    (index bitplane + deviation plane, elided when nominal) and the CUDA
    kernel rebuilds g/leak per column (C2C per read, scalar v_ref — no
    CSA offset, so those reads fall back loudly)."""
    return ops.imbue_class_sums_stack_planes(
        _as_packed_lits(lits), state.plane_index, state.plane_dev,
        state.icfg, state.tm_cfg, generator, vcfg=state.vcfg,
        l_valid=int(state.include.shape[-1]), n_replicas=state.n_replicas,
        device=state.device)


def class_sums(state, lits: torch.Tensor,
               generator: Optional[torch.Generator] = None, *,
               backend: Optional[str] = None, require=()) -> torch.Tensor:
    """Class sums via capability-based backend selection; ``backend`` is
    a preference that falls back loudly if it cannot serve the state."""
    sel = select_backend(state, generator=generator, prefer=backend,
                         require=require)
    return sel.backend.fn(state, lits, generator)
