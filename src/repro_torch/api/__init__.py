"""``repro_torch.api`` — the port's inference surface (port of
``repro.api``): backend states, the capability registry, and the
registered backends behind one ``class_sums(state, lits, generator)``
and ``predict(state, x, generator)``."""

from repro_torch.api.backends import class_sums, predict
from repro_torch.api.registry import (CAP_ANALOG, CAP_COALESCED,
                                      CAP_DIGITAL, CAP_FUSED_KERNEL,
                                      CAP_MODELS_C2C,
                                      CAP_MODELS_CSA_OFFSET, CAP_PACKED_IO,
                                      CAP_PACKED_PLANES, CAP_REPLICA_VMAP,
                                      KNOWN_CAPABILITIES, Backend, Selection,
                                      get_backend, list_backends,
                                      register_backend, required_capabilities,
                                      select_backend)
from repro_torch.api.states import (CoalescedState, CrossbarState,
                                    DigitalState, ReplicaStackState)

__all__ = [
    "class_sums", "predict", "Backend", "Selection", "get_backend",
    "list_backends", "register_backend", "required_capabilities",
    "select_backend", "KNOWN_CAPABILITIES", "CAP_ANALOG", "CAP_COALESCED",
    "CAP_DIGITAL", "CAP_FUSED_KERNEL", "CAP_MODELS_C2C",
    "CAP_MODELS_CSA_OFFSET", "CAP_PACKED_IO", "CAP_PACKED_PLANES",
    "CAP_REPLICA_VMAP", "CoalescedState", "CrossbarState", "DigitalState",
    "ReplicaStackState",
]
