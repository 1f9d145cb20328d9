"""``repro_torch.api`` — the port's inference surface (port of
``repro.api``): backend states, the capability registry with its
measured per-(backend, shape bucket) tuning table, and the registered
backends behind one ``class_sums(state, lits, generator)`` and
``predict(state, x, generator)``."""

from repro_torch.api.backends import class_sums, predict
from repro_torch.api.registry import (CAP_ANALOG, CAP_COALESCED,
                                      CAP_DIGITAL, CAP_FUSED_KERNEL,
                                      CAP_MODELS_C2C,
                                      CAP_MODELS_CSA_OFFSET, CAP_PACKED_IO,
                                      CAP_PACKED_PLANES, CAP_REPLICA_VMAP,
                                      CAP_SHARDED, KNOWN_CAPABILITIES,
                                      REF_SHAPE_KEY,
                                      Backend, Selection, clear_tuning,
                                      device_signature, get_backend,
                                      get_tuning, list_backends,
                                      register_backend, register_tuning,
                                      required_capabilities, restore_tuning,
                                      select_backend, shape_bucket_key,
                                      shape_key_of, tuning_snapshot)
from repro_torch.api.states import (CoalescedState, CrossbarState,
                                    DigitalState, ReplicaStackState)

__all__ = [
    "class_sums", "predict", "Backend", "Selection", "get_backend",
    "list_backends", "register_backend", "required_capabilities",
    "select_backend", "register_tuning", "get_tuning", "clear_tuning",
    "tuning_snapshot", "restore_tuning", "shape_bucket_key", "shape_key_of",
    "device_signature", "REF_SHAPE_KEY", "KNOWN_CAPABILITIES", "CAP_ANALOG",
    "CAP_COALESCED", "CAP_DIGITAL", "CAP_FUSED_KERNEL", "CAP_MODELS_C2C",
    "CAP_MODELS_CSA_OFFSET", "CAP_PACKED_IO", "CAP_PACKED_PLANES",
    "CAP_REPLICA_VMAP", "CAP_SHARDED", "CoalescedState", "CrossbarState",
    "DigitalState", "ReplicaStackState",
]
