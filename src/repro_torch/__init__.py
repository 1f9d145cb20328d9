"""``repro_torch`` — the IMBUE inference stack in PyTorch, with hand-written
CUDA kernels for Hopper (``sm_90a``).

This package is the port of ``repro`` (JAX + Pallas for the TPU), which
stays beside it as the reference.  It mirrors ``repro``'s subpackage and
module names so each counterpart is easy to find; it imports ``torch``
and ``numpy`` only, never ``jax`` and nothing of ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the tests do); with no ``device`` argument and no CUDA they raise.  On a
CPU tensor a kernel wrapper computes with its plain PyTorch version; on a
CUDA tensor it launches the kernel or raises.

Ported so far (the serving paths, streaming, TM training and flash
attention):

* ``kernels.bitpack`` / ``kernels.ops`` / ``kernels.imbue_infer`` — the
  packed wire format and the ``imbue_infer_planes`` CUDA kernel;
* ``core.tm`` / ``core.variations`` / ``core.mapping`` / ``core.imbue`` /
  ``core.energy`` — the digital TM and the analog crossbar model;
* ``api`` — ``ReplicaStackState``/``DigitalState``, the capability
  registry and its backends;
* ``serve`` — batcher, metrics, replica pool and the synchronous
  ``ServeEngine``;
* ``convert`` — carries programmed arrays across from the reference;
* ``core.tm_train`` / the training half of ``core.coalesced`` — TM and
  coalesced training, clauses evaluated by the ``clause_eval_packed``
  (batch steps) and ``clause_eval`` (sequential steps) CUDA kernels;
* ``train.online`` — the replay-buffer ``OnlineTrainer``;
* ``distributed.checkpoint`` — digest-verified checkpoints, in the
  reference's format;
* ``data.tm_datasets`` — noisy XOR, the synthetic image set, the KWS-6
  and sensor-anomaly frame streams and their offline windows, and the
  paper's Table IV;
* ``core.booleanize`` / ``serve.stream`` / ``launch.stream`` — the
  thermometer booleanizers, per-session sliding windows over a shared
  engine (``StreamServer``) and the streaming CLI;
* ``core.imbue``'s Monte-Carlo studies — ``monte_carlo_accuracy``,
  ``clause_error_rate``, ``stacked_class_sums``;
* ``kernels.flash_attention`` — ``flash_attention`` and the
  differentiable ``flash_attention_trainable`` on the ``flash_fwd``,
  ``flash_bwd_dkv`` and ``flash_bwd_dq`` CUDA kernels.  Unlike the
  other entry points they take no ``device``: they run where their
  tensors lie.

``trace.span`` names the phases of the training step, the scoring call
and the kernel launches as ``repro_torch.*`` ranges for whoever runs
``torch.profiler``; with no profiler running it costs one check.
"""
