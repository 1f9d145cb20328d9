"""Named host spans of the port, on the profiler's clock.

``span(name)`` marks a phase of a call (``with span("repro_torch.x"):``).
While a ``torch.profiler`` records, it opens a function-scope profiler
range: the range lands among the trace's CPU events, on the clock of its
CUDA events, and puts nothing on the device timeline (kineto mirrors
only user-scope ranges, such as ``record_function``'s, onto the device
as annotations).  While none records, it hands back one shared null
context: one check, nothing allocated, no ``RecordFunction`` made.

Spans nest by containment on the calling thread.  Every name starts
with ``repro_torch.``; a count of spans in a traced window is the count
of calls, so there is no registry beside the kernel wrappers'
``.launches`` counters.  Whoever runs the profiler gets the spans; there
is no switch.  ``benchmarks/profile_spans.py`` prints a benchmark cell's
traced window by span; the benchmark's span metrics read some of them.

=====================================  ======================================
span                                   around
=====================================  ======================================
``repro_torch.tm_train.step``          all of ``train_step_batch``
``repro_torch.tm_train.clause_eval``   its literals, packing, clause kernel
                                       and class sums
``repro_torch.tm_train.split``         ``variations.split_generator``
``repro_torch.tm_train.draw``          each chunk's feedback draws
``repro_torch.tm_train.update``        each chunk's TA delta and its sum
``repro_torch.tm_train.clip``          the final clip
``repro_torch.tm.literals``            ``core.tm.literals``
``repro_torch.api.class_sums``         ``api.class_sums``
``repro_torch.api.select_backend``     its backend selection
``repro_torch.ops.pack_literals``      ``ops.pack_literals``
``repro_torch.ops.c2c_deviation``      ``ops.c2c_deviation``, the C2C draw
``repro_torch.kernels.<kernel>``       each IMBUE or TM kernel's launch
``repro_torch.serve.ensemble_vote``    ``serve.replica.ensemble_vote``
``repro_torch.kernels.build``          an ``nvcc`` run of ``_build.build``
=====================================  ======================================
"""

from __future__ import annotations

import contextlib

from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

_NULL = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else the
    shared null context."""
    if _profiler_enabled():
        return _RecordFunctionFast(name)
    return _NULL
