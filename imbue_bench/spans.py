"""The program's own spans in a traced window: the host ranges whose name
starts with ``repro_torch.`` (``src/repro_torch/trace.py``), among the
trace's host operations on the profiler's clock.

Spans nest by containment on the program's thread.  The readers of the
span metrics cut the window by the innermost span open at each instant
and lay the device's idle stretches (``Trace.gaps``) over those pieces,
each in one sweep of sorted intervals; ``by_span`` gives the whole
window by span, as ``benchmarks/profile_spans.py`` prints it.  A program
without spans (an older checkout) gives none, and the readers then read
nothing.
"""

from __future__ import annotations

import collections

PREFIX = "repro_torch."


def program_spans(trace, names=None):
    """``(name, start, end)`` of the program's spans (those in ``names``,
    if given), cut to the window; outer before inner at one start."""
    w0, w1 = trace.window
    out = []
    for name, s, e in trace.host_ops:
        if name.startswith(PREFIX) and (names is None or name in names):
            s, e = max(s, w0), min(e, w1)
            if e > s:
                out.append((name, s, e))
    out.sort(key=lambda span: (span[1], -span[2]))
    return out


def covered_us(spans) -> float:
    """Microseconds in which at least one of ``spans`` is open."""
    total, t = 0.0, float("-inf")
    for _, s, e in spans:
        if e > t:
            total += e - max(s, t)
            t = e
    return total


def innermost(spans, window):
    """The window cut into ``(start, end, name)`` pieces, ``name`` the
    innermost of ``spans`` open there, None where none is.  A span that
    outlasts the one it opened in is cut to it."""
    w0, w1 = window
    pieces, stack, t = [], [], w0

    def close(until, name):
        nonlocal t
        if until > t:
            pieces.append((t, until, name))
            t = until

    for name, s, e in spans:
        while stack and stack[-1][1] <= s:
            inner, end = stack.pop()
            close(end, inner)
        close(s, stack[-1][0] if stack else None)
        stack.append((name, min(e, stack[-1][1]) if stack else e))
    while stack:
        inner, end = stack.pop()
        close(end, inner)
    close(w1, None)
    return pieces


def _idle_in(pieces, gaps) -> collections.Counter:
    """Idle microseconds of the device in each piece's name, one sweep."""
    out = collections.Counter()
    i = 0
    for g0, g1 in gaps:
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < g1:
            s, e, name = pieces[j]
            out[name] += min(e, g1) - max(s, g0)
            j += 1
    return out


def idle_by_span(trace, spans) -> collections.Counter:
    """Idle microseconds of the device by the innermost span open at the
    time (None: no span open)."""
    return _idle_in(innermost(spans, trace.window), trace.gaps())


def by_span(trace) -> dict:
    """The window by span name (None: no span open): ``count``, host
    microseconds with the span open (``incl_us``) and innermost
    (``own_us``), and the device's idle microseconds while it is
    innermost (``idle_us``)."""
    found = program_spans(trace)
    pieces = innermost(found, trace.window)
    out = {}
    for name in [None] + sorted({name for name, _, _ in found}):
        mine = [span for span in found if span[0] == name]
        out[name] = {"count": len(mine), "incl_us": covered_us(mine),
                     "own_us": 0.0, "idle_us": 0.0}
    out[None]["incl_us"] = trace.window_s * 1e6 - covered_us(found)
    for s, e, name in pieces:
        out[name]["own_us"] += e - s
    for name, us in _idle_in(pieces, trace.gaps()).items():
        out[name]["idle_us"] = us
    return out
