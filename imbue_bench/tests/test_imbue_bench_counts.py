"""The frozen counts at hand-worked shapes, and the trace reduction and
the per-layer readers on a made-up trace."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from imbue_bench import counts, harness
from imbue_bench.tests.tiny import ROOT
from imbue_bench.trace import Trace

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_peaks_are_the_published_ones():
    assert counts.LOP3_PER_S == pytest.approx(64 * 132 * 1.98e9)
    assert counts.HBM_BYTES_PER_S == 3.35e12
    assert counts.INT8_OP_PER_S == 1979e12


def test_analog_planes_by_hand():
    # 2 chips, 3 rows, 4 clauses, 40 literals (2 words), 2 classes.
    nbytes, work = counts.analog_planes(3, 2, 4, 40, 2)
    assert nbytes == 4 * (3 * 2 + 4 * 2 + 2 * 4 * 40 + 4 * 2 + 2 * 3 * 2)
    assert work == [(4 * 2 * 3 * 4 * 40, counts.FP32_FLOP_PER_S)]
    # At the analog cell: operation-bound, 7.49 ms a 10,000-row read.
    least = counts.bound_s(*counts.analog_planes(10_000, 4, 2000, 1568, 10))
    assert least == pytest.approx(4 * 4 * 10_000 * 2000 * 1568 / 67e12)


def test_tm_packed_by_hand():
    nbytes, work = counts.tm_packed(3, 4, 40, 2)
    assert nbytes == 4 * (3 * 2 + 4 * 2 + 4 * 2 + 3 * 2)
    assert work == [(3 * 4 * 2, counts.LOP3_PER_S),
                    (2 * 3 * 4 * 2, counts.FP32_FLOP_PER_S)]
    least = counts.bound_s(*counts.tm_packed(10_000, 5000, 1568, 10))
    assert least == pytest.approx(10_000 * 5000 * 49 / counts.LOP3_PER_S
                                  + 2 * 10_000 * 5000 * 10 / 67e12)
    assert 1.6e-4 < least < 1.7e-4


def test_model_work():
    assert counts.score_ops(10_000, 4, 3_136_000) == 10_000 * 4 * 3_136_000
    assert counts.train_ops(256, 7_840_000) == 2 * 256 * 7_840_000
    assert counts.bound_s(3.35e12, [(1.0, 1.0)]) == 1.0


KERNEL = ("void imbue::core_kernel<(anonymous namespace)::PlaneSource<true, "
          "true> >(...)")


def made_up_trace():
    """A 10 ms window: the analog kernel twice (2 ms each), a pre-pass
    kernel and a copy (0.5 ms each), overlapping kernels merged."""
    dev = [(KERNEL, 1000, 3000), (KERNEL, 5000, 7000),
           ("void at::native::uniform_kernel", 500, 1000),
           ("Memcpy DtoH (Device -> Pinned)", 7000, 7500),
           ("void at::native::other", 6500, 6800)]
    host = [("aten::rand", 200, 600), ("cudaEventSynchronize", 7500, 9900)]
    return Trace(dev, host, (0, 10_000))


def test_trace_reduction():
    tr = made_up_trace()
    assert tr.window_s == pytest.approx(0.01)
    assert tr.busy_s == pytest.approx(0.0050)
    assert [tuple(g) for g in tr.gaps()] == [(0, 500), (3000, 5000),
                                             (7500, 10_000)]
    assert len(tr.kernels()) == 4 and len(tr.kernels("PlaneSource")) == 2
    bd = tr.breakdown()
    assert bd["device_ops"][0] == [KERNEL, pytest.approx(0.004)]
    assert dict((k, v) for k, v in bd["idle_gaps"]) == pytest.approx(
        {"python": 0.0025, "cudaEventSynchronize": 0.0025})


def ctx_for(tr, calls=2, rows=10_000):
    shape = {"rows": rows, "replicas": 4, "clauses": 2000,
             "literals": 1568, "classes": 10, "ta_cells": 3_136_000,
             "batch": 256}
    counters = {"calls": calls, "rows": calls * rows, "steps": calls,
                "examples": calls * 256, "window_s": tr.window_s,
                "latencies_s": [0.001 * i for i in range(1, 21)]}
    return SimpleNamespace(trace=tr, counters=counters, shape=shape)


def read(name, ctx):
    return harness.load_reader(ROOT, MANIFEST, name).read(ctx)


def test_readers_on_a_made_up_trace():
    ctx = ctx_for(made_up_trace())
    least = counts.bound_s(*counts.analog_planes(10_000, 4, 2000, 1568, 10))
    assert read("analog_kernel_roofline", ctx) == pytest.approx(
        100 * least / 0.002)
    assert read("tm_kernel_roofline", ctx) is None
    assert read("aux_device_ms.score", ctx) == pytest.approx(
        (0.0053 - 0.004) * 1e3 / 2)
    assert read("launches_per_call.score", ctx) == 2.0
    assert read("device_idle.score", ctx) == pytest.approx(50.0)
    assert read("device_idle.train", ctx) == pytest.approx(50.0)
    assert read("train_device_ms", ctx) == pytest.approx(5.3 / 2)
    assert read("launches_per_step.train", ctx) == 2.0
    assert read("call_p95_ms.digital", ctx) == pytest.approx(19.0)
    assert read("score_mfu", ctx) == pytest.approx(
        100 * 2 * 10_000 * 4 * 3_136_000 / (0.01 * 1979e12))
    assert read("train_mfu", ctx) == pytest.approx(
        100 * 2 * 512 * 3_136_000 / (0.01 * 1979e12))


@pytest.mark.parametrize("name", [m["name"] for m in MANIFEST["per_layer"]
                                  if m["source"] == "device_trace"])
def test_device_readers_find_nothing_in_an_empty_trace(name):
    assert read(name, ctx_for(Trace([], [], (0, 1000)))) is None
