"""The five span readers on made-up traces, against values worked out by
hand, and the program's spans in the harness's own trace of a tiny
window on the host."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from imbue_bench import harness, spans
from imbue_bench import trace as tracing
from imbue_bench.tests import tiny
from imbue_bench.tests.tiny import ROOT, one_thread  # noqa: F401
from imbue_bench.trace import Trace

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_READERS = ("draw_host_ms.train", "idle_in_draw.train",
                "idle_outside_program.train", "call_host_ms.score",
                "idle_outside_program.score")
STEP, CLAUSES, SPLIT, DRAW, UPDATE = (
    f"repro_torch.tm_train.{n}"
    for n in ("step", "clause_eval", "split", "draw", "update"))
LITS, SUMS, SELECT, PACK, KERNEL, VOTE = (
    "repro_torch.tm.literals", "repro_torch.api.class_sums",
    "repro_torch.api.select_backend", "repro_torch.ops.pack_literals",
    "repro_torch.kernels.tm_infer_packed", "repro_torch.serve.ensemble_vote")


def train_trace(with_spans=True):
    """Two steps in a 10 ms window.  Device busy at 1-2, 4-4.8, 5.2-6 and
    8-9 ms: gaps 0-1, 2-4 (across split, draw and update), 4.8-5.2 (no
    span open), 6-8 and 9-10 ms: 6.4 ms idle."""
    dev = [("k", 1000, 2000), ("k", 4000, 4800), ("k", 5200, 6000),
           ("k", 8000, 9000)]
    host = [("aten::add", 1600, 1700), ("cudaLaunchKernel", 3100, 3110)]
    if with_spans:
        host += [(STEP, 500, 4800), (CLAUSES, 600, 1500),
                 (SPLIT, 1500, 2500), (DRAW, 2500, 3000),
                 (UPDATE, 3000, 4500),
                 (STEP, 5500, 9500), (DRAW, 6500, 7200),
                 (UPDATE, 7200, 9400)]
    return Trace(dev, host, (0, 10_000))


def score_trace(with_spans=True):
    """Two calls in a 10 ms window, the first literals' span begun before
    it.  Device busy at 1-3 and 6-9 ms: gaps 0-1 (all inside spans), 3-6
    (2 ms with none open, 0.2 in literals, 0.8 in class sums) and 9-10
    (none open): 5 ms idle."""
    dev = [("k", 1000, 3000), ("k", 6000, 9000)]
    host = [("cudaEventSynchronize", 2900, 4900)]
    if with_spans:
        host += [(LITS, -200, 100), (LITS, 100, 300), (SUMS, 300, 2500),
                 (SELECT, 300, 350), (PACK, 400, 900), (KERNEL, 1000, 1100),
                 (VOTE, 2600, 2800),
                 (LITS, 5000, 5200), (SUMS, 5200, 7000), (VOTE, 7100, 7300)]
    return Trace(dev, host, (0, 10_000))


def ctx(tr, n=2):
    return SimpleNamespace(trace=tr, counters={"steps": n, "calls": n})


def read(name, c):
    return harness.load_reader(ROOT, MANIFEST, name).read(c)


def test_innermost_pieces_by_hand():
    pieces = spans.innermost(spans.program_spans(train_trace()), (0, 10_000))
    assert pieces == [
        (0, 500, None), (500, 600, STEP), (600, 1500, CLAUSES),
        (1500, 2500, SPLIT), (2500, 3000, DRAW), (3000, 4500, UPDATE),
        (4500, 4800, STEP), (4800, 5500, None), (5500, 6500, STEP),
        (6500, 7200, DRAW), (7200, 9400, UPDATE), (9400, 9500, STEP),
        (9500, 10_000, None)]


def test_a_span_that_outlasts_its_parent_is_cut_to_it():
    found = [("repro_torch.a", 0, 50), ("repro_torch.b", 10, 80)]
    assert spans.innermost(found, (0, 100)) == [
        (0, 10, "repro_torch.a"), (10, 50, "repro_torch.b"),
        (50, 100, None)]


def test_breakdown_by_span_by_hand():
    """``by_span``, which ``benchmarks/profile_spans.py`` prints: own
    times and idle times each add up to the window and to its 6.4 ms of
    idle."""
    rows = spans.by_span(train_trace())
    want = {None: (0, 1700, 1700, 1400), STEP: (2, 8300, 1500, 700),
            CLAUSES: (1, 900, 900, 400), SPLIT: (1, 1000, 1000, 500),
            DRAW: (2, 1200, 1200, 1200), UPDATE: (2, 3700, 3700, 2200)}
    assert {name: tuple(row[k] for k in ("count", "incl_us", "own_us",
                                         "idle_us"))
            for name, row in rows.items()} == want
    assert sum(row["own_us"] for row in rows.values()) == 10_000
    assert sum(row["idle_us"] for row in rows.values()) == 6400


def test_training_readers_by_hand():
    c = ctx(train_trace())
    assert read("device_idle.train", c) == pytest.approx(64.0)
    # split 1 ms + draws 0.5 and 0.7 ms, over two steps
    assert read("draw_host_ms.train", c) == pytest.approx(2.2 / 2)
    # idle in split 2-2.5, draw 2.5-3 and draw 6.5-7.2 ms
    assert read("idle_in_draw.train", c) == pytest.approx(17.0)
    # idle with no span open: 0-0.5, 4.8-5.2 and 9.5-10 ms
    assert read("idle_outside_program.train", c) == pytest.approx(14.0)


def test_scoring_readers_by_hand():
    c = ctx(score_trace())
    assert read("device_idle.score", c) == pytest.approx(50.0)
    # 0-2.5, 2.6-2.8, 5-7 and 7.1-7.3 ms inside the outermost spans
    assert read("call_host_ms.score", c) == pytest.approx(4.9 / 2)
    assert read("idle_outside_program.score", c) == pytest.approx(30.0)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_a_program_without_spans_reads_nothing(name):
    """An older program, traced with these readers, opens no span: each
    reader finds nothing and raises nothing."""
    tr = (train_trace if name.endswith(".train") else score_trace)(False)
    assert tr.device_ops and read(name, ctx(tr)) is None


@pytest.mark.parametrize("kind", ["train", "score"])
def test_idle_parts_stay_within_the_idle_share(kind):
    c = ctx(train_trace() if kind == "train" else score_trace())
    parts = [read(n, c) for n in SPAN_READERS
             if n.startswith("idle_") and n.endswith(kind)]
    assert parts and all(p >= 0 for p in parts)
    assert sum(parts) <= read(f"device_idle.{kind}", c)


@pytest.mark.parametrize("cell,span,counter", [
    ("kmnist-train-b256", STEP, "steps"),
    ("kmnist-digital-score", SUMS, "calls")])
def test_the_harness_trace_holds_the_programs_spans(tmp_path, cell, span,
                                                    counter):
    """A tiny window of the cell traced on the host, as ``--trace 1``
    traces it: one span a step or call, and the program's spans cut the
    window into pieces that cover it."""
    root = tiny.make_root(tmp_path)
    manifest = harness.load_manifest(root)
    _, config, traffic = harness.resolve(root, manifest, cell)
    runner = harness.kind_module(traffic).Cell(device="cpu", seed=5,
                                               config=config,
                                               traffic=traffic)
    runner.setup()
    counters, tr = tracing.capture(lambda: runner.window(0.2))
    found = spans.program_spans(tr)
    assert sum(name == span for name, _, _ in found) == counters[counter]
    pieces = spans.innermost(found, tr.window)
    assert pieces[0][0] == tr.window[0] and pieces[-1][1] == tr.window[1]
    assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
    assert {name for _, _, name in pieces} > {None, span}
