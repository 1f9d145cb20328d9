"""The port's spans (``repro_torch.trace``): with no profiler running a
span is the one shared null context; under a ``torch.profiler`` the
training step and the scoring call give the documented tree of
``repro_torch.*`` host ranges; the kernel wrappers' ``.launches``
counters read as before.  On the card: the spans stay off the device
timeline (run with ``-m cuda --noconftest``, as ``test_torch_cuda.py``)."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import api, trace  # noqa: E402
from repro_torch.core import tm, tm_train  # noqa: E402
from repro_torch.core import variations as var  # noqa: E402
from repro_torch.kernels import clause_eval, imbue_infer  # noqa: E402
from repro_torch.serve.replica import ensemble_vote  # noqa: E402

CFG = tm.TMConfig(n_classes=3, clauses_per_class=4, n_features=20,
                  n_states=50)
B = 6
C2C = var.VariationConfig(d2d=True, c2c=True, csa_offset=False)
LAUNCH_COUNTERS = (clause_eval.tm_infer_planes, clause_eval.tm_infer_packed,
                   clause_eval.tm_infer, clause_eval.clause_eval_packed,
                   clause_eval.clause_eval, imbue_infer.imbue_infer_planes,
                   imbue_infer.imbue_infer_packed, imbue_infer.imbue_infer)


def _tree(spans):
    """``[(name, [children])]`` of ``(name, start, end)`` ranges nested by
    containment."""
    root, stack = [], []
    for name, s, e in sorted(spans, key=lambda sp: (sp[1], -sp[2])):
        while stack and stack[-1][0] <= s:
            stack.pop()
        node = (name, [])
        (stack[-1][1] if stack else root).append(node)
        stack.append((e, node[1]))
    return root


def _traced(fn, device="cpu"):
    """``(fn(), tree of the repro_torch spans fn opened, the trace's device
    event names)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    spans, device_names = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CPU:
            device_names.append(ev.name())
        elif ev.name().startswith("repro_torch."):
            spans.append((ev.name(), ev.start_ns(), ev.end_ns()))
    return out, _tree(spans), device_names


def _train_case(device="cpu"):
    g = torch.Generator(device=device).manual_seed(3)
    ta = tm.init_ta_state(g, CFG, device=device)
    x = (torch.rand((B, CFG.n_features), generator=g, device=device)
         < 0.4).to(torch.uint8)
    y = torch.randint(0, CFG.n_classes, (B,), generator=g, device=device)
    return ta, g, x, y


def _include(device="cpu"):
    g = torch.Generator(device=device).manual_seed(7)
    return torch.rand((CFG.n_clauses, CFG.n_literals), generator=g,
                      device=device) < 0.1


def _analog_state(device="cpu"):
    return api.ReplicaStackState.program(
        _include(device), torch.Generator(device=device).manual_seed(5), 2,
        CFG, C2C).pack_planes()


def _digital_state(device="cpu"):
    return api.DigitalState(include=_include(device), ta_state=None,
                            tm_cfg=CFG).pack()


def _rows(device="cpu"):
    g = torch.Generator(device=device).manual_seed(11)
    return (torch.rand((B, CFG.n_features), generator=g, device=device)
            < 0.5).to(torch.uint8)


def _score_call(state, gen, backend, device="cpu"):
    """One call as an offline scorer makes it: literals, class sums and
    the pooled vote."""
    sums = api.class_sums(state, tm.literals(_rows(device)), gen,
                          backend=backend)
    return ensemble_vote(sums if sums.ndim == 3 else sums[None], "sum")


def _launches():
    return [w.launches for w in LAUNCH_COUNTERS]


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    first, second = trace.span("repro_torch.a"), trace.span("repro_torch.b")
    assert first is second is trace._NULL
    with first as entered:
        assert entered is None
    _, tree, _ = _traced(lambda: None)
    assert tree == []


def test_span_under_a_profiler_is_a_range_of_its_name():
    def nested():
        assert trace.span("repro_torch.x") is not trace._NULL
        with trace.span("repro_torch.outer"):
            with trace.span("repro_torch.inner"):
                torch.ones(2).sum()
    _, tree, _ = _traced(nested)
    assert tree == [("repro_torch.outer", [("repro_torch.inner", [])])]


def test_train_step_batch_gives_the_documented_tree(monkeypatch):
    ta, g, x, y = _train_case()
    # Chunks of two examples: three chunks of the batch of six.
    monkeypatch.setattr(tm_train, "_CHUNK_CELLS", 2 * CFG.n_ta)
    want = tm_train.train_step_batch(ta, torch.Generator().manual_seed(9),
                                     x, y, CFG)
    g.manual_seed(9)
    got, tree, _ = _traced(lambda: tm_train.train_step_batch(ta, g, x, y,
                                                             CFG))
    assert torch.equal(got, want)          # the spans change no number
    chunk = [("repro_torch.tm_train.draw", []),
             ("repro_torch.tm_train.update", [])]
    assert tree == [("repro_torch.tm_train.step", [
        ("repro_torch.tm_train.clause_eval", [
            ("repro_torch.tm.literals", []),
            ("repro_torch.ops.pack_literals", [])]),
        ("repro_torch.tm_train.split", []),
        *chunk * 3,
        ("repro_torch.tm_train.clip", [])])]


@pytest.mark.parametrize("kind", ["digital", "analog"])
def test_scoring_call_gives_its_spans(kind):
    if kind == "digital":
        state, gen, backend = _digital_state(), None, "digital-cuda-packed"
        inner = [("repro_torch.api.select_backend", []),
                 ("repro_torch.ops.pack_literals", [])]
    else:
        state, gen = _analog_state(), torch.Generator().manual_seed(1)
        backend = "analog-cuda-packed2"
        inner = [("repro_torch.api.select_backend", []),
                 ("repro_torch.ops.pack_literals", []),
                 ("repro_torch.ops.c2c_deviation", [])]
    assert api.select_backend(state, generator=gen,
                              prefer=backend).fallback_reason is None
    want = _score_call(state, gen, backend)
    if gen is not None:
        gen.manual_seed(1)
    got, tree, _ = _traced(lambda: _score_call(state, gen, backend))
    assert torch.equal(got, want)
    # The host runs each kernel's plain version: no launch, no span.
    assert tree == [("repro_torch.tm.literals", []),
                    ("repro_torch.api.class_sums", inner),
                    ("repro_torch.serve.ensemble_vote", [])]


@pytest.mark.parametrize("traced", [False, True], ids=["off", "on"])
def test_launch_counters_read_as_before(monkeypatch, traced):
    """The host launches nothing, with the profiler on or off: the
    counters stay where they were and stay plain integers."""
    monkeypatch.setattr(tm_train, "_CHUNK_CELLS", 2 * CFG.n_ta)
    before = _launches()

    def work():
        ta, g, x, y = _train_case()
        tm_train.train_step_batch(ta, g, x, y, CFG)
        _score_call(_digital_state(), None, "digital-cuda-packed")
        _score_call(_analog_state(), torch.Generator().manual_seed(1),
                    "analog-cuda-packed2")
    if traced:
        _traced(work)
    else:
        work()
    assert _launches() == before
    assert all(isinstance(n, int) for n in before)


def test_profile_spans_breaks_a_tiny_window_down(tmp_path):
    """``benchmarks/profile_spans.py`` on a tiny training window on the
    host: one ``step`` a step, its parts inside it, and the pieces of the
    window adding up to it."""
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from benchmarks import profile_spans
    from imbue_bench.tests import tiny
    out = profile_spans.profile(tiny.make_root(tmp_path), "kmnist-train-b256",
                                5, 0.2, torch.device("cpu"))
    rows = out["spans"]
    assert out["units"] >= 1 and rows["repro_torch.tm_train.step"][
        "count"] == 1
    assert {"repro_torch.tm_train.split", "repro_torch.tm_train.draw",
            "repro_torch.tm_train.update", None} <= set(rows)
    step = "repro_torch.tm_train.step"
    assert rows[step]["incl_ms"] > max(rows[n]["incl_ms"] for n in rows
                                       if n not in (None, step))
    assert sum(r["own_ms"] for r in rows.values()) == pytest.approx(
        out["window_ms"])
    assert sum(r["idle_ms"] for r in rows.values()) == pytest.approx(
        out["window_ms"] - out["busy_ms"])


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_stay_off_the_device_timeline(cuda):
    """A traced training step and a traced analog and digital call on the
    card: each kernel launch sits in its own ``repro_torch.kernels.*``
    span, every wrapper counts its launches as before, and no
    ``repro_torch.*`` name is among the device events (a user-scope range
    would be mirrored there as an annotation)."""
    ta, g, x, y = _train_case(cuda)
    analog = _analog_state(cuda)
    digital = _digital_state(cuda)
    read = torch.Generator(device=cuda).manual_seed(1)

    def work():
        tm_train.train_step_batch(ta, g, x, y, CFG)
        _score_call(digital, None, "digital-cuda-packed", cuda)
        _score_call(analog, read, "analog-cuda-packed2", cuda)
    work()                                  # builds the kernels
    before = {w.__name__: w.launches for w in LAUNCH_COUNTERS}
    _, tree, device_names = _traced(work, cuda)
    launched = {w.__name__: w.launches - before[w.__name__]
                for w in LAUNCH_COUNTERS}
    assert launched == {**dict.fromkeys(before, 0), "clause_eval_packed": 1,
                        "tm_infer_packed": 1, "imbue_infer_planes": 1}
    assert device_names
    assert not [n for n in device_names if n.startswith("repro_torch.")]

    def names(nodes):
        for name, children in nodes:
            yield name
            yield from names(children)
    seen = list(names(tree))
    for kernel in ("clause_eval_packed", "tm_infer_packed",
                   "imbue_infer_planes"):
        assert seen.count(f"repro_torch.kernels.{kernel}") == 1
    assert "repro_torch.kernels.build" not in seen
