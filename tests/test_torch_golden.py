"""The golden bar for the port: the committed class sums of
``tests/golden/backends_v3.json``, reproduced by every port backend.

The golden inputs (include mask, request batch) are recreated from the
reference's seeds with the legacy threefry generator,
``jax.threefry_partitionable(False)`` scoped to their draw (jax 0.9's
default, ``True``, draws other bits), and checked against the committed
digests first.  Then every registered port backend, on every golden state
it accepts, in each wire format it takes (0/1 literals, and 32-bit words
for the ``packed_io`` backends), must give the committed ``class_sums``
and ``preds`` exactly at nominal variation, and the port's coverage map
must be the committed ``backend_coverage`` with ``-pallas`` -> ``-cuda``
and ``-jnp`` -> ``-torch``.  The file is read, never written.
"""

import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import test_golden as ref_golden  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import tm  # noqa: E402
from repro_torch.core.coalesced import CoalescedConfig  # noqa: E402
from repro_torch.core.variations import VariationConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

NOMINAL = VariationConfig.nominal()


@pytest.fixture(scope="module")
def golden():
    with open(ref_golden.GOLDEN_PATH) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def inputs():
    """``(cfg, include [C, L] bool, ta [C, L], x [B, F] uint8)`` as numpy,
    drawn with the legacy threefry generator."""
    with jax.threefry_partitionable(False):
        _, inc, ta, x = ref_golden.golden_model()
        inc, ta, x = (np.array(a) for a in (inc, ta, x))
    return tm.TMConfig(**ref_golden.CFG), inc, ta, x


def port_name(ref_name: str) -> str:
    return ref_name.replace("-pallas", "-cuda").replace("-jnp", "-torch")


def golden_states(cfg, inc, ta):
    """The port's twin of ``test_golden.golden_states``: one same-model
    instance of every state type, packed and plane-packed."""
    inc_t = torch.from_numpy(inc)
    ta_t = torch.from_numpy(ta).to(cfg.state_dtype)
    gen = torch.Generator().manual_seed(ref_golden.SEED_PROGRAM)
    ccfg = CoalescedConfig(n_classes=cfg.n_classes, n_clauses=cfg.n_clauses,
                           n_features=cfg.n_features, n_states=cfg.n_states)
    states = {
        "digital": api.DigitalState.from_ta(ta_t, cfg),
        "crossbar": api.CrossbarState.program(inc_t, gen, cfg, NOMINAL),
        "stack": api.ReplicaStackState.program(inc_t, gen, 2, cfg, NOMINAL),
        "coalesced": api.CoalescedState(
            ta_state=ta_t, weights=ops.polarity_matrix(cfg, inc_t), cfg=ccfg),
    }
    for name in ("digital", "crossbar", "stack", "coalesced"):
        states[f"{name}_packed"] = states[name].pack()
    for name in ("crossbar", "stack", "coalesced"):
        states[f"{name}_planes"] = states[name].pack_planes()
    return states


def test_golden_inputs_reproduce_with_legacy_threefry(golden, inputs):
    """Attribution guard: the recreated include mask and batch hash to
    the committed digests."""
    cfg, inc, _, x = inputs
    assert golden["config"] == ref_golden.CFG
    assert ref_golden._sha(inc.astype(np.uint8)) == golden["include_sha256"]
    assert ref_golden._sha(x) == golden["batch_sha256"]


def test_digital_forward_matches_golden(golden, inputs):
    cfg, _, ta, x = inputs
    sums = tm.forward(torch.from_numpy(ta), torch.from_numpy(x), cfg).numpy()
    np.testing.assert_array_equal(sums, np.asarray(golden["class_sums"]))
    np.testing.assert_array_equal(sums.argmax(-1), np.asarray(golden["preds"]))


@pytest.mark.parametrize("backend", [b.name for b in api.list_backends()])
def test_every_port_backend_reproduces_golden(golden, inputs, backend):
    """Every state the backend accepts, in each wire format it takes."""
    cfg, inc, ta, x = inputs
    b = api.get_backend(backend)
    lits = tm.literals(torch.from_numpy(x))
    wires = ((lits, ops.pack_literals(lits))
             if api.CAP_PACKED_IO in b.capabilities else (lits,))
    want_sums = np.asarray(golden["class_sums"])
    checked = 0
    for name, state in golden_states(cfg, inc, ta).items():
        if not b.accepts(state):
            continue
        for wire in wires:
            got = b.fn(state, wire, None).numpy()
            for r, sums in enumerate(got if got.ndim == 3 else got[None]):
                what = f"{backend}/{name}/{wire.dtype}/chip {r}"
                np.testing.assert_array_equal(sums, want_sums, err_msg=what)
                np.testing.assert_array_equal(
                    sums.argmax(-1), np.asarray(golden["preds"]),
                    err_msg=what)
        checked += 1
    assert checked == len(golden["backend_coverage"][
        {port_name(k): k for k in golden["backend_coverage"]}[backend]])


def test_predict_entrypoint_matches_golden(golden, inputs):
    cfg, inc, ta, x = inputs
    states = golden_states(cfg, inc, ta)
    for name in ("digital", "crossbar", "stack", "coalesced",
                 "stack_packed", "coalesced_packed",
                 "stack_planes", "coalesced_planes"):
        got = api.predict(states[name], torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(golden["preds"]),
                                      err_msg=name)


def test_port_coverage_map_matches_golden(golden, inputs):
    """Each port backend accepts exactly the golden states its reference
    backend was recorded on, and no backend is missing or extra."""
    cfg, inc, ta, _ = inputs
    states = golden_states(cfg, inc, ta)
    got = {b.name: sorted(n for n, s in states.items() if b.accepts(s))
           for b in api.list_backends()}
    want = {port_name(k): v for k, v in golden["backend_coverage"].items()}
    assert got == want
