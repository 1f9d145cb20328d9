"""Port parity for the packed and dense analog tiers: ``CrossbarState``,
the ``imbue_infer_packed`` / ``imbue_infer`` plain versions behind
``repro_torch.kernels.ops``, the ``analog-cuda`` / ``analog-cuda-packed``
backends, ``api.predict`` and the engine's backend ladder, against
``repro`` run as its own tests run it on the CPU (Pallas in interpret
mode).

Inputs are drawn with numpy from a seed: TA actions, Boolean requests
and D2D-like resistances (a lognormal HRS and a normal LRS draw, clipped
to the published ranges), handed to both packages as the same arrays.
Shapes are ragged: F = 23 gives L = 46 literals (two words, the second
with 18 padding bits), C = 3 classes x 6 clauses with one empty clause,
B = 11 rows, R = 3 chips.  Integer class sums must be equal exactly
(tolerance 0): the sensing margin is orders of magnitude above float32
rounding, so a flip is an op-order or constant bug.

It also holds the port-side registry-coverage meta-test: every
registered backend has a row in the backend x state parity matrix.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.core import coalesced as ref_co  # noqa: E402
from repro.core import imbue as ref_imbue  # noqa: E402
from repro.core import tm as ref_tm  # noqa: E402
from repro.core import variations as ref_var  # noqa: E402
from repro.kernels import bitpack as ref_bitpack  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.serve import batching as ref_batching  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.serve import replica as ref_replica  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.convert import (crossbar_state_from_numpy,  # noqa: E402
                                 pool_from_numpy)
from repro_torch.core import coalesced as co  # noqa: E402
from repro_torch.core import imbue, tm  # noqa: E402
from repro_torch.core import variations as var  # noqa: E402
from repro_torch.kernels import bitpack, imbue_infer, ops  # noqa: E402
from repro_torch.serve import batching, engine  # noqa: E402

CFG = tm.TMConfig(n_classes=3, clauses_per_class=6, n_features=23,
                  n_states=100)
REF_CFG = ref_tm.TMConfig(n_classes=3, clauses_per_class=6, n_features=23,
                          n_states=100)
ICFG, REF_ICFG = imbue.IMBUEConfig(), ref_imbue.IMBUEConfig()
D2D = var.VariationConfig(d2d=True, c2c=False, csa_offset=False)
REF_D2D = ref_var.VariationConfig(d2d=True, c2c=False, csa_offset=False)
R, B = 3, 11
L = CFG.n_literals


def _case(seed, n_replicas=R, b=B):
    """Include plane (clause 4 empty), requests, their literals and
    numpy-drawn resistances ``[n_replicas, C, L]``."""
    rng = np.random.default_rng(seed)
    inc = rng.random((CFG.n_clauses, L)) < 0.06
    inc[4] = False
    x = (rng.random((b, CFG.n_features)) < 0.5).astype(np.uint8)
    lits = np.concatenate([x, 1 - x], axis=1)
    shape = (n_replicas, *inc.shape)
    hrs = var.HRS_MEAN_OHM * np.exp(0.26 * rng.standard_normal(shape))
    lrs = var.LRS_MEAN_OHM + 20.0 * rng.standard_normal(shape)
    r = np.where(inc, np.clip(lrs, var.LRS_MIN_OHM, var.LRS_MAX_OHM),
                 np.clip(hrs, var.HRS_MIN_OHM, var.HRS_MAX_OHM))
    return inc, x, lits, r.astype(np.float32)


def _ref_sums(out) -> np.ndarray:
    return np.asarray(out).round().astype(np.int32)


def _nonzero(sums) -> bool:
    return np.count_nonzero(sums) > np.size(sums) // 4


# ------------------------------------------------------------ core model

def test_conductances_match_reference_bitwise():
    inc, _, _, r = _case(1)
    g, leak = imbue.conductances(torch.from_numpy(r), torch.from_numpy(inc),
                                 ICFG)
    rg, rleak = ref_imbue.conductances(jnp.asarray(r), jnp.asarray(inc),
                                       REF_ICFG)
    np.testing.assert_array_equal(g.numpy(), np.asarray(rg))
    np.testing.assert_array_equal(leak.numpy(), np.asarray(rleak))


def test_programmed_crossbar_functions_match_reference():
    inc, x, lits, r = _case(2, n_replicas=1)
    xbar = imbue.ProgrammedCrossbar(
        r_mem=torch.from_numpy(r[0]), include=torch.from_numpy(inc),
        mapping=imbue.CrossbarMapping(CFG.n_clauses, L), cfg=ICFG)
    ref_xbar = ref_imbue.ProgrammedCrossbar(
        r_mem=jnp.asarray(r[0]), include=jnp.asarray(inc),
        mapping=ref_imbue.CrossbarMapping(CFG.n_clauses, L), cfg=REF_ICFG)
    # Column currents are float32 sums of 32 cells taken in another order
    # than XLA's (a few ulp apart); everything thresholded is exact.
    np.testing.assert_allclose(
        imbue.column_currents(xbar, torch.from_numpy(lits)).numpy(),
        np.asarray(ref_imbue.column_currents(ref_xbar, jnp.asarray(lits))),
        rtol=1e-6, atol=0)
    got = imbue.analog_forward(xbar, torch.from_numpy(x), CFG)
    want = ref_imbue.analog_forward(ref_xbar, jnp.asarray(x), REF_CFG)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _nonzero(got.numpy())
    np.testing.assert_array_equal(
        imbue.analog_predict(xbar, torch.from_numpy(x), CFG).numpy(),
        np.asarray(ref_imbue.analog_predict(ref_xbar, jnp.asarray(x),
                                            REF_CFG)))
    sums = ops.imbue_class_sums(torch.from_numpy(lits), xbar, CFG,
                                device="cpu")
    np.testing.assert_array_equal(
        sums.numpy(), _ref_sums(ref_ops.imbue_class_sums(
            jnp.asarray(lits), ref_xbar, REF_CFG)))


def test_program_crossbar_and_state_program():
    inc = torch.from_numpy(_case(3)[0])
    nominal = var.VariationConfig.nominal()
    xbar = imbue.program_crossbar(inc, None, nominal)
    want = torch.where(inc, var.LRS_MEAN_OHM, var.HRS_MEAN_OHM).float()
    assert torch.equal(xbar.r_mem, want)
    assert xbar.mapping.columns_per_clause == 2
    st = api.CrossbarState.from_crossbar(xbar, CFG, nominal)
    assert torch.equal(st.r_mem, want) and st.icfg == ICFG
    assert st.mapping == xbar.mapping and st.device.type == "cpu"
    a = api.CrossbarState.program(inc, torch.Generator().manual_seed(5),
                                  CFG, D2D)
    b = api.CrossbarState.program(inc, torch.Generator().manual_seed(5),
                                  CFG, D2D)
    assert torch.equal(a.r_mem, b.r_mem) and not torch.equal(a.r_mem, want)
    stack = api.ReplicaStackState.program(
        inc, torch.Generator().manual_seed(5), R, CFG, D2D)
    assert stack.n_replicas == R
    pool = imbue.program_replica_stack(inc, torch.Generator().manual_seed(5),
                                       R, D2D)
    assert torch.equal(stack.r_stack, pool)
    one = stack.replica(1)
    assert isinstance(one, api.CrossbarState)
    assert torch.equal(one.r_mem, stack.r_stack[1])


def test_crossbar_pack_planes_matches_reference():
    inc, _, _, r = _case(4, n_replicas=1)
    st = crossbar_state_from_numpy(r[0], inc, CFG, vcfg=D2D,
                                   device="cpu").pack_planes()
    ref = ref_api.CrossbarState(r_mem=jnp.asarray(r[0]),
                                include=jnp.asarray(inc), tm_cfg=REF_CFG,
                                vcfg=REF_D2D).pack_planes()
    assert st.plane_packed and st.plane_index is st.include_packed
    np.testing.assert_array_equal(st.r_mem.numpy(), np.asarray(ref.r_mem))
    np.testing.assert_array_equal(st.plane_dev.numpy(),
                                  np.asarray(ref.plane_dev))
    np.testing.assert_array_equal(bitpack.words_to_numpy(st.plane_index),
                                  np.asarray(ref.plane_index))
    assert st.pack_planes() is st


# ------------------------------------------------------------------- ops

@pytest.mark.parametrize("packed", (False, True), ids=("raw", "raw_packed"))
def test_raw_ops_match_reference(packed):
    inc, _, lits, r = _case(5, n_replicas=1)
    g, leak = imbue.conductances(torch.from_numpy(r[0]),
                                 torch.from_numpy(inc), ICFG)
    args = (g, leak, torch.from_numpy(inc), ICFG.v_read, ICFG.r_divider,
            ICFG.reference_voltage(), CFG)
    ref_args = (jnp.asarray(g.numpy()), jnp.asarray(leak.numpy()),
                jnp.asarray(inc), REF_ICFG.v_read, REF_ICFG.r_divider,
                REF_ICFG.reference_voltage(), REF_CFG)
    if packed:
        litw = ref_bitpack.pack_bits_np(lits)
        got = ops.imbue_class_sums_raw_packed(bitpack.words_to_torch(litw),
                                              *args, device="cpu")
        want = ref_ops.imbue_class_sums_raw_packed(jnp.asarray(litw),
                                                   *ref_args)
    else:
        got = ops.imbue_class_sums_raw(torch.from_numpy(lits), *args,
                                       device="cpu")
        want = ref_ops.imbue_class_sums_raw(jnp.asarray(lits), *ref_args)
    assert got.dtype == torch.int32 and got.shape == (B, CFG.n_classes)
    np.testing.assert_array_equal(got.numpy(), _ref_sums(want))
    assert _nonzero(got.numpy())


@pytest.mark.parametrize("packed", (False, True),
                         ids=("stack", "stack_packed"))
def test_stack_ops_match_reference(packed):
    inc, _, lits, r = _case(6)
    # D2D alone moves no clause across the sensing margin, so chip 2 gets
    # leaky exclude cells (20 kOhm): its fuller columns read as violated.
    r[2] = np.where(inc, r[2], np.float32(20e3))
    if packed:
        litw = ref_bitpack.pack_bits_np(lits)
        got = ops.imbue_class_sums_stack_packed(
            bitpack.words_to_torch(litw), torch.from_numpy(r),
            torch.from_numpy(inc), ICFG, CFG, device="cpu")
        want = ref_ops.imbue_class_sums_stack_packed(
            jnp.asarray(litw), jnp.asarray(r), jnp.asarray(inc), REF_ICFG,
            REF_CFG)
    else:
        got = ops.imbue_class_sums_stack(
            torch.from_numpy(lits), torch.from_numpy(r),
            torch.from_numpy(inc), ICFG, CFG, device="cpu")
        want = ref_ops.imbue_class_sums_stack(
            jnp.asarray(lits), jnp.asarray(r), jnp.asarray(inc), REF_ICFG,
            REF_CFG)
    assert got.shape == (R, B, CFG.n_classes)
    np.testing.assert_array_equal(got.numpy(), _ref_sums(want))
    assert _nonzero(got.numpy())
    assert torch.equal(got[0], got[1]) and not torch.equal(got[0], got[2])


def test_stack_c2c_read_draws_fresh_noise_per_chip():
    inc, _, lits, r = _case(7)
    vcfg = var.VariationConfig(csa_offset=False, c2c_hrs_frac=0.4,
                               c2c_lrs_frac=0.4)
    args = (torch.from_numpy(lits), torch.from_numpy(r[[0, 0, 0]]),
            torch.from_numpy(inc), ICFG, CFG)
    a = ops.imbue_class_sums_stack(*args, torch.Generator().manual_seed(1),
                                   vcfg=vcfg, device="cpu")
    b = ops.imbue_class_sums_stack(*args, torch.Generator().manual_seed(1),
                                   vcfg=vcfg, device="cpu")
    quiet = ops.imbue_class_sums_stack(*args, device="cpu")
    assert torch.equal(a, b)                       # same generator, same
    assert torch.equal(quiet[0], quiet[1])         # three identical chips
    assert not (torch.equal(a[0], a[1]) and torch.equal(a[1], a[2]))


def test_cpu_wrappers_use_plain_versions_and_validate():
    inc, _, lits, r = _case(8)
    g, leak = imbue.conductances(torch.from_numpy(r), torch.from_numpy(inc),
                                 ICFG)
    pol = ops.polarity_matrix(CFG, torch.from_numpy(inc))
    i_ref = ICFG.reference_voltage() / ICFG.r_divider
    t_lits = torch.from_numpy(lits)
    litw = bitpack.pack_bits(t_lits)
    before = (imbue_infer.imbue_infer.launches,
              imbue_infer.imbue_infer_packed.launches)
    dense = imbue_infer.imbue_infer(t_lits, g, leak, pol, i_ref, ICFG.v_read)
    packed = imbue_infer.imbue_infer_packed(litw, g, leak, pol, i_ref,
                                            ICFG.v_read)
    assert (imbue_infer.imbue_infer.launches,
            imbue_infer.imbue_infer_packed.launches) == before  # no launch
    assert torch.equal(dense, packed) and dense.shape == (R, B,
                                                          CFG.n_classes)
    with pytest.raises(ValueError, match="literals"):
        imbue_infer.imbue_infer(litw, g, leak, pol, i_ref, ICFG.v_read)
    with pytest.raises(ValueError, match="literals"):
        imbue_infer.imbue_infer_packed(t_lits, g, leak, pol, i_ref,
                                       ICFG.v_read)
    with pytest.raises(ValueError, match="leak"):
        imbue_infer.imbue_infer(t_lits, g, leak[:, :-1], pol, i_ref,
                                ICFG.v_read)
    with pytest.raises(ValueError, match="g must be"):
        imbue_infer.imbue_infer(t_lits, g.double(), leak, pol, i_ref,
                                ICFG.v_read)
    with pytest.raises(ValueError, match="pol"):
        imbue_infer.imbue_infer(t_lits, g, leak, pol[:-1], i_ref,
                                ICFG.v_read)
    with pytest.raises(ValueError, match="contiguous"):
        imbue_infer.imbue_infer(t_lits, g.transpose(1, 2).contiguous()
                                .transpose(1, 2), leak, pol, i_ref,
                                ICFG.v_read)
    with pytest.raises(ValueError, match="width"):
        ops.imbue_class_sums_stack(
            t_lits, torch.from_numpy(r), torch.from_numpy(inc),
            imbue.IMBUEConfig(width=16), CFG, device="cpu")


# --------------------------------------- backend x state parity matrix

def _states(inc, r, ta, w, ccfg, ref_ccfg):
    """Port and reference states of every kind, from the same arrays."""
    t_inc, j_inc = torch.from_numpy(inc), jnp.asarray(inc)
    port = {
        "digital": api.DigitalState(include=t_inc, ta_state=None,
                                    tm_cfg=CFG),
        "crossbar": crossbar_state_from_numpy(r[0], inc, CFG, vcfg=D2D,
                                              device="cpu"),
        "stack": api.ReplicaStackState(r_stack=torch.from_numpy(r),
                                       include=t_inc, tm_cfg=CFG, vcfg=D2D),
        "coalesced": api.CoalescedState(ta_state=torch.from_numpy(ta),
                                        weights=torch.from_numpy(w),
                                        cfg=ccfg),
    }
    ref = {
        "digital": ref_api.DigitalState(include=j_inc, ta_state=None,
                                        tm_cfg=REF_CFG),
        "crossbar": ref_api.CrossbarState(r_mem=jnp.asarray(r[0]),
                                          include=j_inc, tm_cfg=REF_CFG,
                                          vcfg=REF_D2D),
        "stack": ref_api.ReplicaStackState(r_stack=jnp.asarray(r),
                                           include=j_inc, tm_cfg=REF_CFG,
                                           vcfg=REF_D2D),
        "coalesced": ref_api.CoalescedState(ta_state=jnp.asarray(ta),
                                            weights=jnp.asarray(w),
                                            cfg=ref_ccfg),
    }
    return port, ref


def _fmt(state, fmt):
    if fmt == "planes":
        return state.pack_planes()
    return state.pack() if fmt == "packed" else state


# (port backend, state kind, wire format the backend's predicate needs)
PARITY_ROWS = [
    ("digital-torch", "digital", "dense"),
    ("digital-cuda", "digital", "dense"),
    ("digital-cuda-packed", "digital", "packed"),
    ("coalesced", "coalesced", "dense"),
    ("coalesced-cuda", "coalesced", "dense"),
    ("coalesced-cuda-packed", "coalesced", "packed"),
    ("coalesced-cuda-packed2", "coalesced", "planes"),
] + [(name, kind, fmt)
     for name, fmt in (("analog-torch", "dense"), ("analog-cuda", "dense"),
                       ("analog-cuda-packed", "packed"),
                       ("analog-cuda-packed2", "planes"))
     for kind in ("crossbar", "stack")]
KIND_TYPES = {"digital": api.DigitalState, "crossbar": api.CrossbarState,
              "stack": api.ReplicaStackState,
              "coalesced": api.CoalescedState}


def _ref_name(name: str) -> str:
    return name.replace("-torch", "-jnp").replace("-cuda", "-pallas")


@pytest.mark.parametrize("name,kind,fmt", PARITY_ROWS,
                         ids=[f"{n}-{k}" for n, k, _ in PARITY_ROWS])
def test_backend_matches_reference_backend(name, kind, fmt):
    """Each port backend against the reference's backend of the same
    family on the same state, exactly."""
    inc, _, lits, r = _case(9)
    ccfg = co.CoalescedConfig(n_classes=3, n_clauses=CFG.n_clauses,
                              n_features=CFG.n_features, n_states=100)
    ref_ccfg = ref_co.CoalescedConfig(n_classes=3, n_clauses=CFG.n_clauses,
                                      n_features=CFG.n_features,
                                      n_states=100)
    rng = np.random.default_rng(9)
    ta = np.where(inc, 101, rng.integers(1, 101, inc.shape)).astype(np.int16)
    w = rng.integers(-20, 21, (CFG.n_clauses, 3)).astype(np.int32)
    port, ref = _states(inc, r, ta, w, ccfg, ref_ccfg)
    state, ref_state = _fmt(port[kind], fmt), _fmt(ref[kind], fmt)
    backend = api.get_backend(name)
    assert backend.accepts(state)
    got = backend.fn(state, torch.from_numpy(lits))
    want = ref_api.get_backend(_ref_name(name)).fn(ref_state,
                                                   jnp.asarray(lits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.count_nonzero(np.asarray(want)) > 0
    sel, ref_sel = api.select_backend(state), ref_api.select_backend(
        ref_state)
    assert sel.backend.name == ref_sel.backend.name.replace(
        "-pallas", "-cuda").replace("-jnp", "-torch")


def test_every_port_backend_has_a_parity_row():
    """The registry-coverage meta-test: every registered backend, on every
    state type it accepts, has a row above; no row names a stranger."""
    rows = {(n, KIND_TYPES[k]) for n, k, _ in PARITY_ROWS}
    registered = {(b.name, t) for b in api.list_backends()
                  for t in b.state_types}
    assert rows == registered
    assert len(api.list_backends()) == len(ref_api.list_backends()) == 11
    for b in api.list_backends():
        ref = ref_api.get_backend(_ref_name(b.name))
        assert b.capabilities == ref.capabilities - {"sharded_dispatch"}
        assert b.priority == ref.priority


def test_three_analog_kernel_tiers_agree_on_a_faulted_plane_packed_stack():
    """On one D2D + stuck-at plane-packed stack read without C2C, the
    dense, packed and plane-packed tiers and the eager model give the
    same integers (the port's form of the reference's dense == packed2
    property)."""
    inc, _, lits, r = _case(10)
    st = api.ReplicaStackState(r_stack=torch.from_numpy(r),
                               include=torch.from_numpy(inc), tm_cfg=CFG,
                               vcfg=D2D).pack_planes()
    st = st.inject_faults(torch.Generator().manual_seed(3),
                          var.FaultConfig(stuck_lrs_rate=0.02,
                                          stuck_hrs_rate=0.02))
    assert st.plane_dev is not None and st.fault_mask is not None
    t_lits = torch.from_numpy(lits)
    outs = {name: api.get_backend(name).fn(st, t_lits)
            for name in ("analog-torch", "analog-cuda", "analog-cuda-packed",
                         "analog-cuda-packed2")}
    for name, out in outs.items():
        assert torch.equal(out, outs["analog-cuda-packed2"]), name
    one = st.replica(2)
    for name in outs:
        assert torch.equal(api.get_backend(name).fn(one, t_lits),
                           outs[name][2]), name


def test_crossbar_selection_ladder_matches_reference():
    inc, _, _, r = _case(11, n_replicas=1)
    st = crossbar_state_from_numpy(r[0], inc, CFG, vcfg=D2D, device="cpu")
    ref = ref_api.CrossbarState(r_mem=jnp.asarray(r[0]),
                                include=jnp.asarray(inc), tm_cfg=REF_CFG,
                                vcfg=REF_D2D)
    for fmt in ("dense", "packed", "planes"):
        got = api.select_backend(_fmt(st, fmt)).backend.name
        want = ref_api.select_backend(_fmt(ref, fmt)).backend.name
        assert got == want.replace("-pallas", "-cuda")
    full = dataclasses.replace(st, vcfg=var.VariationConfig())
    sel = api.select_backend(full.pack_planes(),
                             generator=torch.Generator(),
                             prefer="analog-cuda")
    assert sel.fell_back and sel.backend.name == "analog-torch"
    assert "models_csa_offset" in sel.fallback_reason


@pytest.mark.parametrize("kind", ("crossbar", "stack"))
def test_predict_matches_reference(kind):
    inc, x, _, r = _case(12)
    if kind == "crossbar":
        st = crossbar_state_from_numpy(r[0], inc, CFG, vcfg=D2D,
                                       device="cpu")
        ref = ref_api.CrossbarState(r_mem=jnp.asarray(r[0]),
                                    include=jnp.asarray(inc),
                                    tm_cfg=REF_CFG, vcfg=REF_D2D)
    else:
        st = api.ReplicaStackState(r_stack=torch.from_numpy(r),
                                   include=torch.from_numpy(inc),
                                   tm_cfg=CFG, vcfg=D2D)
        ref = ref_api.ReplicaStackState(r_stack=jnp.asarray(r),
                                        include=jnp.asarray(inc),
                                        tm_cfg=REF_CFG, vcfg=REF_D2D)
    got = api.predict(st, torch.from_numpy(x), backend="analog-cuda")
    want = ref_api.predict(ref, jnp.asarray(x), backend="analog-pallas")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- engine

ECFGS = {"planes": {}, "packed": {"pack_planes": False},
         "dense": {"packed": False}}


def _engines(inc, r, ecfg_kw, routing, vname):
    """Reference and port engines over the same pool: ``r`` for a D2D
    pool, the class-nominal resistances for a nominal one."""
    vcfg, ref_vcfg = {"d2d": (D2D, REF_D2D),
                      "nominal": (var.VariationConfig.nominal(),
                                  ref_var.VariationConfig.nominal())}[vname]
    if vname == "nominal":
        r = np.broadcast_to(np.where(inc, np.float32(var.LRS_MEAN_OHM),
                                     np.float32(var.HRS_MEAN_OHM)), r.shape)
    ref_pool = ref_replica.ReplicaPool(r_stack=jnp.asarray(r),
                                       include=jnp.asarray(inc),
                                       icfg=REF_ICFG, vcfg=ref_vcfg)
    ref = ref_engine.ServeEngine(
        ref_pool, REF_CFG, ref_engine.EngineConfig(
            batcher=ref_batching.BatcherConfig(max_batch=8,
                                               bucket_sizes=(8,)),
            routing=routing, **ecfg_kw))
    port = engine.ServeEngine(
        pool_from_numpy(r, inc, ICFG, vcfg, device="cpu"), CFG,
        engine.EngineConfig(
            batcher=batching.BatcherConfig(max_batch=8, bucket_sizes=(8,)),
            routing=routing, **ecfg_kw), device="cpu")
    return ref, port


@pytest.mark.parametrize("tier", sorted(ECFGS))
def test_engine_ladder_matches_reference_engine(tier):
    """``EngineConfig()``, ``(pack_planes=False)`` and ``(packed=False)``
    select the reference engine's backend with ``pallas`` -> ``cuda``."""
    inc, _, _, r = _case(13)
    for vname in ("d2d", "nominal"):
        ref, port = _engines(inc, r, ECFGS[tier], "round_robin", vname)
        assert port.backend.name == ref.backend.name.replace("-pallas",
                                                             "-cuda")
        assert not port.selection.fell_back
        assert port.packed_io == ref.packed_io


@pytest.mark.parametrize("tier,routing,vname", [
    ("packed", "round_robin", "d2d"), ("packed", "ensemble", "nominal"),
    ("dense", "round_robin", "nominal"), ("dense", "ensemble", "d2d")])
def test_engine_tiers_match_reference_engine(tier, routing, vname):
    inc, x, _, r = _case(14, b=19)
    ref, port = _engines(inc, r, ECFGS[tier], routing, vname)
    kernel = {"packed": imbue_infer.imbue_infer_packed,
              "dense": imbue_infer.imbue_infer}[tier]
    before = kernel.launches
    ref.submit_many(list(x))
    port.submit_many(list(x))
    want, got = ref.drain(), port.drain()
    assert kernel.launches == before                  # CPU: plain versions
    assert [g.rid for g in got] == [w.rid for w in want]
    for g, w in zip(got, want):
        assert g.pred == w.pred and g.replica == w.replica
        np.testing.assert_array_equal(g.class_sums, w.class_sums)
    sums = np.stack([g.class_sums for g in got])
    assert _nonzero(sums)
    s, rs = port.summary(), ref.summary()
    for k in ("batches", "bytes_moved", "resident_bytes_moved",
              "fallback_dispatches", "replica_load_rows", "packed_io",
              "plane_packed"):
        assert s[k] == rs[k], k
    if vname == "nominal":
        ta = np.where(inc, CFG.n_states + 1, CFG.n_states).astype(np.int16)
        digital = tm.forward(torch.from_numpy(ta), torch.from_numpy(x),
                             CFG).numpy()
        factor = R if routing == "ensemble" else 1
        np.testing.assert_array_equal(sums, factor * digital)


def test_unpacked_engine_queues_bytes_and_packed_engine_queues_words():
    inc, x, _, r = _case(15, b=5)
    for tier, packed in (("dense", False), ("packed", True)):
        _, port = _engines(inc, r, ECFGS[tier], "round_robin", "d2d")
        assert port.batcher.packed is packed
        port.submit_many(list(x))
        assert len(port.drain()) == 5
        assert port.summary()["resident_nbytes_slice"] == 2 * 4 * inc.size
