"""Port parity: the plane-packed analog path — ``_deviation_plane``,
``pack_planes``, the ``imbue_infer_planes`` plain version behind
``repro_torch.kernels.ops.imbue_class_sums_(stack_)planes`` — against
``repro.kernels.ops`` run as the reference's own tests run it on the CPU
(Pallas in interpret mode).

Shapes are ragged on purpose: F = 37 gives L = 74 literals, so the last
of 3 words carries 22 padding bits; C = 4 classes x 8 clauses with one
empty clause; B = 13 rows; R = 3 replicas.  Class sums must be equal
exactly (tolerance 0): the sensing margin is orders of magnitude above
float32 rounding, so any flip is an op-order or constant bug.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import states as ref_states  # noqa: E402
from repro.core import imbue as ref_imbue  # noqa: E402
from repro.core import tm as ref_tm  # noqa: E402
from repro.core import variations as ref_var  # noqa: E402
from repro.kernels import bitpack as ref_bitpack  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.serve import replica as ref_replica  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import states  # noqa: E402
from repro_torch.convert import pool_from_numpy  # noqa: E402
from repro_torch.core import imbue, tm  # noqa: E402
from repro_torch.core import variations as var  # noqa: E402
from repro_torch.kernels import bitpack, imbue_infer, ops  # noqa: E402

CFG = tm.TMConfig(n_classes=4, clauses_per_class=8, n_features=37,
                  n_states=100)
REF_CFG = ref_tm.TMConfig(n_classes=4, clauses_per_class=8, n_features=37,
                          n_states=100)
ICFG, REF_ICFG = imbue.IMBUEConfig(), ref_imbue.IMBUEConfig()
R, B = 3, 13
L = CFG.n_literals
REF_VCFG = {
    "nominal": ref_var.VariationConfig.nominal(),
    "d2d": ref_var.VariationConfig(d2d=True, c2c=False, csa_offset=False),
}


def _case(seed):
    rng = np.random.default_rng(seed)
    inc = rng.random((CFG.n_clauses, L)) < 0.04
    inc[5] = False                                   # one empty clause
    x = (rng.random((B, CFG.n_features)) < 0.5).astype(np.uint8)
    lits = np.concatenate([x, 1 - x], axis=1)
    return inc, x, lits


def _ref_planes(inc, vname, seed=11):
    """The reference's plane-packed stack: (index words u32, dev or None)."""
    pool = ref_replica.program_replica_pool(
        jnp.asarray(inc), jax.random.PRNGKey(seed), R, REF_VCFG[vname])
    st = pool.state(REF_CFG).pack_planes()
    dev = None if st.plane_dev is None else np.array(st.plane_dev)
    return np.array(st.plane_index), dev, np.array(st.r_stack)


def _ref_stack_sums(lits, index_u32, dev):
    litw = ref_bitpack.pack_bits_np(lits)
    out = ref_ops.imbue_class_sums_stack_planes(
        jnp.asarray(litw), jnp.asarray(index_u32),
        None if dev is None else jnp.asarray(dev), REF_ICFG, REF_CFG, None,
        l_valid=L, n_replicas=R)
    return np.asarray(out).round().astype(np.int32)


def _port_stack_sums(lits, index_u32, dev):
    litw = bitpack.words_to_torch(bitpack.pack_bits_np(lits))
    return ops.imbue_class_sums_stack_planes(
        litw, bitpack.words_to_torch(index_u32),
        None if dev is None else torch.from_numpy(np.array(dev)), ICFG, CFG,
        l_valid=L, n_replicas=R, device="cpu")


@pytest.mark.parametrize("vname", sorted(REF_VCFG))
def test_deviation_plane_and_pack_planes_match_reference(vname):
    inc, _, _ = _case(seed=1)
    index_u32, ref_dev, ref_rq = _ref_planes(inc, vname)
    raw = ref_replica.program_replica_pool(
        jnp.asarray(inc), jax.random.PRNGKey(11), R, REF_VCFG[vname])
    r_raw = np.array(raw.r_stack)
    r_q, dev = states._deviation_plane(torch.from_numpy(r_raw),
                                       torch.from_numpy(inc))
    want_rq, want_dev = ref_states._deviation_plane(jnp.asarray(r_raw),
                                                    jnp.asarray(inc))
    np.testing.assert_array_equal(r_q.numpy(), np.asarray(want_rq))
    assert (dev is None) == (want_dev is None) == (vname == "nominal")
    if dev is not None:
        np.testing.assert_array_equal(dev.numpy(), np.asarray(want_dev))
        r_nom = np.where(inc, np.float32(var.LRS_MEAN_OHM),
                         np.float32(var.HRS_MEAN_OHM))
        # The quantization contract: r_q == r_nom + dev, bitwise.
        np.testing.assert_array_equal(r_q.numpy(), r_nom + dev.numpy())
    pool = pool_from_numpy(r_raw, inc, device="cpu")
    st = pool.state(CFG).pack_planes()
    assert st.plane_packed and st.packed
    assert st.plane_index is st.include_packed
    np.testing.assert_array_equal(bitpack.words_to_numpy(st.plane_index),
                                  index_u32)
    np.testing.assert_array_equal(st.r_stack.numpy(), ref_rq)
    assert st.pack_planes() is st
    sl = st.replica_slice(2)
    assert sl.n_replicas == 1
    if st.plane_dev is not None:
        np.testing.assert_array_equal(sl.plane_dev.numpy(), ref_dev[2:3])


@pytest.mark.parametrize("vname", sorted(REF_VCFG))
def test_stack_planes_match_reference(vname):
    inc, x, lits = _case(seed=2)
    index_u32, dev, _ = _ref_planes(inc, vname, seed=12)
    got = _port_stack_sums(lits, index_u32, dev)
    want = _ref_stack_sums(lits, index_u32, dev)
    assert got.dtype == torch.int32 and got.shape == (R, B, CFG.n_classes)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.count_nonzero(want) > want.size // 4     # not parity of zeros
    if vname == "nominal":
        # One result expanded over R, equal to the digital TM.
        assert got.stride(0) == 0
        ta = np.where(inc, CFG.n_states + 1, CFG.n_states)
        digital = tm.forward(torch.from_numpy(ta), torch.from_numpy(x), CFG)
        for r in range(R):
            np.testing.assert_array_equal(got[r].numpy(), digital.numpy())


def test_stack_planes_match_reference_after_c2c_perturbation():
    """C2C: perturb the deviation plane ONCE with the reference's
    ``apply_c2c``, then hand the same plane to both, noise-free."""
    inc, _, lits = _case(seed=3)
    index_u32, dev, _ = _ref_planes(inc, "d2d", seed=13)
    r_nom = jnp.where(jnp.asarray(inc), ref_var.LRS_MEAN_OHM,
                      ref_var.HRS_MEAN_OHM)
    noisy = ref_var.apply_c2c(jax.random.PRNGKey(5), r_nom + dev,
                              jnp.asarray(inc), ref_var.VariationConfig())
    dev_c2c = np.asarray(noisy - r_nom).astype(np.float32)
    assert not np.array_equal(dev_c2c, dev)
    np.testing.assert_array_equal(_port_stack_sums(lits, index_u32,
                                                   dev_c2c).numpy(),
                                  _ref_stack_sums(lits, index_u32, dev_c2c))


@pytest.mark.parametrize("vname", sorted(REF_VCFG))
def test_single_chip_planes_match_reference(vname):
    inc, _, lits = _case(seed=4)
    index_u32, dev, _ = _ref_planes(inc, vname, seed=14)
    litw = bitpack.pack_bits_np(lits)
    for r in range(R):
        d = None if dev is None else dev[r]
        got = ops.imbue_class_sums_planes(
            bitpack.words_to_torch(litw), bitpack.words_to_torch(index_u32),
            None if d is None else torch.from_numpy(np.array(d)), ICFG, CFG,
            l_valid=L, device="cpu")
        want = ref_ops.imbue_class_sums_planes(
            jnp.asarray(litw), jnp.asarray(index_u32),
            None if d is None else jnp.asarray(d), REF_ICFG, REF_CFG, None,
            l_valid=L)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).round())


def test_kernel_path_equals_eager_analog_model_off_nominal():
    """The packed2 backend and the eager ``analog-torch`` backend agree on
    one noise-free plane-packed state (the port's own dense==packed
    bar)."""
    inc, _, lits = _case(seed=5)
    _, _, r_q = _ref_planes(inc, "d2d", seed=15)
    pool = pool_from_numpy(r_q, inc, vcfg=var.VariationConfig(
        d2d=True, c2c=False, csa_offset=False), device="cpu")
    st = pool.state(CFG).pack_planes()
    t_lits = torch.from_numpy(lits)
    packed2 = api.get_backend("analog-cuda-packed2").fn(st, t_lits)
    eager = api.get_backend("analog-torch").fn(st, t_lits)
    np.testing.assert_array_equal(packed2.numpy(), eager.numpy())
    sel = api.select_backend(st)
    assert sel.backend.name == "analog-cuda-packed2" and not sel.fell_back


def test_c2c_read_draws_fresh_noise_per_read():
    inc, _, lits = _case(seed=6)
    index, dev, _ = _ref_planes(inc, "d2d", seed=16)
    index_t = bitpack.words_to_torch(index)
    vcfg = var.VariationConfig(csa_offset=False, c2c_hrs_frac=0.3)
    dev1 = ops.c2c_deviation(torch.Generator().manual_seed(1), index_t,
                             torch.from_numpy(dev), R, vcfg, L)
    dev1b = ops.c2c_deviation(torch.Generator().manual_seed(1), index_t,
                              torch.from_numpy(dev), R, vcfg, L)
    assert torch.equal(dev1, dev1b) and dev1.shape == (R, CFG.n_clauses, L)
    r_nom = torch.where(torch.from_numpy(inc), var.LRS_MEAN_OHM,
                        var.HRS_MEAN_OHM).float()
    base = r_nom + torch.from_numpy(dev)
    rel = ((r_nom + dev1) / base - 1).abs()
    assert float(rel.max()) <= 0.3 * (1 + 1e-4)
    assert not torch.equal(dev1[0], dev1[1])        # per-replica draws
    litw = bitpack.words_to_torch(bitpack.pack_bits_np(lits))
    noisy = ops.imbue_class_sums_stack_planes(
        litw, index_t, torch.from_numpy(dev), ICFG, CFG,
        torch.Generator().manual_seed(2), vcfg=vcfg, l_valid=L,
        n_replicas=R, device="cpu")
    assert noisy.shape == (R, B, CFG.n_classes) and noisy.stride(0) != 0


def test_cpu_wrapper_uses_plain_version_and_validates():
    inc, _, lits = _case(seed=7)
    index, dev, _ = _ref_planes(inc, "d2d", seed=17)
    litw = bitpack.words_to_torch(bitpack.pack_bits_np(lits))
    incw = bitpack.words_to_torch(index)
    dev_t = torch.from_numpy(dev)
    pol = ops.polarity_matrix(CFG, torch.from_numpy(inc))
    scal = ops.plane_scalars(ICFG, L)
    before = imbue_infer.imbue_infer_planes.launches
    out = imbue_infer.imbue_infer_planes(litw, incw, dev_t, pol, scal)
    assert imbue_infer.imbue_infer_planes.launches == before  # no launch
    assert torch.equal(out, imbue_infer.imbue_infer_planes_ref(
        litw, incw, dev_t, pol, scal))
    assert scal.i_ref == float(np.float32(REF_ICFG.reference_voltage()
                                          / REF_ICFG.r_divider))
    with pytest.raises(ValueError, match="litw"):
        imbue_infer.imbue_infer_planes(litw.long(), incw, dev_t, pol, scal)
    with pytest.raises(ValueError, match="dev"):
        imbue_infer.imbue_infer_planes(litw, incw, dev_t[:, :, :-1], pol,
                                       scal)
    with pytest.raises(ValueError, match="pol"):
        imbue_infer.imbue_infer_planes(litw, incw, dev_t, pol[:-1], scal)
    with pytest.raises(ValueError, match="l_valid"):
        imbue_infer.imbue_infer_planes(litw, incw, None, pol,
                                       ops.plane_scalars(ICFG, 200))
    with pytest.raises(ValueError, match="contiguous"):
        imbue_infer.imbue_infer_planes(litw, incw, dev_t.transpose(1, 2)
                                       .contiguous().transpose(1, 2), pol,
                                       scal)


def test_polarity_matrix_matches_reference():
    inc, _, _ = _case(seed=8)
    got = ops.polarity_matrix(CFG, torch.from_numpy(inc))
    want = np.asarray(ref_ops.polarity_matrix(REF_CFG, jnp.asarray(inc)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want[:, :CFG.n_classes])
    assert not want[:, CFG.n_classes:].any()
    assert not got[5].any()                       # the empty clause
