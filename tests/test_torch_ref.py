"""Port parity for the kernel oracles: ``repro_torch.kernels.ref``
against the reference's ``repro.kernels.ref`` on the same numpy inputs,
and each oracle against the port's plain kernel versions on the same
operands; ``paper_cells_check`` against the reference's.

The digital oracles (``clause_eval_ref``, ``class_sums_ref``,
``tm_infer_ref``) are integers in float32: exact.  The column currents
are float32 sums in another order: within rtol 1e-5.  The conductances
come from a nominal programmed crossbar, whose CSA margins are wide, so
the thresholded outputs (``imbue_clauses_ref``, ``imbue_infer_ref``) are
exact.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import imbue_tm as ref_configs  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402
from repro_torch.configs import imbue_tm  # noqa: E402
from repro_torch.core import imbue, tm  # noqa: E402
from repro_torch.core import variations as var  # noqa: E402
from repro_torch.kernels import bitpack, clause_eval, imbue_infer, ops, ref  # noqa: E402

# (B, M classes, J clauses a class, F features): L = 2F a multiple of 32.
SHAPES = [(17, 3, 6, 48), (8, 2, 10, 64), (1, 4, 4, 16)]


def _case(b, m, j, f, seed):
    """Numpy literals ``[B, L]``, an include plane ``[C, L]`` (~10 %, most
    includes taken from one literal row so clauses fire; clause 1 empty)
    and the polarity matrix with the empty rows zeroed."""
    rng = np.random.default_rng(seed)
    cfg = tm.TMConfig(n_classes=m, clauses_per_class=j, n_features=f)
    c, l = cfg.n_clauses, cfg.n_literals
    x = (rng.random((b, f)) < 0.5).astype(np.uint8)
    lits = np.concatenate([x, 1 - x], axis=1)
    inc = rng.random((c, l)) < 0.1
    for ci in range(0, c, 2):
        inc[ci] = (lits[rng.integers(0, b)] == 1) & (rng.random(l) < 0.2)
    inc[min(1, c - 1)] = False
    pol = ops.polarity_matrix(cfg, torch.from_numpy(inc)).numpy()
    return cfg, lits, inc, pol


def _nominal_planes(inc):
    """``g_on`` / ``i_leak`` ``[C, L]`` float32 of a nominal crossbar."""
    r = torch.where(torch.from_numpy(inc), var.LRS_MEAN_OHM,
                    var.HRS_MEAN_OHM).to(torch.float32)
    g, leak = imbue.conductances(r, torch.from_numpy(inc),
                                 imbue.IMBUEConfig())
    return g.numpy(), leak.numpy()


def _drive(lits, icfg):
    return ((1 - lits.astype(np.float32)) * np.float32(icfg.v_read)
            ).astype(np.float32)


def _both(name, *args):
    """``name`` of the port (torch) and of the reference (jnp) on the same
    numpy ``args``; both as numpy."""
    got = getattr(ref, name)(*[torch.from_numpy(a) if isinstance(
        a, np.ndarray) else a for a in args])
    want = getattr(ref_oracles, name)(*[jnp.asarray(a) if isinstance(
        a, np.ndarray) else a for a in args])
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_digital_oracles_equal_the_reference(shape):
    cfg, lits, inc, pol = _case(*shape, seed=sum(shape))
    lit0 = (1 - lits).astype(np.uint8)
    incu = inc.astype(np.uint8)
    got, want = _both("clause_eval_ref", lit0, incu)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size
    got_s, want_s = _both("class_sums_ref", got, pol)
    np.testing.assert_array_equal(got_s, want_s)
    got_t, want_t = _both("tm_infer_ref", lit0, incu, pol)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_t, got_s)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_analog_oracles_equal_the_reference(shape):
    cfg, lits, inc, pol = _case(*shape, seed=7 * sum(shape))
    icfg = imbue.IMBUEConfig()
    g, leak = _nominal_planes(inc)
    v = _drive(lits, icfg)
    lit1 = lits.astype(np.float32)
    got, want = _both("imbue_column_currents_ref", v, lit1, g, leak,
                      icfg.width)
    assert got.shape == (lits.shape[0], cfg.n_clauses,
                         cfg.n_literals // icfg.width)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    scal = (icfg.width, icfg.r_divider, icfg.reference_voltage())
    got_c, want_c = _both("imbue_clauses_ref", v, lit1, g, leak, *scal)
    np.testing.assert_array_equal(got_c, want_c)
    got_i, want_i = _both("imbue_infer_ref", v, lit1, g, leak, pol, *scal)
    np.testing.assert_array_equal(got_i, want_i)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_oracles_equal_the_plain_kernel_versions(shape):
    """The oracles take the reference's operands (complemented literals,
    drive voltages); the plain versions the kernels' (0/1 bytes or words,
    dense or plane-packed stacks): two ways to the same sums."""
    cfg, lits, inc, pol = _case(*shape, seed=11 * sum(shape))
    lits_t, inc_t = torch.from_numpy(lits), torch.from_numpy(inc)
    pol_t = torch.from_numpy(pol)
    lit0 = 1.0 - lits_t.to(torch.float32)
    bits = ref.clause_eval_ref(lit0, inc_t)
    np.testing.assert_array_equal(
        bits.to(torch.uint8).numpy(),
        clause_eval.clause_eval_ref(lits_t, inc_t).numpy())
    np.testing.assert_array_equal(
        ref.tm_infer_ref(lit0, inc_t, pol_t).numpy(),
        clause_eval.tm_infer_ref(lits_t, inc_t, pol_t).numpy())
    litw, incw = bitpack.pack_bits(lits_t), bitpack.pack_bits(inc_t)
    np.testing.assert_array_equal(
        ref.tm_infer_ref(lit0, inc_t, pol_t).numpy(),
        clause_eval.tm_infer_packed_ref(litw, incw, pol_t).numpy())

    icfg = imbue.IMBUEConfig()
    g, leak = (torch.from_numpy(a) for a in _nominal_planes(inc))
    want = ref.imbue_infer_ref(torch.from_numpy(_drive(lits, icfg)),
                               lits_t.to(torch.float32), g, leak, pol_t,
                               icfg.width, icfg.r_divider,
                               icfg.reference_voltage())
    assert want.abs().sum() > 0
    i_ref = icfg.reference_voltage() / icfg.r_divider
    dense = imbue_infer.imbue_infer_ref(lits_t, g[None], leak[None], pol_t,
                                        i_ref, icfg.v_read)
    packed = imbue_infer.imbue_infer_packed_ref(litw, g[None], leak[None],
                                                pol_t, i_ref, icfg.v_read)
    planes = imbue_infer.imbue_infer_planes_ref(
        litw, incw, None, pol_t, ops.plane_scalars(icfg, cfg.n_literals))
    for got in (dense, packed, planes):
        assert got.shape == (1, lits.shape[0], cfg.n_classes)
        np.testing.assert_array_equal(got[0].numpy(),
                                      want.to(torch.int32).numpy())


def test_paper_cells_check_equals_the_reference():
    got = imbue_tm.paper_cells_check()
    assert got == ref_configs.paper_cells_check()
    assert all(have == want for have, want in got.values())
