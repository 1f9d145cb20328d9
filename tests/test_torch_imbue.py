"""Port parity: the analog crossbar model (``repro_torch.core.imbue``,
``variations``, ``mapping``) against ``repro.core.imbue``.

Programmed resistances are drawn once by the reference and carried
across with ``repro_torch.convert``; with no noise the port must then
give the same clause outputs exactly.  The port's own samplers are
checked by distribution (the two packages' RNGs differ by design).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.core import imbue as ref_imbue  # noqa: E402
from repro.core import mapping as ref_mapping  # noqa: E402
from repro.core import tm as ref_tm  # noqa: E402
from repro.core import variations as ref_var  # noqa: E402
from repro.serve import replica as ref_replica  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.convert import pool_from_numpy  # noqa: E402
from repro_torch.core import imbue, mapping, tm  # noqa: E402
from repro_torch.core import variations as var  # noqa: E402

CFG = tm.TMConfig(n_classes=4, clauses_per_class=8, n_features=37,
                  n_states=100)
REF_CFG = ref_tm.TMConfig(n_classes=4, clauses_per_class=8, n_features=37,
                          n_states=100)
R = 3
VCFGS = {
    "d2d": (var.VariationConfig(d2d=True, c2c=False, csa_offset=False),
            ref_var.VariationConfig(d2d=True, c2c=False, csa_offset=False)),
    "nominal": (var.VariationConfig.nominal(),
                ref_var.VariationConfig.nominal()),
}


def _include_and_lits(seed, b=16):
    rng = np.random.default_rng(seed)
    inc = rng.random((CFG.n_clauses, CFG.n_literals)) < 0.04
    inc[2] = False                                   # one empty clause
    x = (rng.random((b, CFG.n_features)) < 0.5).astype(np.uint8)
    lits = np.concatenate([x, 1 - x], axis=1)
    return inc, x, lits


def _ref_pool(inc, vname, seed=7):
    return ref_replica.program_replica_pool(
        jnp.asarray(inc), jax.random.PRNGKey(seed), R, VCFGS[vname][1])


@pytest.mark.parametrize("vname", sorted(VCFGS))
def test_noiseless_clause_outputs_match_reference(vname):
    inc, _, lits = _include_and_lits(seed=1)
    ref_pool = _ref_pool(inc, vname)
    r_stack = np.asarray(ref_pool.r_stack)
    pool = pool_from_numpy(r_stack, inc, vcfg=VCFGS[vname][0], device="cpu")
    m = mapping.CrossbarMapping(CFG.n_clauses, CFG.n_literals)
    ref_m = ref_mapping.CrossbarMapping(CFG.n_clauses, CFG.n_literals)
    icfg, ref_icfg = imbue.IMBUEConfig(), ref_imbue.IMBUEConfig()
    for i in range(R):
        got = imbue.analog_clause_outputs_raw(
            pool.r_stack[i], pool.include, torch.from_numpy(lits), m, icfg)
        want = ref_imbue.analog_clause_outputs_raw(
            jnp.asarray(r_stack[i]), jnp.asarray(inc), jnp.asarray(lits),
            ref_m, ref_icfg)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = imbue.stacked_clause_outputs(pool.r_stack, pool.include,
                                       torch.from_numpy(lits), CFG)
    want = ref_imbue.stacked_clause_outputs(
        jnp.asarray(r_stack), jnp.asarray(inc), jnp.asarray(lits), REF_CFG)
    assert got.shape == (R, lits.shape[0], CFG.n_clauses)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy().any()


@pytest.mark.parametrize("vname", sorted(VCFGS))
def test_analog_backend_matches_reference_and_digital(vname):
    inc, x, lits = _include_and_lits(seed=2)
    ref_pool = _ref_pool(inc, vname, seed=8)
    pool = pool_from_numpy(np.asarray(ref_pool.r_stack), inc,
                           vcfg=VCFGS[vname][0], device="cpu")
    state = pool.state(CFG)
    got = api.get_backend("analog-torch").fn(state, torch.from_numpy(lits))
    want = ref_api.get_backend("analog-jnp").fn(ref_pool.state(REF_CFG),
                                                jnp.asarray(lits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if vname == "nominal":
        ta = np.where(inc, CFG.n_states + 1, CFG.n_states)
        digital = tm.forward(torch.from_numpy(ta), torch.from_numpy(x), CFG)
        for r in range(R):
            np.testing.assert_array_equal(got[r].numpy(), digital.numpy())


def test_conductances_and_currents_match_reference_bitwise():
    inc, _, lits = _include_and_lits(seed=3, b=4)
    r = np.array(_ref_pool(inc, "d2d", seed=9).r_stack)[0]
    icfg, ref_icfg = imbue.IMBUEConfig(), ref_imbue.IMBUEConfig()
    g, leak = imbue.conductances(torch.from_numpy(r), torch.from_numpy(inc),
                                 icfg)
    rg, rleak = ref_imbue.conductances(jnp.asarray(r), jnp.asarray(inc),
                                       ref_icfg)
    np.testing.assert_array_equal(g.numpy(), np.asarray(rg))
    np.testing.assert_array_equal(leak.numpy(), np.asarray(rleak))
    m = mapping.CrossbarMapping(CFG.n_clauses, CFG.n_literals)
    cur = imbue.column_currents_raw(g, leak, torch.from_numpy(lits), m, icfg)
    rcur = ref_imbue.column_currents_raw(
        rg, rleak, jnp.asarray(lits),
        ref_mapping.CrossbarMapping(CFG.n_clauses, CFG.n_literals), ref_icfg)
    # Summation order differs between einsum implementations: currents
    # agree to float32 rounding (relative 1e-6), thresholds exactly.
    np.testing.assert_allclose(cur.numpy(), np.asarray(rcur), rtol=1e-6)
    assert icfg.reference_voltage() == ref_icfg.reference_voltage()
    assert icfg.sensing_margin() == ref_icfg.sensing_margin()
    assert m.columns_per_clause == 3 and m.padded_literals == 96
    assert (mapping.csa_count_packed(3_136_000)
            == ref_mapping.csa_count_packed(3_136_000) == 98_000)


def test_d2d_sampler_ranges_and_moments():
    gen = torch.Generator().manual_seed(0)
    inc = torch.zeros(200_000, dtype=torch.bool)
    inc[::2] = True
    r = var.sample_device_resistance(gen, inc, var.VariationConfig())
    assert r.dtype == torch.float32
    hrs, lrs = r[~inc], r[inc]
    assert hrs.min() >= var.HRS_MIN_OHM and hrs.max() <= var.HRS_MAX_OHM
    assert lrs.min() >= var.LRS_MIN_OHM and lrs.max() <= var.LRS_MAX_OHM
    # Lognormal HRS: the median sits at the mean parameter, right skew.
    assert abs(float(hrs.median()) / var.HRS_MEAN_OHM - 1) < 0.01
    assert float(hrs.mean()) > float(hrs.median())
    assert abs(float(lrs.mean()) - var.LRS_MEAN_OHM) < 1.0
    # Clipping is active at the published bounds.
    assert float(hrs.max()) == pytest.approx(var.HRS_MAX_OHM)
    nominal = var.sample_device_resistance(None, inc,
                                           var.VariationConfig(d2d=False))
    assert torch.equal(nominal, torch.where(
        inc, torch.tensor(var.LRS_MEAN_OHM), torch.tensor(var.HRS_MEAN_OHM)))


def test_c2c_excursion_range_sign_and_mean():
    gen = torch.Generator().manual_seed(1)
    inc = torch.zeros(100_000, dtype=torch.bool)
    inc[::4] = True
    r = torch.where(inc, var.LRS_MEAN_OHM, var.HRS_MEAN_OHM).float()
    out = var.apply_c2c(gen, r, inc, var.VariationConfig())
    rel = (out / r - 1).numpy()
    frac = np.where(inc.numpy(), var.C2C_LRS_FRAC, var.C2C_HRS_FRAC)
    assert (np.abs(rel) <= frac * (1 + 1e-5)).all()
    assert (rel > 0).any() and (rel < 0).any()
    for sel, f in ((inc.numpy(), var.C2C_LRS_FRAC),
                   (~inc.numpy(), var.C2C_HRS_FRAC)):
        assert abs(rel[sel].mean()) < 0.02 * f        # mean excursion ~ 0
        assert abs(rel[sel].std() - f / np.sqrt(3)) < 0.02 * f
    off = var.VariationConfig(c2c=False)
    assert var.apply_c2c(gen, r, inc, off) is r


def test_csa_offset_and_generator_split():
    gen = torch.Generator().manual_seed(2)
    off = var.csa_offset(gen, (50_000,), var.VariationConfig())
    assert abs(float(off.std()) / var.CSA_OFFSET_SIGMA_V - 1) < 0.03
    assert abs(float(off.mean())) < 0.05 * var.CSA_OFFSET_SIGMA_V
    zero = var.csa_offset(gen, (8,), var.VariationConfig(csa_offset=False))
    assert not zero.any()
    a = var.split_generator(torch.Generator().manual_seed(3), 2)
    b = var.split_generator(torch.Generator().manual_seed(3), 2)
    xa = [torch.rand(4, generator=g) for g in a]
    xb = [torch.rand(4, generator=g) for g in b]
    assert torch.equal(xa[0], xb[0]) and torch.equal(xa[1], xb[1])
    assert not torch.equal(xa[0], xa[1])


def test_noisy_read_uses_both_noise_streams():
    """A full-noise read flips some partial clauses relative to the
    noiseless read, and the same generator seed reproduces it."""
    inc, _, lits = _include_and_lits(seed=4, b=32)
    pool = pool_from_numpy(np.asarray(_ref_pool(inc, "d2d").r_stack), inc,
                           device="cpu")
    m = mapping.CrossbarMapping(CFG.n_clauses, CFG.n_literals)
    icfg = imbue.IMBUEConfig(v_ref=0.0068)     # near the leak band
    vcfg = var.VariationConfig(csa_sigma_v=2e-3)

    def read(seed):
        return imbue.analog_clause_outputs_raw(
            pool.r_stack, pool.include, torch.from_numpy(lits), m, icfg,
            torch.Generator().manual_seed(seed), vcfg)

    clean = imbue.analog_clause_outputs_raw(
        pool.r_stack, pool.include, torch.from_numpy(lits), m, icfg)
    assert torch.equal(read(5), read(5))
    assert not torch.equal(read(5), clean)
