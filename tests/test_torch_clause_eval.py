"""Port parity for the digital / coalesced fused kernels: each plain
version, through its ``ops`` wrapper, against the reference's
``repro.kernels.ops`` (Pallas in interpret mode, as the reference's own
tests run it on the CPU), and the digital fused backends against
``digital-torch`` and the reference's ``digital-pallas-packed``.

Every sum is an integer, so the tolerance is 0 throughout.  Inputs are
drawn with numpy from a seed: ragged C, L and B, one empty clause, an
all-zero and an all-one literal row.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.core import tm as ref_tm  # noqa: E402
from repro.kernels import bitpack as ref_bitpack  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import tm  # noqa: E402
from repro_torch.kernels import bitpack, clause_eval, ops  # noqa: E402

# (B, C, L): ragged batch, clause and literal counts, small enough that
# the reference's interpret-mode Pallas calls stay cheap.
SHAPES = [(17, 37, 100), (9, 64, 160), (2, 5, 6)]
# Digital configs (M, J, F): C = M*J clauses, L = 2F literals.
DIGITAL = [(3, 14, 50), (4, 8, 37), (2, 2, 3)]


def _lits_include(b, c, l, seed):
    """0/1 literals ``[B, L]`` (row 0 all zero, row 1 all one, if B > 1)
    and an include plane ``[C, L]`` with 1-4 includes per clause, most of
    them taken from one literal row so that clauses fire; clause 1 is
    empty."""
    rng = np.random.default_rng(seed)
    lits = (rng.random((b, l)) < 0.5).astype(np.uint8)
    if b > 1:
        lits[0] = 0
        lits[1] = 1
    inc = np.zeros((c, l), bool)
    for ci in range(c):
        src = lits[rng.integers(0, b)]
        ones = np.flatnonzero(src) if src.any() else np.arange(l)
        k = int(rng.integers(1, 5))
        inc[ci, rng.choice(ones, size=min(k, ones.size), replace=False)] = True
    inc[min(1, c - 1)] = False
    return lits, inc


def _weights(c, m, seed):
    return np.random.default_rng(seed).integers(-127, 128, (c, m)).astype(
        np.int32)


def _words(bits):
    return ref_bitpack.pack_bits_np(bits)


def _t_words(bits):
    return bitpack.words_to_torch(_words(bits))


def _ref_sums(x):
    return np.asarray(x).round().astype(np.int64)


COALESCED_OPS = ("planes", "packed", "dense")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("which", COALESCED_OPS)
def test_coalesced_ops_match_reference(which, shape):
    b, c, l = shape
    m = 5
    lits, inc = _lits_include(b, c, l, seed=b + c + l)
    w = _weights(c, m, seed=c)
    got, want = _coalesced_pair(which, lits, inc, w)
    assert got.dtype == torch.int32 and got.shape == (b, m)
    np.testing.assert_array_equal(got.numpy(), _ref_sums(want))
    assert np.count_nonzero(got.numpy()) > 0              # not all zeros
    if b > 1:
        assert not got.numpy()[0].any()       # all-zero row: nothing fires
        np.testing.assert_array_equal(        # all-one row: all non-empty
            got.numpy()[1], (w * inc.any(-1)[:, None]).sum(0))


def _coalesced_pair(which, lits, inc, w):
    """``(port, reference)`` coalesced class sums of one op: the port's
    wrapper with the combine matrix built from ``w`` (as a
    ``CoalescedState`` builds it), the reference's from ``w`` itself."""
    comb = ops.coalesced_combine(torch.from_numpy(w),
                                 torch.from_numpy(inc).any(-1))
    if which == "dense":
        return (ops.tm_class_sums(torch.from_numpy(lits),
                                  torch.from_numpy(inc), comb, device="cpu"),
                ref_ops.coalesced_class_sums(
                    jnp.asarray(lits), jnp.asarray(inc), jnp.asarray(w)))
    fn = {"planes": (ops.tm_class_sums_planes,
                     ref_ops.coalesced_class_sums_planes),
          "packed": (ops.tm_class_sums_packed,
                     ref_ops.coalesced_class_sums_packed)}[which]
    return (fn[0](_t_words(lits), _t_words(inc), comb, device="cpu"),
            fn[1](jnp.asarray(_words(lits)), jnp.asarray(_words(inc)),
                  jnp.asarray(w)))


@pytest.mark.parametrize("case", ("one_class", "all_empty", "all_fire"))
@pytest.mark.parametrize("which", COALESCED_OPS)
def test_coalesced_ops_match_reference_at_edges(which, case):
    """One class (M = 1); every clause empty (none votes: the combine
    rows of empty clauses are zeroed); every clause including x_0 alone
    with x_0 = 1 on every row (every clause votes for every row)."""
    b, c, l = 9, 37, 100
    lits, inc = _lits_include(b, c, l, seed=b + c)
    m = 1 if case == "one_class" else 5
    w = _weights(c, m, seed=c + m)
    if case == "all_empty":
        inc[:] = False
    elif case == "all_fire":
        lits[:, 0] = 1
        inc[:] = False
        inc[:, 0] = True
    got, want = _coalesced_pair(which, lits, inc, w)
    assert got.dtype == torch.int32 and got.shape == (b, m)
    np.testing.assert_array_equal(got.numpy(), _ref_sums(want))
    if case == "all_empty":
        assert not got.numpy().any()
    elif case == "all_fire":
        np.testing.assert_array_equal(got.numpy(),
                                      np.broadcast_to(w.sum(0), (b, m)))
    else:
        assert np.count_nonzero(got.numpy()) > 0


@pytest.mark.parametrize("mjf", DIGITAL)
@pytest.mark.parametrize("packed", (False, True))
def test_digital_ops_match_reference(mjf, packed):
    m, j, f = mjf
    cfg = tm.TMConfig(n_classes=m, clauses_per_class=j, n_features=f)
    ref_cfg = ref_tm.TMConfig(n_classes=m, clauses_per_class=j,
                              n_features=f)
    b = 11
    lits, inc = _lits_include(b, cfg.n_clauses, cfg.n_literals, seed=m * j)
    pol = ops.polarity_matrix(cfg, torch.from_numpy(inc))
    if packed:
        got = ops.tm_class_sums_packed(_t_words(lits), _t_words(inc), pol,
                                       device="cpu")
        want = ref_ops.tm_class_sums_packed(
            jnp.asarray(_words(lits)), jnp.asarray(_words(inc)), ref_cfg)
    else:
        got = ops.tm_class_sums(torch.from_numpy(lits),
                                torch.from_numpy(inc), pol, device="cpu")
        want = ref_ops.tm_class_sums(jnp.asarray(lits), jnp.asarray(inc),
                                     ref_cfg)
    np.testing.assert_array_equal(got.numpy(), _ref_sums(want))
    # The all-one row fires every non-empty clause: +1 - 1 per pair.
    fired_one = got.numpy()[1]
    assert np.abs(fired_one).max() <= j // 2


def test_coalesced_combine_matches_reference():
    lits, inc = _lits_include(5, 37, 100, seed=3)
    w = _weights(37, 6, seed=4)
    got = ops.coalesced_combine(torch.from_numpy(w),
                                torch.from_numpy(inc.any(-1)))
    want = np.asarray(ref_ops.coalesced_combine(jnp.asarray(w),
                                                jnp.asarray(inc.any(-1))))
    assert got.dtype == torch.int32 and got.shape == (37, 6)
    np.testing.assert_array_equal(got.numpy(), want[:, :6])
    assert not want[:, 6:].any() and not got[1].any()   # the empty clause


@pytest.mark.parametrize("mjf", DIGITAL[:2])
@pytest.mark.parametrize("backend", ("digital-cuda", "digital-cuda-packed"))
def test_digital_fused_backends_match_digital_torch_and_reference(
        mjf, backend):
    m, j, f = mjf
    cfg = tm.TMConfig(n_classes=m, clauses_per_class=j, n_features=f,
                      n_states=100)
    ref_cfg = ref_tm.TMConfig(n_classes=m, clauses_per_class=j,
                              n_features=f, n_states=100)
    rng = np.random.default_rng(m + j)
    _, inc = _lits_include(4, cfg.n_clauses, cfg.n_literals, seed=j)
    ta = np.where(inc, cfg.n_states + 1, cfg.n_states).astype(np.int16)
    x = (rng.random((13, f)) < 0.5).astype(np.uint8)
    state = api.DigitalState.from_ta(torch.from_numpy(ta), cfg)
    if backend.endswith("packed"):
        state = state.pack()
    lits = tm.literals(torch.from_numpy(x))
    sel = api.select_backend(state, prefer=backend)
    assert sel.backend.name == backend and not sel.fell_back
    got = api.class_sums(state, lits, backend=backend)
    want = api.class_sums(state, lits, backend="digital-torch")
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    ref_state = ref_api.DigitalState.from_ta(jnp.asarray(ta), ref_cfg).pack()
    ref = ref_api.class_sums(ref_state, ref_tm.literals(jnp.asarray(x)),
                             backend="digital-pallas-packed")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert np.count_nonzero(want.numpy()) > 0


def test_digital_selection_ladder():
    cfg = tm.TMConfig(n_classes=2, clauses_per_class=4, n_features=4)
    state = api.DigitalState.from_ta(
        torch.full((8, 8), cfg.n_states + 1, dtype=torch.int16), cfg)
    assert api.select_backend(state).backend.name == "digital-cuda"
    assert (api.select_backend(state.pack()).backend.name
            == "digital-cuda-packed")
    bad = api.select_backend(state, prefer="digital-cuda-packed")
    assert bad.fell_back and "does not accept" in bad.fallback_reason
    assert bad.backend.name == "digital-cuda"


def test_popcount_matches_numpy():
    rng = np.random.default_rng(9)
    words = rng.integers(0, 2 ** 32, 4000, dtype=np.uint64).astype(np.uint32)
    words[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    want = np.unpackbits(words.view(np.uint8)).reshape(-1, 32).sum(1)
    got = clause_eval._popcount(bitpack.words_to_torch(words))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ("tm_infer_planes", "tm_infer_packed",
                                  "tm_infer"))
def test_cpu_wrapper_uses_plain_version_and_validates(name):
    lits, inc = _lits_include(7, 37, 100, seed=11)
    comb = torch.from_numpy(_weights(37, 4, seed=12))
    wrapper = getattr(clause_eval, name)
    ref = getattr(clause_eval, f"{name}_ref")
    if name == "tm_infer":
        a, i = torch.from_numpy(lits), torch.from_numpy(inc)
        bad_dtype = a.to(torch.int32)
    else:
        a, i = _t_words(lits), _t_words(inc)
        bad_dtype = a.to(torch.int64)
    before = wrapper.launches
    out = wrapper(a, i, comb)
    assert wrapper.launches == before                  # CPU: no launch
    assert out.dtype == torch.int32 and out.shape == (7, 4)
    assert torch.equal(out, ref(a, i, comb))
    with pytest.raises(ValueError, match="literals"):
        wrapper(bad_dtype, i, comb)
    with pytest.raises(ValueError, match="include"):
        wrapper(a, i[:, :-1], comb)
    with pytest.raises(ValueError, match="comb"):
        wrapper(a, i, comb[:-1])
    with pytest.raises(ValueError, match="comb"):
        wrapper(a, i, comb.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(a, i, comb.t().contiguous().t())


def test_plain_versions_agree_on_one_input():
    """The packed and dense plain versions are two computations of one
    function."""
    lits, inc = _lits_include(17, 64, 160, seed=13)
    comb = torch.from_numpy(_weights(64, 7, seed=14))
    dense = clause_eval.tm_infer_ref(torch.from_numpy(lits),
                                     torch.from_numpy(inc), comb)
    packed = clause_eval.tm_infer_packed_ref(_t_words(lits), _t_words(inc),
                                             comb)
    assert torch.equal(dense, packed)
    assert clause_eval.tm_infer_planes_ref is clause_eval.tm_infer_packed_ref
