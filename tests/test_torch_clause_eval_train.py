"""Port parity for the training-time clause-evaluation kernels: the plain
versions, through ``ops.clause_eval`` / ``ops.clause_eval_packed``,
against the reference's ``repro.kernels.ops`` (Pallas in interpret mode,
as the reference's own tests run it on the CPU).

Clause bits are 0/1, so the tolerance is 0.  Inputs are drawn with numpy
from a seed: ragged C, L and B, empty clauses (which must fire: training
semantics), an all-zero and an all-one literal row, and a guard that
some but not all bits fire.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import tm as ref_tm  # noqa: E402
from repro.kernels import bitpack as ref_bitpack  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core import tm  # noqa: E402
from repro_torch.kernels import bitpack, clause_eval, ops  # noqa: E402

# (B, C, L): ragged batch, clause and literal counts, small enough that
# the reference's interpret-mode Pallas calls stay cheap.
SHAPES = [(13, 37, 74), (1, 64, 160), (9, 5, 6), (40, 101, 33)]


def _case(b, c, l, seed):
    """0/1 literals ``[B, L]`` and an include plane ``[C, L]`` with 1-4
    includes per clause, for two clauses in three taken from one literal
    row's ones (so clauses fire), for the third from any literal; clauses
    1 and C-1 are empty."""
    rng = np.random.default_rng(seed)
    lits = (rng.random((b, l)) < 0.5).astype(np.uint8)
    if b > 1:
        lits[0] = 0
        lits[1] = 1
    inc = np.zeros((c, l), bool)
    for ci in range(c):
        src = lits[rng.integers(0, b)]
        ones = (np.flatnonzero(src) if src.any() and ci % 3
                else np.arange(l))
        k = int(rng.integers(1, 5))
        inc[ci, rng.choice(ones, size=min(k, ones.size), replace=False)] = True
    inc[min(1, c - 1)] = False
    inc[c - 1] = False
    return lits, inc


def _reference(lits, inc, packed):
    if packed:
        return np.asarray(ref_ops.clause_eval_packed(
            jnp.asarray(ref_bitpack.pack_bits_np(lits)),
            jnp.asarray(ref_bitpack.pack_bits_np(inc)), interpret=True))
    return np.asarray(ref_ops.clause_eval(jnp.asarray(lits),
                                          jnp.asarray(inc), interpret=True))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("shape", SHAPES)
def test_clause_eval_ops_match_reference(shape, packed):
    b, c, l = shape
    lits, inc = _case(b, c, l, seed=b * c + l)
    want = _reference(lits, inc, packed)
    if packed:
        got = ops.clause_eval_packed(
            bitpack.words_to_torch(ref_bitpack.pack_bits_np(lits)),
            bitpack.words_to_torch(ref_bitpack.pack_bits_np(inc)),
            device="cpu")
    else:
        got = ops.clause_eval(torch.from_numpy(lits), torch.from_numpy(inc),
                              device="cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == (b, c)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))
    assert (got[:, c - 1] == 1).all()              # empty clauses fire
    share = float(got.float().mean())
    assert 0.0 < share < 1.0, share


@pytest.mark.parametrize("shape", SHAPES)
def test_clause_eval_equals_tm_training_semantics(shape):
    """Both ops equal the digital TM's ``clause_outputs(training=True)`` on
    a TA state, the function the training steps replace with them."""
    b, c, l = shape
    lits, inc = _case(b, c, l, seed=7 * b + c)
    n_states = 100
    state = torch.where(torch.from_numpy(inc), n_states + 1,
                        n_states).to(torch.int16)
    lt = torch.from_numpy(lits)
    want = tm.clause_outputs_from_include(torch.from_numpy(inc), lt,
                                          training=True)
    ref = np.asarray(ref_tm.clause_outputs_from_include(
        jnp.asarray(inc), jnp.asarray(lits), training=True))
    np.testing.assert_array_equal(want.numpy(), ref)
    dense = ops.clause_eval(lt, state > n_states, device="cpu")
    packed = ops.clause_eval_packed(
        ops.pack_literals(lt), ops.pack_include(state > n_states),
        device="cpu")
    assert torch.equal(dense, want) and torch.equal(packed, want)


def test_pack_include_matches_reference():
    _, inc = _case(5, 37, 70, seed=3)
    got = bitpack.words_to_numpy(ops.pack_include(torch.from_numpy(inc)))
    np.testing.assert_array_equal(
        got, np.asarray(ref_ops.pack_include(jnp.asarray(inc))))


def test_wrappers_check_operands_and_count_no_cpu_launch():
    lits = torch.zeros((3, 40), dtype=torch.uint8)
    inc = torch.zeros((5, 40), dtype=torch.bool)
    before = (clause_eval.clause_eval.launches,
              clause_eval.clause_eval_packed.launches)
    assert torch.equal(clause_eval.clause_eval(lits, inc),
                       torch.ones((3, 5), dtype=torch.uint8))
    litw = bitpack.pack_bits(lits)
    assert torch.equal(clause_eval.clause_eval_packed(
        litw, bitpack.pack_bits(inc)), torch.ones((3, 5), dtype=torch.uint8))
    assert (clause_eval.clause_eval.launches,
            clause_eval.clause_eval_packed.launches) == before
    with pytest.raises(ValueError, match="include must be"):
        clause_eval.clause_eval(lits, inc[:, :39])
    with pytest.raises(ValueError, match="literals must be"):
        clause_eval.clause_eval_packed(litw.to(torch.int64),
                                       bitpack.pack_bits(inc))
    with pytest.raises(ValueError, match="contiguous"):
        clause_eval.clause_eval(lits.T.contiguous().T, inc)
    # An empty batch gives an empty [0, C] answer.
    assert tuple(clause_eval.clause_eval(lits[:0], inc).shape) == (0, 5)
