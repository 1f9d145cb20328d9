"""Port parity: the packed wire format (``repro_torch.kernels.bitpack``)
against ``repro.kernels.bitpack``.  Words must be bit-identical: the
port's int32 bit patterns viewed as uint32 equal the reference's words."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import bitpack as ref_bitpack  # noqa: E402
from repro.serve import batching as ref_batching  # noqa: E402
from repro_torch.kernels import bitpack  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import batching  # noqa: E402

LENGTHS = (1, 31, 32, 33, 74, 100)


def _bits(shape, seed):
    return (np.random.default_rng(seed).random(shape) < 0.5).astype(np.uint8)


@pytest.mark.parametrize("l", LENGTHS)
def test_pack_bits_matches_reference_words(l):
    bits = _bits((3, 5, l), seed=l)
    bits[0, 0, -1] = 1                   # exercise the top bit of a word
    got = bitpack.words_to_numpy(bitpack.pack_bits(torch.from_numpy(bits)))
    want_np = ref_bitpack.pack_bits_np(bits)
    want_jnp = np.asarray(ref_bitpack.pack_bits(jnp.asarray(bits)))
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want_np)
    np.testing.assert_array_equal(got, want_jnp)
    assert got.shape[-1] == bitpack.words_for(l) == ref_bitpack.words_for(l)


@pytest.mark.parametrize("l", LENGTHS)
def test_unpack_round_trip_at_ragged_length(l):
    bits = _bits((4, l), seed=100 + l)
    words = bitpack.pack_bits(torch.from_numpy(bits))
    assert words.dtype == torch.int32
    back = bitpack.unpack_bits(words, l)
    np.testing.assert_array_equal(back.numpy(), bits)
    # The host packer lands on the same words as the tensor packer.
    host = bitpack.words_to_torch(bitpack.pack_bits_np(bits))
    assert torch.equal(host, words)


@pytest.mark.parametrize("l", LENGTHS)
def test_pack_bits_np_is_the_reference_packer(l):
    bits = _bits((2, 3, l), seed=200 + l)
    np.testing.assert_array_equal(bitpack.pack_bits_np(bits),
                                  ref_bitpack.pack_bits_np(bits))


def test_bit_31_survives_the_int32_view():
    words = np.array([[0x80000000, 0xFFFFFFFF, 0x00000001]], np.uint32)
    t = bitpack.words_to_torch(words)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(bitpack.words_to_numpy(t), words)
    bits = bitpack.unpack_bits(t, 96).numpy()
    np.testing.assert_array_equal(
        bits, np.asarray(ref_bitpack.unpack_bits(jnp.asarray(words), 96)))
    assert bits[0, 31] == 1 and bits[0, :31].sum() == 0
    assert bits[0, 32:64].sum() == 32


@pytest.mark.parametrize("f", (1, 16, 37, 64))
def test_request_packer_and_pack_literals_match_reference(f):
    x = _bits((f,), seed=300 + f)
    got = batching.pack_request_np(x)
    np.testing.assert_array_equal(got, ref_batching.pack_request_np(x))
    lits = np.concatenate([x, 1 - x])[None]
    np.testing.assert_array_equal(
        bitpack.words_to_numpy(ops.pack_literals(torch.from_numpy(lits)))[0],
        got)
    assert batching.words_for(2 * f) == ref_batching.words_for(2 * f)
