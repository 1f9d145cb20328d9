"""The port's checkpoints (``repro_torch.distributed.checkpoint``): atomic
save, digest-verified restore onto a device, the typed corruption errors,
and byte compatibility with the reference's format in both directions
(a checkpoint written by either package restores in the other, with
equal content digests).  Leaves are compared exactly.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.distributed import checkpoint as ref_ckpt  # noqa: E402
from repro_torch.core import tm, tm_train  # noqa: E402
from repro_torch.distributed import checkpoint as ckpt  # noqa: E402

CFG = tm.TMConfig(n_classes=3, clauses_per_class=4, n_features=9)


def _tree():
    """A trained TA state, coalesced-style weights and a nested leaf."""
    g = torch.Generator().manual_seed(0)
    ta = tm.init_ta_state(g, CFG, "cpu")
    x = (torch.rand((8, 9), generator=g) < 0.5).to(torch.uint8)
    ta = tm_train.train_step_batch(ta, g, x, torch.arange(8) % 3, CFG)
    w = torch.arange(-6, 6, dtype=torch.int32).reshape(4, 3)
    return {"ta_state": ta, "weights": w,
            "meta": [torch.tensor([1.5, -2.0]), torch.tensor(7)]}


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_round_trip_is_exact_and_atomic(tmp_path):
    tree = _tree()
    path = ckpt.save(str(tmp_path), 5, tree, extra={"version": 2})
    assert os.path.basename(path) == "step-000000005"
    assert not any(p.name.startswith("tmp-") for p in tmp_path.iterdir())
    assert ckpt.latest_step(str(tmp_path)) == 5
    got, manifest = ckpt.restore(str(tmp_path), 5, tree, device="cpu")
    _assert_same(got, tree)
    assert manifest["step"] == 5 and manifest["extra"]["version"] == 2
    assert manifest["leaves"]["ta_state"] == "int16"
    step, again, _ = ckpt.restore_latest(str(tmp_path), tree, device="cpu")
    assert step == 5
    _assert_same(again, tree)


def test_latest_step_and_keep(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "absent")) is None
    assert ckpt.restore_latest(str(tmp_path / "absent"), {}) is None
    tree = {"w": torch.ones(2)}
    for step in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), step, tree, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step-000000003", "step-000000004"]
    assert ckpt.latest_step(str(tmp_path)) == 4


@pytest.mark.parametrize("damage,error", [
    ("leaves", ckpt.CheckpointMissingError),
    ("manifest", ckpt.CheckpointMissingError),
    ("garble", ckpt.CheckpointManifestError),
    ("digest", ckpt.CheckpointDigestError)])
def test_corruption_raises_typed_errors(tmp_path, damage, error):
    tree = _tree()
    path = ckpt.save(str(tmp_path), 1, tree)
    if damage == "leaves":
        os.remove(os.path.join(path, "leaves.npz"))
    elif damage == "manifest":
        os.remove(os.path.join(path, "manifest.json"))
    elif damage == "garble":
        with open(os.path.join(path, "manifest.json"), "w") as f:
            f.write('{"step": 1, "extra": {')
    else:
        arrays = {k: v.detach().numpy() for k, v in
                  ckpt._flatten(tree).items()}
        arrays["ta_state"] = arrays["ta_state"].copy()
        arrays["ta_state"][0, 0] ^= 1                  # one flipped bit
        np.savez(os.path.join(path, "leaves.npz"), **arrays)
    with pytest.raises(error):
        ckpt.restore(str(tmp_path), 1, tree, device="cpu")
    with pytest.raises(ckpt.CheckpointError):
        ckpt.restore(str(tmp_path), 1, tree, device="cpu")


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    rng = np.random.default_rng(1)
    ta = rng.integers(1, 255, (12, 18)).astype(np.int16)
    w = rng.integers(-9, 10, (12, 3)).astype(np.int32)
    ref_tree = {"ta_state": jnp.asarray(ta), "weights": jnp.asarray(w)}
    ref_ckpt.save(str(tmp_path), 3, ref_tree, extra={"by": "reference"})
    like = {"ta_state": torch.zeros(1), "weights": torch.zeros(1)}
    got, manifest = ckpt.restore(str(tmp_path), 3, like, device="cpu")
    assert got["ta_state"].dtype == torch.int16
    np.testing.assert_array_equal(got["ta_state"].numpy(), ta)
    np.testing.assert_array_equal(got["weights"].numpy(), w)
    assert manifest["extra"][ckpt.DIGEST_KEY] == ckpt.content_digest(
        {"ta_state": ta, "weights": w})


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = {k: v for k, v in _tree().items() if k != "meta"}
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    ckpt.save(str(port_dir), 9, tree)
    like = {"ta_state": jnp.zeros(1), "weights": jnp.zeros(1)}
    got, manifest = ref_ckpt.restore(str(port_dir), 9, like)
    for k, v in tree.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v.numpy())
        assert np.asarray(got[k]).dtype == v.numpy().dtype
    # The reference writing the same leaves records the same digest.
    ref_ckpt.save(str(ref_dir), 9, {k: jnp.asarray(v.numpy())
                                    for k, v in tree.items()})
    with open(ref_dir / "step-000000009" / "manifest.json") as f:
        ref_manifest = json.load(f)
    assert (ref_manifest["extra"][ckpt.DIGEST_KEY]
            == manifest["extra"][ckpt.DIGEST_KEY])
    assert ref_ckpt.content_digest(
        {k: v.numpy() for k, v in tree.items()}) == ckpt.content_digest(
        {k: v.numpy() for k, v in tree.items()})
