"""``distributed/sharding.py``, ``launch/mesh.py`` and
``launch/hostdev.py`` as pure functions, against the reference's on the
same shapes, rules and mesh sizes.

The reference reads a mesh only through ``mesh.shape`` (axis -> size), so
both sides get the same sizes here (a ``SimpleNamespace`` for the
reference, a mapping for the port) and no process group is needed; the
placement half (DTensor blocks, gathers, a one-rank mesh) runs at the end
in a one-rank gloo group, and on several ranks in
``test_torch_serve_sharded.py`` / ``test_torch_distributed.py``.
"""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.launch import hostdev as ref_hostdev  # noqa: E402
from repro.launch import mesh as ref_mesh  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import hostdev, mesh  # noqa: E402

MESHES = [{"data": 2, "model": 4}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16}, {"replica": 4, "batch": 2},
          {"replica": 8, "batch": 1}]
RULES = [dict(), dict(batch=("data", "model"), seq=None, heads=None,
                      kv_seq=None, expert=None, vocab=None, mlp=None,
                      fsdp="data", tensor=None),
         dict(seq="model"),
         dict(batch="batch", seq=None, embed=None, heads=None, kv_seq=None,
              expert=None, vocab=None, mlp=None, fsdp=None, tensor=None,
              replica="replica")]
LEAVES = {
    "r_stack": (8, 40, 64), "weights": (40, 8), "pool.weights": (40, 6),
    "embed": (1024, 64), "unembed": (64, 1000), "w_vision": (32, 64),
    "layers.attn.w_q": (4, 64, 16, 8), "w_k": (64, 2, 8), "w_v": (64, 2, 8),
    "w_o": (16, 8, 64), "b_q": (16, 8), "w_dkv": (64, 32),
    "w_kpe": (64, 8), "w_uk": (32, 16, 8), "w_uv": (32, 16, 8),
    "kv_norm": (32,), "mlp.w_up": (64, 256), "w_gate": (64, 256),
    "w_down": (256, 64), "router": (64, 8), "experts_up": (8, 64, 32),
    "experts_gate": (8, 64, 32), "experts_down": (8, 32, 64),
    "w_z": (64, 128), "w_x": (64, 128), "w_bc": (64, 32), "w_dt": (64, 4),
    "w_out": (128, 64), "conv_x_w": (4, 128), "conv_x_b": (128,),
    "conv_bc_w": (4, 32), "w_mq": (64, 128), "w_gates": (64, 16),
    "r_gates": (4, 4, 4), "w_ogate": (64, 128), "gate_bias": (16,),
    "norm.scale": (64,), "a_log": (8,), "unmatched": (3, 5),
    "w_up.row": (64,), "w_up.col": (256,), "w_up.full": (64, 256),
    "experts_up.row": (8, 64), "experts_up.col": (8, 32),
    "include": (40, 64), "stack.plane_dev": (8, 40, 64),
}


def _pair(kw):
    return shd.ShardingRules(**kw), ref_shd.ShardingRules(**kw)


def _ref_mesh(shape):
    return types.SimpleNamespace(shape=dict(shape))


def _same(port_fn, ref_fn):
    """``port_fn()`` against ``ref_fn()``: the same value, or the same
    exception type (rules naming an axis the mesh lacks raise
    ``KeyError`` in both)."""
    try:
        want = ref_fn()
    except Exception as e:                  # the reference's own error
        with pytest.raises(type(e)):
            port_fn()
        return None
    return port_fn(), want


@pytest.mark.parametrize("rules", RULES, ids=range(len(RULES)))
@pytest.mark.parametrize("shape", MESHES + [None],
                         ids=[str(m) for m in MESHES] + ["no mesh"])
def test_param_pspec_matches_reference(rules, shape):
    """Every rule, the suffixes and the divisibility fix-up."""
    port_rules, ref_rules = _pair(rules)
    ref_m = None if shape is None else _ref_mesh(shape)
    for path, dims in LEAVES.items():
        pair = _same(lambda: shd.param_pspec(path, dims, port_rules, shape),
                     lambda: ref_shd.param_pspec(path, dims, ref_rules,
                                                 ref_m))
        if pair is not None:
            assert pair[0] == tuple(pair[1]), (path, dims, pair)


@pytest.mark.parametrize("shape", MESHES, ids=[str(m) for m in MESHES])
def test_tree_specs_and_divisibility_match_reference(shape):
    """``tree_pspecs`` and ``validate_divisibility`` on a nested tree."""
    port_rules, ref_rules = _pair(RULES[0])
    tree = {"params": dict(LEAVES),
            "stacked": [LEAVES["w_k"], (6, 64, 4, 8)]}
    port_tree = {"params": {k: torch.empty(v) for k, v in
                            tree["params"].items()},
                 "stacked": [torch.empty(v) for v in tree["stacked"]]}
    ref_tree = {"params": {k: jax.ShapeDtypeStruct(v, jnp.float32)
                           for k, v in tree["params"].items()},
                "stacked": [jax.ShapeDtypeStruct(v, jnp.float32)
                            for v in tree["stacked"]]}
    pair = _same(
        lambda: shd.tree_pspecs(port_tree, port_rules, shape),
        lambda: ref_shd.tree_pspecs(ref_tree, ref_rules, _ref_mesh(shape)))
    if pair is None:
        return
    got, want = pair
    assert got["params"] == {k: tuple(v)
                             for k, v in want["params"].items()}
    assert got["stacked"] == [tuple(v) for v in want["stacked"]]
    bad = shd.validate_divisibility(port_tree, shape, port_rules)
    ref_bad = ref_shd.validate_divisibility(ref_tree, _ref_mesh(shape),
                                            ref_rules)
    assert sorted(bad) == sorted((p, tuple(s), tuple(sp))
                                 for p, s, sp in ref_bad)


@pytest.mark.parametrize("shape", MESHES[:3],
                         ids=[str(m) for m in MESHES[:3]])
def test_cache_pspec_matches_reference(shape):
    port_rules, ref_rules = _pair(RULES[0])
    for dims in [(4, 1024, 2, 64), (8, 16, 4096), (4, 8), (1, 1024, 64),
                 (2, 4, 2048, 16), (4, 4)]:
        pair = _same(
            lambda: shd.cache_pspec(dims, shape, port_rules, 4, 1024),
            lambda: ref_shd.cache_pspec(dims, _ref_mesh(shape), ref_rules, 4,
                                        1024))
        if pair is not None:
            assert pair[0] == tuple(pair[1]), dims
            placed = shd.cache_shardings({"leaf": torch.empty(dims)}, shape,
                                         port_rules, 4, 1024)
            assert placed["leaf"].spec == pair[0]


@pytest.mark.parametrize("shape", MESHES, ids=[str(m) for m in MESHES])
def test_replica_and_batch_rules_match_reference(shape):
    got = shd.replica_rules(shape)
    want = ref_shd.replica_rules(_ref_mesh(shape))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    rules, ref_rules = _pair(RULES[1])
    assert shd.batch_pspec(rules) == tuple(ref_shd.batch_pspec(ref_rules))
    assert mesh.batch_axes(shape) == ref_mesh.batch_axes(_ref_mesh(shape))


def test_constrain_is_a_noop_without_rules():
    x = torch.arange(8.0)
    assert shd.active() is None
    assert shd.constrain(x, "batch") is x
    with shd.use_sharding({"data": 1}, shd.ShardingRules()):
        assert shd.active().rules == shd.ShardingRules()
    assert shd.active() is None


@pytest.mark.parametrize("spec,message", [
    ("2x2x2", "bad mesh spec"), ("a", "bad mesh spec"),
    ("2xb", "bad mesh spec"), ("0", "mesh axes must be >= 1"),
    ("2x0", "mesh axes must be >= 1")])
def test_parse_mesh_spec_rejects_as_the_reference(spec, message):
    with pytest.raises(ValueError, match=message):
        ref_mesh.parse_mesh_spec(spec)
    with pytest.raises(ValueError, match=message):
        mesh.parse_mesh_spec(spec, device_type="cpu")


def test_mesh_without_a_process_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="process group"):
        mesh.parse_mesh_spec("2x2", device_type="cpu")


@pytest.mark.parametrize("argv", [
    [], ["--host-devices", "8"], ["--host-devices=4", "--mesh", "2x2"],
    ["--host-devices"], ["--host-devices", "x"], ["--host-devices=",
                                                  "--json"],
    ["--mesh", "4", "--host-devices", "2", "--host-devices", "3"]])
def test_parse_host_devices_matches_reference(argv):
    assert hostdev.parse_host_devices(argv) == \
        ref_hostdev.parse_host_devices(argv)
    assert not any(t.startswith("--host-devices")
                   for t in hostdev.strip_host_devices(argv)
                   if hostdev.parse_host_devices(argv) is not None)


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_placement_on_a_one_rank_mesh(one_rank_group):
    """On one rank nothing is partitioned: ``shard_tree`` leaves every
    leaf whole, ``tree_is_sharded`` is false, a placed tensor is its own
    block and gathers to itself, and a mismatched mesh size raises."""
    m = mesh.make_replica_mesh(1, 1, device_type="cpu")
    assert shd.mesh_shape(m) == {"replica": 1, "batch": 1}
    tree = {"r_stack": torch.arange(24.0).reshape(2, 3, 4),
            "include": torch.ones(3, 4, dtype=torch.bool)}
    placed = shd.shard_tree(tree, m)
    assert placed["r_stack"] is tree["r_stack"]
    assert not shd.tree_is_sharded(placed)
    d = shd.NamedSharding(m, ("replica", None, None)).place(tree["r_stack"])
    assert isinstance(d, shd.DTensor) and not shd.partitioned(d)
    block, offs, shape = shd.local_block(d)
    assert torch.equal(block, tree["r_stack"]) and offs == (0, 0, 0)
    assert torch.equal(shd.gather(d), tree["r_stack"])
    assert shd.all_agree(True) and shd.all_min(3) == 3
    assert shd.broadcast_values([2.5, 1.0]) == [2.5, 1.0]
    with pytest.raises(ValueError, match="needs 4 ranks"):
        mesh.make_replica_mesh(2, 2, device_type="cpu")
