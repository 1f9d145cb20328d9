"""Sharded serving on a mesh of gloo host ranks: the port of the seven
cases of ``tests/test_serve_sharded.py``.

The reference runs its cases on 8 forced host devices in one process; the
port's mesh is one process a rank, so the cases run once, on 4 spawned
host ranks (``launch.hostdev``, rendezvous under ``tmp_path``), over a
``2x2`` and a ``4x1`` ``(replica, batch)`` mesh with R = 8
(``tests/torch_mesh_cases.py``).  Each case is held to the port's
single-device engine bit for bit (the same seed, state format and
backend: the plane-packed kernel's, whose plain version runs here,
nominal and under D2D + C2C, and ``analog-torch`` under D2D + C2C + CSA
offset, which no kernel models), and at nominal to the reference's
single-device engine on the same numpy-drawn include plane and
requests.  A one-rank mesh keeps the kernel backend (in process).
"""

import json
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch_mesh_cases as cases  # noqa: E402
from repro.core import coalesced as ref_co  # noqa: E402
from repro.core import tm as ref_tm  # noqa: E402
from repro.core import variations as ref_var  # noqa: E402
from repro.serve import batching as ref_batching  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro_torch.core import tm  # noqa: E402
from repro_torch.core.variations import VariationConfig  # noqa: E402
from repro_torch.launch import hostdev  # noqa: E402
from repro_torch.launch.mesh import make_replica_mesh  # noqa: E402
from repro_torch.serve import (BatcherConfig, EngineConfig,  # noqa: E402
                               ServeEngine)

RANKS = 4


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Every case once, on 4 host ranks: ``(status by check, arrays)``."""
    out = tmp_path_factory.mktemp("serve_mesh")
    hostdev.run_host_ranks(cases.serve_case, RANKS, (str(out),),
                           rdzv_dir=str(out), timeout=300)
    with open(out / "results.json") as f:
        status = json.load(f)
    with np.load(out / "arrays.npz") as z:
        arrays = dict(z)
    return status, arrays


def _ok(mesh_run, name):
    status = mesh_run[0]
    assert status[name] == "ok", status[name]


def _ref_served(eng, xs):
    eng.submit_many(list(xs))
    rs = eng.drain()
    return (np.array([r.pred for r in rs]),
            np.stack([np.asarray(r.class_sums) for r in rs]))


def _ref_bcfg():
    return ref_batching.BatcherConfig(max_batch=16, bucket_sizes=(8, 16))


def test_sharded_engine_bit_identical_to_single_device(mesh_run):
    """A partitioned R = 8 engine on 4 ranks (``2x2``: rows over ``batch``
    too; ``4x1``) answers like the single-device engine on the same
    backend bit for bit (the plane-packed kernel at nominal and under C2C,
    the eager one under the CSA offset), routed and ensemble, sync and
    async, on every rank; at nominal like the reference's single-device
    engine and the digital TM."""
    _ok(mesh_run, "bitwise")
    arrays = mesh_run[1]
    inc, xs = cases.serve_model()
    cfg = ref_tm.TMConfig(**cases.SERVE_CFG)
    ta = jnp.where(jnp.asarray(inc), cfg.n_states + 1,
                   cfg.n_states).astype(cfg.state_dtype)
    for routing in cases.ROUTINGS:
        ref = ref_engine.ServeEngine.from_ta_state(
            ta, cfg, n_replicas=8, key=jax.random.PRNGKey(3),
            vcfg=ref_var.VariationConfig.nominal(),
            ecfg=ref_engine.EngineConfig(batcher=_ref_bcfg(),
                                         routing=routing,
                                         backend="analog-jnp"))
        want = _ref_served(ref, xs)
        for mesh in cases.MESHES:
            for cls in ("ServeEngine", "AsyncServeEngine"):
                key = f"{mesh}_{routing}_{cls}"
                np.testing.assert_array_equal(arrays[key + "_preds"],
                                              want[0], err_msg=key)
                np.testing.assert_array_equal(arrays[key + "_sums"],
                                              want[1], err_msg=key)


def test_pool_shard_places_replicas_across_ranks(mesh_run):
    """``pool.shard`` splits the ``[R, C, L]`` stack over ``replica`` as
    DTensor blocks holding the programmed bits and keeps the shared
    include plane whole; an axis that does not divide leaves it whole."""
    _ok(mesh_run, "pool_shard")


def test_sharded_state_falls_back_loudly(mesh_run):
    """A partitioned state needs ``CAP_SHARDED``, which every backend
    declares: a kernel preference holds and the mesh default, the
    plane-packed kernel, is quiet; a partitioned read with the CSA offset
    falls back to ``analog-torch`` with a warning and a counted fallback
    every dispatch."""
    _ok(mesh_run, "loud_fallback")


def test_sharded_ensemble_single_stacked_read(mesh_run):
    """One ensemble batch over the mesh is one kernel launch a rank on its
    own replicas (one eager stacked read under the CSA offset), no
    per-replica loop, and the next batch one more."""
    _ok(mesh_run, "fused_dispatch")


def test_sharded_noise_stream_matches_single_device(mesh_run):
    """Full noise (C2C + CSA offset): each rank draws the whole read's
    noise and keeps its block, so sharded ensemble serving equals the
    single-device engine bit for bit and repeats run to run."""
    _ok(mesh_run, "noise_stream")


def test_async_overlap_metrics_on_mesh(mesh_run):
    """``AsyncServeEngine`` on a mesh: responses in submission order, the
    double buffer held dispatches in flight, overlap within [0, 1]."""
    _ok(mesh_run, "async_overlap")


def test_coalesced_sharded_engine_class_parallel(mesh_run):
    """A coalesced pool's ``[C, M]`` weights split their class columns
    over ``replica`` and the shared TA plane stays whole; the plane-packed
    kernel is the quiet default and the sums equal the single-device
    engine's, ``core.coalesced.forward`` and the reference's engine."""
    _ok(mesh_run, "coalesced")
    ta, w = cases.coalesced_model()
    _, xs = cases.serve_model()
    ccfg = ref_co.CoalescedConfig(**cases.COALESCED_CFG)
    for routing in ("round_robin", "ensemble"):
        ref = ref_engine.ServeEngine.from_coalesced(
            jnp.asarray(ta), jnp.asarray(w), ccfg,
            ecfg=ref_engine.EngineConfig(batcher=_ref_bcfg(),
                                         routing=routing,
                                         backend="coalesced"))
        want = _ref_served(ref, xs)
        for mesh in cases.MESHES:
            np.testing.assert_array_equal(
                mesh_run[1][f"coalesced_{mesh}_{routing}_sums"], want[1])


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("vname", ["nominal", "c2c"])
def test_one_rank_mesh_keeps_the_kernel_backend(one_rank_group, vname):
    """A mesh of one rank partitions nothing: the state stays whole and
    plane-packed, the kernel backend serves it without a fallback, and
    the responses equal the engine without a mesh."""
    inc, xs = cases.serve_model()
    cfg = tm.TMConfig(**cases.SERVE_CFG)
    ta = torch.where(torch.from_numpy(inc), cfg.n_states + 1,
                     cfg.n_states).to(cfg.state_dtype)
    vcfg = (VariationConfig.nominal() if vname == "nominal"
            else VariationConfig(csa_offset=False))
    mesh = make_replica_mesh(1, 1, device_type="cpu")
    runs = []
    for m in (None, mesh):
        with warnings.catch_warnings():
            warnings.simplefilter("error")       # no fallback warning
            eng = ServeEngine.from_ta_state(
                ta, cfg, n_replicas=4, seed=3, vcfg=vcfg, device="cpu",
                mesh=m, ecfg=EngineConfig(
                    routing="ensemble",
                    batcher=BatcherConfig(max_batch=16, bucket_sizes=(8, 16))))
        s = eng.summary()
        assert eng.backend.name == "analog-cuda-packed2"
        assert s["sharded"] is False and s["plane_packed"]
        assert s["mesh"] == (None if m is None
                             else {"replica": 1, "batch": 1})
        runs.append(cases._served(eng, xs))
        assert eng.summary()["fallback_dispatches"] == 0
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
