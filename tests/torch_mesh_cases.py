"""Multi-rank cases of the port's mesh tests, run on gloo host ranks by
``test_torch_serve_sharded.py`` and ``test_torch_distributed.py``
(``repro_torch.launch.hostdev.run_host_ranks``, rendezvous under the
test's ``tmp_path``).

A rank imports torch and the port only, never jax.  Every rank runs every
check of a case in the same order (they hold collectives); each check is
recorded by name as "ok" or its traceback, so one failing check fails its
own test.  Rank 0 writes the record (``results.json``) and the arrays the
parent holds to the JAX reference (``arrays.npz``) into the output
directory.  Models and requests are drawn with numpy from seeds, the same
draws the parent makes.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist

SERVE_CFG = dict(n_classes=4, clauses_per_class=8, n_features=32,
                 n_states=100)
COALESCED_CFG = dict(n_classes=8, n_clauses=32, n_features=32,
                     n_states=100)
N_REQUESTS = 48
ROUTINGS = ("round_robin", "least_loaded", "ensemble")
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}


def serve_model():
    """``(include [C, L] bool, requests [48, F] uint8)`` from numpy seeds
    0 and 1 (the reference prologue's shapes and densities)."""
    c = SERVE_CFG["n_classes"] * SERVE_CFG["clauses_per_class"]
    rng = np.random.default_rng(0)
    inc = rng.random((c, 2 * SERVE_CFG["n_features"])) < 0.1
    xs = (np.random.default_rng(1).random(
        (N_REQUESTS, SERVE_CFG["n_features"])) < 0.4).astype(np.uint8)
    return inc, xs


def coalesced_model():
    """``(ta [C, L] int16, weights [C, M] int32)`` from numpy seed 4."""
    cc = COALESCED_CFG
    rng = np.random.default_rng(4)
    inc = rng.random((cc["n_clauses"], 2 * cc["n_features"])) < 0.1
    ta = np.where(inc, cc["n_states"] + 1, cc["n_states"]).astype(np.int16)
    w = rng.integers(-7, 8, (cc["n_clauses"], cc["n_classes"])).astype(
        np.int32)
    return ta, w


class Record:
    """Per-check outcomes and arrays of one case, written by rank 0."""

    def __init__(self):
        self.status = {}
        self.arrays = {}

    def check(self, name, fn):
        try:
            fn()
            self.status[name] = "ok"
        except Exception:                       # recorded, reported by test
            self.status[name] = traceback.format_exc()

    def save(self, out_dir):
        if dist.get_rank() == 0:
            with open(os.path.join(out_dir, "results.json"), "w") as f:
                json.dump(self.status, f)
            np.savez(os.path.join(out_dir, "arrays.npz"), **self.arrays)


def _served(eng, xs):
    eng.submit_many(list(xs))
    rs = eng.drain()
    return (np.array([r.pred for r in rs]),
            np.stack([r.class_sums for r in rs]))


def _equal(a, b, what):
    np.testing.assert_array_equal(a[0], b[0], err_msg=f"preds {what}")
    np.testing.assert_array_equal(a[1], b[1], err_msg=f"sums {what}")


def _all_ranks_equal(arr):
    """``arr`` is the same on every rank."""
    t = torch.as_tensor(np.ascontiguousarray(arr)).to(torch.float64)
    got = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(got, t)
    for g in got:
        assert torch.equal(g, t), "ranks disagree"


# ------------------------------------------------------------------ serve

def serve_case(out_dir):
    """The seven cases of the reference's ``tests/test_serve_sharded.py``
    on 4 ranks, over a ``2x2`` and a ``4x1`` replica mesh, R = 8."""
    from repro_torch import api
    from repro_torch.core import imbue, tm
    from repro_torch.core.coalesced import CoalescedConfig
    from repro_torch.core.coalesced import forward as co_forward
    from repro_torch.core.variations import VariationConfig
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_replica_mesh
    from repro_torch.serve import (AsyncServeEngine, BatcherConfig,
                                   CoalescedPool, EngineConfig, ServeEngine,
                                   program_replica_pool)

    rec = Record()
    cfg = tm.TMConfig(**SERVE_CFG)
    inc_np, xs = serve_model()
    inc = torch.from_numpy(inc_np)
    ta = torch.where(inc, cfg.n_states + 1, cfg.n_states).to(cfg.state_dtype)
    bcfg = BatcherConfig(max_batch=16, bucket_sizes=(8, 16))
    meshes = {k: make_replica_mesh(*v, device_type="cpu")
              for k, v in MESHES.items()}

    def engine(n, mesh=None, cls=ServeEngine, vcfg=None, **ecfg):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return cls.from_ta_state(
                ta, cfg, n_replicas=n, seed=3,
                vcfg=VariationConfig.nominal() if vcfg is None else vcfg,
                ecfg=EngineConfig(batcher=bcfg, **ecfg), device="cpu",
                mesh=mesh)

    def single(n, vcfg=None, **ecfg):
        """The single-device engine a partitioned one must equal: the same
        seed, state format and backend, without a mesh."""
        return engine(n, vcfg=vcfg, **ecfg)

    digital = tm.forward(ta, torch.from_numpy(xs), cfg).numpy()
    # The backend each noise model selects: the plane-packed kernel, or,
    # for a read with the CSA offset, which no kernel models, the eager one.
    backends = {"nominal": "analog-cuda-packed2",
                "c2c": "analog-cuda-packed2", "noisy": "analog-torch"}

    def bitwise():
        for name, mesh in meshes.items():
            for vname, vcfg in (("nominal", None),
                                ("c2c", VariationConfig(csa_offset=False)),
                                ("noisy", VariationConfig())):
                for routing in ROUTINGS:
                    want = _served(single(8, vcfg, routing=routing), xs)
                    for cls in (ServeEngine, AsyncServeEngine):
                        e = engine(8, mesh, cls, vcfg, routing=routing)
                        s = e.summary()
                        assert s["sharded"] and s["plane_packed"]
                        assert e.backend.name == backends[vname]
                        assert e.selection.fell_back == (vname == "noisy")
                        got = _served(e, xs)
                        what = f"{name} {vname} {routing} {cls.__name__}"
                        _equal(got, want, what)
                        _all_ranks_equal(got[1])
                        if vname == "nominal":
                            np.testing.assert_array_equal(
                                got[0], digital.argmax(-1), err_msg=what)
                            rec.arrays[f"{name}_{routing}_{cls.__name__}"
                                       "_sums"] = got[1]
                            rec.arrays[f"{name}_{routing}_{cls.__name__}"
                                       "_preds"] = got[0]

    def pool_shard():
        for name, mesh in meshes.items():
            n_rep = MESHES[name][0]
            pool = program_replica_pool(
                inc, torch.Generator().manual_seed(2), 8,
                VariationConfig.nominal())
            sh = pool.shard(mesh, None)
            assert sh.is_sharded and not pool.is_sharded
            assert isinstance(sh.r_stack, sharding.DTensor)
            assert sharding.placements(mesh, ("replica", None, None)) == \
                list(sh.r_stack.placements)
            block, offs, shape = sharding.local_block(sh.r_stack)
            assert block.shape[0] == 8 // n_rep and shape == (
                8, *inc.shape), (block.shape, shape)
            # the shared TA actions stay whole on every rank
            assert not isinstance(sh.include, sharding.DTensor)
            # programming happened before placement: the same bits
            assert torch.equal(block, pool.r_stack[offs[0]:offs[0] + 8
                                                   // n_rep])
            assert torch.equal(sharding.gather(sh.r_stack), pool.r_stack)
            assert sh.n_replicas == 8 and sh.icfg == pool.icfg
            # an axis that does not divide is dropped: the pool stays whole
            odd = program_replica_pool(inc, torch.Generator().manual_seed(2),
                                       3, VariationConfig.nominal())
            assert not odd.shard(mesh).is_sharded

    def loud_fallback():
        mesh = meshes["4x1"]
        pool = program_replica_pool(inc, torch.Generator().manual_seed(2),
                                    8, VariationConfig.nominal())
        state = pool.shard(mesh, None).state(cfg).pack()
        need = api.required_capabilities(state)
        assert api.CAP_SHARDED in need
        # every backend reads a partitioned state: a kernel preference
        # holds, and the ladder's top serves the plane-packed blocks
        for prefer in ("analog-cuda-packed", "analog-cuda"):
            sel = api.select_backend(state, prefer=prefer)
            assert not sel.fell_back and sel.backend.name == prefer
        assert api.select_backend(state.pack_planes()).backend.name == \
            "analog-cuda-packed2"
        # the unsharded twin needs no CAP_SHARDED
        assert api.CAP_SHARDED not in api.required_capabilities(
            pool.state(cfg))
        # a partitioned read with the CSA offset, which no kernel
        # models, falls back loudly, counted every dispatch
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            eng = ServeEngine.from_ta_state(
                ta, cfg, n_replicas=8, seed=3, vcfg=VariationConfig(),
                ecfg=EngineConfig(batcher=bcfg,
                                  backend="analog-cuda-packed"),
                device="cpu", mesh=mesh)
        assert eng.selection.fell_back
        assert any("fallback" in str(x.message) for x in w)
        eng.submit_many(list(xs[:16]))
        eng.drain()
        s = eng.summary()
        assert s["sharded"] is True and s["backend"] == "analog-torch"
        assert s["fallback_dispatches"] == eng.metrics.batches > 0
        assert any("models_csa_offset" in r
                   for r in s["forward_fallbacks"])
        assert s["mesh"] == {"replica": 4, "batch": 1}
        # the mesh default is the kernel ladder's top: quiet
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            eng2 = engine(8, mesh)
        assert not eng2.selection.fell_back
        assert eng2.backend.name == "analog-cuda-packed2"

    def fused_dispatch():
        calls = []
        for mod, attr in ((ops, "imbue_infer_planes"),
                          (imbue, "stacked_clause_outputs")):
            real = getattr(mod, attr)
            setattr(mod, attr, lambda *a, real=real, **kw:
                    calls.append(a) or real(*a, **kw))
            try:
                for mesh in meshes.values():
                    # the kernel's launch on the D2D deviation plane, or
                    # with the CSA offset the eager stacked read: one a
                    # batch on this rank's replicas, not one a replica
                    vcfg = (VariationConfig(c2c=False, csa_offset=False)
                            if attr == "imbue_infer_planes"
                            else VariationConfig())
                    calls.clear()
                    eng = engine(8, mesh, vcfg=vcfg, routing="ensemble")
                    eng.submit_many(list(xs[:16]))
                    eng.drain()
                    assert len(calls) == 1, f"{len(calls)} stacked reads"
                    local = 8 // mesh.size(0)
                    if attr == "imbue_infer_planes":
                        assert calls[0][2].shape[0] == local, \
                            calls[0][2].shape
                    eng.submit_many(list(xs[16:32]))
                    eng.drain()
                    assert len(calls) == 2, f"{len(calls)} stacked reads"
            finally:
                setattr(mod, attr, real)

    def noise_stream():
        for name, mesh in meshes.items():
            runs = [_served(single(8, VariationConfig(), routing="ensemble"),
                            xs)]
            for _ in range(2):
                runs.append(_served(engine(8, mesh, vcfg=VariationConfig(),
                                           routing="ensemble"), xs))
            _equal(runs[1], runs[0], f"{name} noisy vs single")
            _equal(runs[2], runs[1], f"{name} run to run")
            assert runs[0][1].any(), "no class sum fired"

    def async_overlap():
        for mesh in meshes.values():
            eng = engine(8, mesh, AsyncServeEngine)
            seen = []
            orig = eng._issue

            def spy(batch, eng=eng, orig=orig):
                seen.append(eng.in_flight)
                return orig(batch)
            eng._issue = spy
            rids = eng.submit_many(list(xs))
            rs = eng.drain()
            assert [r.rid for r in rs] == rids
            assert eng.in_flight == 0
            assert max(seen) >= 1, seen
            s = eng.summary()
            assert 0.0 <= s["overlap_fraction"] <= 1.0
            assert s["device_wait_s"] >= 0 and s["host_pack_s"] > 0

    def coalesced():
        ccfg = CoalescedConfig(**COALESCED_CFG)
        cta_np, w_np = coalesced_model()
        cta, w = torch.from_numpy(cta_np), torch.from_numpy(w_np)
        want = co_forward(cta, w, torch.from_numpy(xs), ccfg).numpy()
        for name, mesh in meshes.items():
            pool = CoalescedPool(ta_state=cta, weights=w, cfg=ccfg)
            sh = pool.shard(mesh, None)
            assert sh.is_sharded and not pool.is_sharded
            # class-parallel: the M axis of [C, M] splits over replica
            assert list(sh.weights.placements) == sharding.placements(
                mesh, (None, "replica"))
            assert not isinstance(sh.ta_state, sharding.DTensor)
            state = sh.state()
            assert api.CAP_SHARDED in api.required_capabilities(state)
            sel = api.select_backend(state)
            assert sel.backend.name == "coalesced-cuda" and not sel.fell_back
            for routing in ("round_robin", "ensemble"):
                single = ServeEngine.from_coalesced(
                    cta, w, ccfg, device="cpu",
                    ecfg=EngineConfig(batcher=bcfg, routing=routing))
                e = ServeEngine.from_coalesced(
                    cta, w, ccfg, device="cpu", mesh=mesh,
                    ecfg=EngineConfig(batcher=bcfg, routing=routing))
                assert e.state.is_sharded and e.summary()["sharded"]
                assert e.backend.name == "coalesced-cuda-packed2"
                assert not e.selection.fell_back
                assert e.summary()["forward_fallbacks"] == []
                got = _served(e, xs)
                _equal(got, _served(single, xs), f"{name} {routing}")
                np.testing.assert_array_equal(got[1], want)
                rec.arrays[f"coalesced_{name}_{routing}_sums"] = got[1]

    for name, fn in (("bitwise", bitwise), ("pool_shard", pool_shard),
                     ("loud_fallback", loud_fallback),
                     ("fused_dispatch", fused_dispatch),
                     ("noise_stream", noise_stream),
                     ("async_overlap", async_overlap),
                     ("coalesced", coalesced)):
        rec.check(name, fn)
    rec.save(out_dir)


# ------------------------------------------------------------ distributed

TRAIN_CFG = dict(n_classes=2, clauses_per_class=8, n_features=12)
PAD_CFG = dict(n_classes=3, clauses_per_class=2, n_features=12)


def xor_data():
    """The noisy-XOR arrays of the reference's sharded TM test's shapes
    (256 train, 128 test rows), from the port's generator, seed 0."""
    from repro_torch.data.tm_datasets import noisy_xor
    return noisy_xor(torch.Generator().manual_seed(0), 256, 128,
                     device="cpu")


def distributed_case(out_dir, ckpt_dir):
    """Sharded TM training and inference, checkpoint re-sharding and the
    sharded stream, on 4 ranks."""
    from repro_torch.core import tm
    from repro_torch.core import tm_distributed as tmd
    from repro_torch.core.tm import TMConfig
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_debug_mesh

    rec = Record()
    xtr, ytr, xte, yte = xor_data()

    def train(cfg, shape):
        ta = tm.init_ta_state(torch.Generator().manual_seed(1), cfg, "cpu")
        ref = tmd.tm_train_step(ta, torch.Generator().manual_seed(2), xtr,
                                ytr, cfg)
        mesh = make_debug_mesh(*shape, device_type="cpu")
        st_sh, x_sh, y_sh = tmd.tm_shardings(cfg, mesh, 256)
        got = tmd.tm_train_step(st_sh.place(ta),
                                torch.Generator().manual_seed(2),
                                x_sh.place(xtr), y_sh.place(ytr), cfg)
        assert sharding.partitioned(got) == (
            cfg.n_clauses % shape[1] == 0 and shape[1] > 1)
        assert torch.equal(sharding.gather(got), ref)
        return ref, got, mesh

    def train_2x2():
        cfg = TMConfig(**TRAIN_CFG)
        ref, got, mesh = train(cfg, (2, 2))
        start = tm.init_ta_state(torch.Generator().manual_seed(1), cfg, "cpu")
        assert not torch.equal(ref, start), "the step moved nothing"
        ref_pred = tmd.tm_infer_step(ref, xte, cfg)
        got_pred = tmd.tm_infer_step(got, xte, cfg)
        assert torch.equal(got_pred, ref_pred)
        # rows over data as well
        _, x_sh, _ = tmd.tm_shardings(cfg, mesh, 128)
        assert torch.equal(tmd.tm_infer_step(got, x_sh.place(xte), cfg),
                           ref_pred)
        # digital fused inference == the TM's predict
        assert torch.equal(got_pred, tm.predict(ref, xte, cfg))
        rec.arrays["train_2x2"] = ref.numpy()

    def train_padded():
        cfg = TMConfig(**PAD_CFG)
        mesh = make_debug_mesh(1, 4, device_type="cpu")
        padded = tmd.pad_clauses_for_mesh(cfg, mesh)
        assert padded.n_clauses % 4 == 0 and padded != cfg
        assert not tmd.tm_shardings(cfg, mesh, 256)[0].partitions
        train(padded, (1, 4))
        train(cfg, (1, 4))                  # left whole: still the step

    def checkpoint():
        cfg = TMConfig(**TRAIN_CFG)
        ta = tm.init_ta_state(torch.Generator().manual_seed(1), cfg, "cpu")
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        st_sh = tmd.tm_shardings(cfg, mesh, 256)[0]
        like = {"ta": ta}
        tree, _ = ckpt.restore(ckpt_dir, 1, like, device="cpu",
                               shardings={"ta": st_sh})
        assert sharding.partitioned(tree["ta"])
        assert torch.equal(sharding.gather(tree["ta"]), ta)
        ckpt.save(ckpt_dir, 2, tree)          # gathered; rank 0 writes
        back, _ = ckpt.restore(ckpt_dir, 2, like, device="cpu")
        assert torch.equal(back["ta"], ta)

    def stream():
        rec.arrays.update(_stream_on_mesh())

    for name, fn in (("train_2x2", train_2x2),
                     ("train_padded", train_padded),
                     ("checkpoint", checkpoint), ("stream", stream)):
        rec.check(name, fn)
    rec.save(out_dir)


STREAM = dict(mels=6, bits=2, window=4, hop=2)


def _stream_on_mesh():
    """The reference's sharded-stream case: streamed windows equal offline
    ``api.predict`` on a sharded R = 8 pool, sync and async, on ``4x1``
    and ``2x2``; and equal the single-device engine's offline answers."""
    from repro_torch import api
    from repro_torch.core.booleanize import StreamingBooleanizer, fit_quantile
    from repro_torch.core.tm import TMConfig
    from repro_torch.core.variations import VariationConfig
    from repro_torch.data.tm_datasets import synthetic_kws6
    from repro_torch.launch.mesh import make_replica_mesh
    from repro_torch.serve import (AsyncServeEngine, BatcherConfig,
                                   EngineConfig, ServeEngine, StreamConfig,
                                   StreamServer)
    s = STREAM
    frames, _ = synthetic_kws6(torch.Generator().manual_seed(0),
                               n_utterances=8, n_frames=24, n_mels=s["mels"],
                               device="cpu")
    frames = frames.numpy()
    booleanizer = fit_quantile(frames.reshape(-1, s["mels"]), bits=s["bits"],
                               device="cpu")
    cfg = TMConfig(n_classes=6, clauses_per_class=6,
                   n_features=s["window"] * s["mels"] * s["bits"],
                   n_states=100)
    inc = torch.from_numpy(np.random.default_rng(5).random(
        (cfg.n_clauses, cfg.n_literals)) < 0.1)
    ta = torch.where(inc, cfg.n_states + 1, cfg.n_states).to(cfg.state_dtype)
    stream = frames.reshape(-1, s["mels"])[:48]
    rows = StreamingBooleanizer(booleanizer, s["window"],
                                s["hop"]).transform_offline(stream)
    single = ServeEngine.from_ta_state(
        ta, cfg, n_replicas=8, seed=3, vcfg=VariationConfig.nominal(),
        ecfg=EngineConfig(routing="ensemble"), device="cpu")
    offline_single = api.predict(single.state, torch.from_numpy(rows))
    out = {"stream_offline_single": offline_single.numpy(),
           "stream_rows": rows, "stream_ta": ta.numpy()}
    for name, shape in (("4x1", (4, 1)), ("2x2", (2, 2))):
        mesh = make_replica_mesh(*shape, device_type="cpu")
        for cls in (ServeEngine, AsyncServeEngine):
            eng = cls.from_ta_state(
                ta, cfg, n_replicas=8, seed=3,
                vcfg=VariationConfig.nominal(),
                ecfg=EngineConfig(routing="ensemble",
                                  batcher=BatcherConfig(
                                      max_batch=16, bucket_sizes=(8, 16))),
                device="cpu", mesh=mesh)
            assert eng.state.is_sharded
            server = StreamServer(eng, booleanizer,
                                  StreamConfig(window=s["window"],
                                               hop=s["hop"], vote=3))
            for lo in range(0, len(stream), 5):
                server.feed("u", stream[lo:lo + 5])
                server.pump()
            server.drain()
            streamed = np.array(
                [d.pred for d in server.sessions["u"].decisions])
            offline = api.predict(eng.state, torch.from_numpy(rows))
            what = f"{name} {cls.__name__}"
            np.testing.assert_array_equal(streamed, offline.numpy(),
                                          err_msg=what)
            np.testing.assert_array_equal(streamed, offline_single.numpy(),
                                          err_msg=what)
            out[f"stream_{name}_{cls.__name__}"] = streamed
    return out


# -------------------------------------------------------- pipeline, LM

PIPE = dict(stages=4, d=32, batch=8, seq=16, microbatches=4)
PIPE_TOL = 2e-5          # the reference's bar (tests/test_distributed.py)
LM_BATCH = 4


def pipeline_params():
    """The demo's stage weights ``{"w1": [4, 32, 128], "w2": [4, 128,
    32]}`` and input ``[8, 16, 32]``, drawn with numpy seeds 0 and 1."""
    rng = np.random.default_rng(0)
    d, s = PIPE["d"], PIPE["stages"]
    params = {"w1": (rng.standard_normal((s, d, 4 * d)) / d ** 0.5
                     ).astype(np.float32),
              "w2": (rng.standard_normal((s, 4 * d, d)) / (4 * d) ** 0.5
                     ).astype(np.float32)}
    x = np.random.default_rng(1).standard_normal(
        (PIPE["batch"], PIPE["seq"], d)).astype(np.float32)
    return params, x


def lm_tokens(vocab):
    return np.random.default_rng(2).integers(0, vocab, (LM_BATCH, 64))


def pipeline_case(out_dir):
    """On 4 ranks: the GPipe demo (``pipeline_apply`` on a ``(pipe 4,)``
    mesh) against ``sequential_apply``, with the stage weights whole on
    every rank and partitioned over ``pipe``; then ``rules_for`` on a
    ``(data 2, model 2)`` debug mesh: the qwen2 ``smoke()`` model's
    parameters stored as blocks (``shard_module``) give the forward of
    the whole model, exactly under ``pure_dp`` (FSDP blocks gathered at
    use) and within ``TP_TOL`` under the default rules (tensor
    parallelism)."""
    from repro_torch import convert
    from repro_torch.configs import get_config, smoke
    from repro_torch.distributed import pipeline, sharding
    from repro_torch.launch.mesh import (make_debug_mesh, make_pipeline_mesh,
                                         rules_for)
    from repro_torch.models import transformer as tf

    rec = Record()
    params_np, x_np = pipeline_params()
    params = convert.pipeline_params_from_numpy(params_np, "cpu")
    x = torch.from_numpy(x_np)

    def gpipe():
        mesh = make_pipeline_mesh(PIPE["stages"], device_type="cpu")
        ref = pipeline.sequential_apply(params, x)
        got = pipeline.pipeline_apply(params, x, mesh,
                                      microbatches=PIPE["microbatches"])
        torch.testing.assert_close(got, ref, rtol=PIPE_TOL, atol=PIPE_TOL)
        _all_ranks_equal(got.numpy())
        blocks = {k: sharding.distribute(v, mesh, sharding.P("pipe"))
                  for k, v in params.items()}
        assert all(sharding.partitioned(v) for v in blocks.values())
        again = pipeline.pipeline_apply(blocks, x, mesh,
                                        microbatches=PIPE["microbatches"])
        assert torch.equal(again, got)
        # two microbatches: a longer bubble, the same answer
        two = pipeline.pipeline_apply(params, x, mesh, microbatches=2)
        torch.testing.assert_close(two, ref, rtol=PIPE_TOL, atol=PIPE_TOL)
        rec.arrays["pipeline"] = got.numpy()

    def sharded_lm():
        cfg = smoke(get_config("qwen2-0.5b"))
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        base = tf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        batch = {"tokens": torch.from_numpy(lm_tokens(cfg.vocab_size))}
        want = tf.forward(base, batch, cfg)
        for label, pure_dp in (("fsdp", True), ("tp", False)):
            rules = rules_for(cfg, mesh, global_batch=LM_BATCH,
                              pure_dp=pure_dp)
            if pure_dp:
                assert rules.tensor is None and rules.fsdp == "data"
            else:
                assert rules.batch == ("data",) and rules.tensor == "model"
            model = sharding.shard_module(copy.deepcopy(base), mesh, rules)
            split = [n for n, p in model.named_parameters()
                     if sharding.partitioned(p)]
            assert "embeddings.embed" in split and \
                "blocks.0.0.mix.w_q" in split, (label, split)
            for n, p in model.named_parameters():
                want_spec = sharding.param_pspec(n, tuple(p.shape), rules,
                                                 mesh)
                if n in split:
                    assert list(p.placements) == sharding.placements(
                        mesh, want_spec), (label, n)
            with sharding.use_sharding(mesh, rules):
                got = tf.forward(model, batch, cfg)
            assert not isinstance(got, sharding.DTensor)
            if pure_dp:
                # no tensor axis: the FSDP blocks are gathered whole at
                # use and every product is the whole model's
                assert torch.equal(got, want), label
            else:
                # computed tensor-parallel on the blocks: the partial sums
                # add in another order than the whole model's products
                err = float((got - want).abs().max())
                assert err <= TP_TOL * float(want.abs().max()), err
            rec.arrays[f"lm_sharded_logits_{label}"] = got.numpy()

    for name, fn in (("gpipe", gpipe), ("sharded_lm", sharded_lm)):
        rec.check(name, fn)
    rec.save(out_dir)


# ------------------------------------------------------------ LM training

LM_DP = dict(d_model=64, batch=4, seq=64, lr=1e-2)
LM_LOSS_RTOL = 2e-4      # the reference's bars (tests/test_distributed.py)
LM_PARAM_TOL = 3e-3
LM_ADAFACTOR_PARAM_TOL = 1e-6
# (data, model) meshes; 4x1 is data parallelism alone (the model axis of
# one rank keeps rules_for's expert / tensor axes defined)
LM_DP_MESHES = {"2x2": (2, 2), "4x1": (4, 1)}


def lm_dp_tokens(vocab, seed=2):
    """The DP step's ``[4, 64]`` tokens, numpy seed 2."""
    return np.random.default_rng(seed).integers(
        0, vocab, (LM_DP["batch"], LM_DP["seq"])).astype(np.int64)


def lm_train_case(out_dir, ckpt_dir, ref_ckpt_dir):
    """On 4 ranks: a data-parallel AdamW step of qwen2 and deepseek
    ``smoke()`` on a ``(data 2, model 2)`` and a ``(data 4, model 1)``
    mesh against one rank on the whole batch (and Adafactor's on
    blocks, and the int8 compressor on gradient blocks against whole
    gradients); the LM elastic restore
    (saved whole, restored onto blocks and back, exact); a
    reference-written checkpoint restored onto the mesh and trained one
    step on; the int8 compressed gradient reduction on 4 ranks; the
    trainer's ``--mesh debug`` resume cycle."""
    import copy

    from repro_torch import convert
    from repro_torch.configs import get_config, smoke
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as tf
    from repro_torch.optim.compression import (GradCompressor,
                                               compressed_psum_grads)
    from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer
    from repro_torch.train.train_step import make_train_step

    rec = Record()

    def one_step(model, cfg, batch, step_idx=0, **opt_kw):
        opt = make_optimizer(model, OptimizerConfig(lr=LM_DP["lr"],
                                                    **opt_kw))
        return opt, make_train_step(cfg, opt)(model, step_idx, batch)

    def whole(model):
        return {n: sharding.gather(p.detach()) for n, p in
                model.named_parameters()}

    def dp_against_single(arch, meshes=LM_DP_MESHES,
                          param_tol=LM_PARAM_TOL, **opt_kw):
        cfg = smoke(get_config(arch), d_model=LM_DP["d_model"])
        base = tf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        batch = {"tokens": torch.from_numpy(lm_dp_tokens(cfg.vocab_size))}
        single = copy.deepcopy(base)
        _, want = one_step(single, cfg, batch, **opt_kw)
        want_p = whole(single)
        for label, shape in meshes.items():
            mesh = mesh_mod.make_debug_mesh(*shape, device_type="cpu")
            rules = mesh_mod.rules_for(cfg, mesh,
                                       global_batch=LM_DP["batch"])
            dp = sharding.data_parallel_of(mesh, rules)
            assert dp is not None and dp.ranks == shape[0], (label, dp)
            model = sharding.shard_module(copy.deepcopy(base), mesh, rules)
            assert any(sharding.partitioned(p) for p in model.parameters())
            with sharding.use_sharding(mesh, rules):
                opt, got = one_step(model, cfg, batch, **opt_kw)
            np.testing.assert_allclose(float(got["loss"]),
                                       float(want["loss"]),
                                       rtol=LM_LOSS_RTOL)
            got_p = whole(model)
            worst = max(float((got_p[n] - want_p[n]).abs().max())
                        for n in want_p)
            assert worst < param_tol, (label, worst)
            # the state of a block is a block of the same placement
            for n, p in model.named_parameters():
                if sharding.partitioned(p):
                    m = opt.state[p]["m"]
                    assert list(m.placements) == list(p.placements), n
            for k in want:
                if k.startswith("moe_"):
                    np.testing.assert_allclose(float(got[k]), float(want[k]),
                                               rtol=LM_LOSS_RTOL, atol=1e-7,
                                               err_msg=k)
            _all_ranks_equal(np.array([float(got["loss"]), worst]))
            tag = opt_kw.get("name", "adamw")
            rec.arrays[f"{arch}_{tag}_{label}_loss"] = np.array(
                [float(got["loss"]), float(want["loss"]), worst])

    def adafactor_blocks():
        # factored (row / col) state on blocks: its means reduce over the
        # ranks that split a parameter's last two axes.  Adafactor's first
        # update g / sqrt(vhat + eps) is smooth in g (AdamW's is a sign),
        # so float order moves a parameter by ~lr x 1e-6: a tight bar
        dp_against_single("qwen2-0.5b", {"2x2": (2, 2)},
                          param_tol=LM_ADAFACTOR_PARAM_TOL, name="adafactor",
                          factored_min_dim=16)

    def compressor_blocks():
        # the int8 compressor on gradient blocks scales by the whole
        # tensor's max: bit for bit the compressor on whole gradients
        cfg = smoke(get_config("qwen2-0.5b"), d_model=LM_DP["d_model"])
        mesh = mesh_mod.make_debug_mesh(2, 2, device_type="cpu")
        rules = mesh_mod.rules_for(cfg, mesh, global_batch=LM_DP["batch"])
        model = tf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        rng = np.random.default_rng(7)
        grads = {n: torch.from_numpy(rng.standard_normal(
            tuple(p.shape)).astype(np.float32))
            for n, p in model.named_parameters()}
        comp = GradCompressor(min_size=16)
        want_g, want_e = comp.compress_decompress(grads,
                                                  comp.init_state(grads))
        sharding.shard_module(model, mesh, rules)
        placed = {n: sharding.block_like(
            p, grads[n][sharding._block_slices(
                tuple(p.shape), p.device_mesh, p.placements)].contiguous())
            if sharding.partitioned(p) else grads[n]
            for n, p in model.named_parameters()}
        assert any(sharding.partitioned(g) for g in placed.values())
        state = comp.init_state(dict(model.named_parameters()))
        got_g, got_e = comp.compress_decompress(placed, state)
        for n in grads:
            assert torch.equal(sharding.gather(got_g[n]), want_g[n]), n
            if want_e[n] is not None:
                assert torch.equal(sharding.gather(got_e[n]), want_e[n]), n

    def elastic():
        cfg = smoke(get_config("stablelm-1.6b"), d_model=64)
        model = tf.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
        ckpt.save(ckpt_dir, 7, {"params": convert.lm_tree_to_numpy(model)},
                  extra={"arch": cfg.name})
        assert ckpt.latest_step(ckpt_dir) == 7
        mesh = mesh_mod.make_debug_mesh(2, 2, device_type="cpu")
        rules = mesh_mod.rules_for(cfg, mesh, global_batch=4)
        placed = sharding.shard_module(
            tf.init_params(torch.Generator().manual_seed(9), cfg, "cpu"),
            mesh, rules)
        like = {"params": convert.lm_tree_to_numpy(placed)}
        tree, man = ckpt.restore(ckpt_dir, 7, like, device="cpu")
        assert man["extra"]["arch"] == cfg.name
        convert.load_lm_params(placed, tree["params"])
        assert any(sharding.partitioned(p) for p in placed.parameters())
        want = dict(model.named_parameters())
        for n, p in placed.named_parameters():
            assert torch.equal(sharding.gather(p.detach()), want[n]), n
        # round 2: save the blocks (gathered), restore whole
        ckpt.save(ckpt_dir, 8, {"params": convert.lm_tree_to_numpy(placed)})
        back = tf.init_params(torch.Generator().manual_seed(9), cfg, "cpu")
        tree2, _ = ckpt.restore(ckpt_dir, 8, like, device="cpu")
        convert.load_lm_params(back, tree2["params"])
        for n, p in back.named_parameters():
            assert torch.equal(p, want[n]), n

    def reference_checkpoint():
        cfg = smoke(get_config("qwen2-0.5b"), d_model=LM_DP["d_model"])
        mesh = mesh_mod.make_debug_mesh(2, 2, device_type="cpu")
        rules = mesh_mod.rules_for(cfg, mesh, global_batch=LM_DP["batch"])
        model = sharding.shard_module(
            tf.init_params(torch.Generator().manual_seed(5), cfg, "cpu"),
            mesh, rules)
        opt = make_optimizer(model, OptimizerConfig(lr=LM_DP["lr"]))
        like = {"params": convert.lm_tree_to_numpy(model),
                "opt": convert.lm_tree_to_numpy(opt.state_tree())}
        step, tree, _ = ckpt.restore_latest(ref_ckpt_dir, like, "cpu")
        convert.load_lm_params(model, tree["params"])
        opt.load_state_tree(convert.lm_opt_state_from_numpy(
            tree["opt"], model, "cpu"))
        batch = {"tokens": torch.from_numpy(lm_dp_tokens(cfg.vocab_size,
                                                         seed=6))}
        with sharding.use_sharding(mesh, rules):
            metrics = make_train_step(cfg, opt)(model, step, batch)
        flat = convert._flatten(convert.lm_tree_to_numpy(model))
        rec.arrays.update({f"refckpt.{k}": v for k, v in flat.items()})
        rec.arrays["refckpt_loss"] = np.array([float(metrics["loss"])])

    def compressed():
        mesh = mesh_mod._mesh((4,), ("data",), "cpu")
        w0, batch = compression_inputs()
        params = {"w": torch.from_numpy(w0), "b": torch.zeros(3)}

        def loss(p, x):
            return (torch.tanh(x @ p["w"]) ** 2).mean() + p["b"].sum() * 0

        def grad_fn(p, x):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in p.items()}
            gs = torch.autograd.grad(loss(leaves, x), list(leaves.values()))
            return dict(zip(leaves, gs))

        comp = GradCompressor(min_size=16)
        fn = compressed_psum_grads(grad_fn, mesh, "data", comp)
        ef0 = comp.init_state(params)
        grads, ef = fn(params, torch.from_numpy(batch), ef0)
        ref = grad_fn(params, torch.from_numpy(batch))
        err = float((grads["w"] - ref["w"]).abs().max()
                    / ref["w"].abs().max())
        assert err < 0.05, err
        assert fn.wire_bytes == {"w": 64 * 64 * 2}, fn.wire_bytes
        assert ef["b"] is None and ef["w"].shape == (64, 64)
        _all_ranks_equal(grads["w"].numpy())
        rec.arrays["compressed_w"] = grads["w"].numpy()
        rec.arrays["compressed_err"] = np.array([err])

    def launcher():
        run_dir = os.path.join(ckpt_dir, "trainer")
        base = ["--arch", "qwen2-0.5b", "--batch", "8", "--seq", "64",
                "--ckpt-dir", run_dir, "--ckpt-every", "4", "--mesh",
                "debug", "--log-every", "2", "--device", "cpu"]
        first = train_cli.train(base + ["--steps", "8"])
        assert first.start_step == 0 and sorted(first.losses) == list(
            range(8))
        again = train_cli.train(base + ["--steps", "12"])
        assert again.start_step == 8 and sorted(again.losses) == [8, 9, 10,
                                                                   11]
        assert again.losses[11] < first.losses[0]
        rec.arrays["launcher_losses"] = np.array(
            [first.losses[i] for i in range(8)]
            + [again.losses[i] for i in range(8, 12)])

    for name, fn in (("dp_qwen2", lambda: dp_against_single("qwen2-0.5b")),
                     ("dp_deepseek",
                      lambda: dp_against_single("deepseek-v2-lite-16b")),
                     ("adafactor_blocks", adafactor_blocks),
                     ("compressor_blocks", compressor_blocks),
                     ("elastic", elastic),
                     ("reference_checkpoint", reference_checkpoint),
                     ("compressed", compressed), ("launcher", launcher)):
        rec.check(name, fn)
    rec.save(out_dir)


def compression_inputs():
    """``(w [64, 64], batch [32, 64])`` float32, numpy seeds 0 and 1."""
    w = np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32)
    x = np.random.default_rng(1).standard_normal((32, 64)).astype(np.float32)
    return w, x


# ------------------------------------------------- tensor parallelism

# Smoke variants whose partitioned dimensions divide by 2, or do not
# divide by 4 on purpose (that layer then computes whole on every rank):
# qwen2's 6 heads padded to 8 read 2 kv heads (rank 0's q head 3 reads kv
# head 1 at TP 2; at TP 4 the kv heads stay whole); gemma2's 510-token
# vocab; arctic's 6 experts with sequence parallelism; whisper's d_ff of
# 254; xlstm's 2 mLSTM heads of 64 (TP_SSM), cut to one super-block (5
# mLSTM layers and the sLSTM one): at smoke's two the one-rank port and
# reference are 3.4e-5 of the largest gradient apart, float32 rounding
# that grows ~7e-7 an mLSTM layer, past TP_TOL.  zamba2's 8 Mamba2 heads
# split on both meshes over 2 B / C groups, so at TP 4 rank 1's heads 2
# and 3 read group 0 and rank 2's first head starts group 1.  qwen2 and
# arctic also take remat and two CE chunks.
TP_VARIANTS = {
    "qwen2-padded": ("qwen2-0.5b", dict(n_heads=6, head_pad_to=8,
                                        remat=True, loss_chunk=32)),
    "gemma2": ("gemma2-2b", dict(vocab_size=510, local_window=16)),
    "deepseek": ("deepseek-v2-lite-16b", {}),
    "arctic": ("arctic-480b", dict(seq_parallel=True, remat=True,
                                   loss_chunk=32)),
    "whisper": ("whisper-large-v3", dict(d_ff=254)),
    "zamba2": ("zamba2-1.2b", {}),
    "xlstm": ("xlstm-125m", dict(n_layers=6)),
}
TP_MOE_EXPERTS = {"arctic": 6}
TP_SSM = {"zamba2": dict(n_groups=2), "xlstm": dict(head_dim=64)}
# The sequence lengths at which one apply_slstm's collectives are counted
TP_SLSTM_SEQS = (8, 16)
TP_MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
TP_BATCH, TP_SEQ, TP_DECODE, TP_CACHE = 4, 64, 8, 16
TP_TOL = 2e-5            # of max |value| of the one-rank result
# AdamW's first update is lr * g / (|g| + eps): an entry whose gradient
# is near eps moves by up to lr under any reordering of the float sums,
# so the step's lr keeps that bound inside TP_TOL (the parameters' max
# |value| is at least 1: the norm scales); the check also requires every
# leaf the one-rank step moves to move as far on the mesh.  Since that
# bar is wider than the whole update, the step is also held by what it
# is made of: the gradients the train step hands the optimizer (rows
# split over ``data`` and averaged) within TP_TOL of the one-rank
# step's, and each entry's move (after - before) within TP_MOVE_TOL x lr
# of the one-rank move wherever the one-rank gradient is at least
# TP_MOVE_MIN_G of the largest (there the move is lr x sign(g) to float
# precision, so a flipped sign or a lost entry is off by lr or more).
# TP_MOVE_MIN_G is 10x TP_TOL: a mesh gradient within TP_TOL of the
# largest cannot flip the sign of such an entry.  (At 1e-3 the entries
# held fell to 0.40 on xlstm: its largest gradient, the embedding's
# through a LayerNorm over 0.02-scale embeddings, leaves most of its
# layers' entries under 1e-3 of it.)
TP_LR = 1e-5
TP_MOVE_TOL = 0.05
TP_MOVE_MIN_G = 10 * TP_TOL


def step_gradients(opt) -> dict:
    """The gradients the train step hands ``opt.step``, whole, by name
    (filled when the step runs)."""
    from repro_torch.distributed import sharding
    seen = {}
    inner = opt.step

    def spy(step_idx, grads=None):
        seen.update({n: sharding.gather(g).detach().clone()
                     for n, g in grads.items()})
        return inner(step_idx, grads)

    opt.step = spy
    return seen


def moves_close(got, want, lr, what):
    """Each leaf's move ``got["moves"]`` within ``TP_MOVE_TOL`` x ``lr``
    of ``want["moves"]`` on the entries whose one-rank step gradient
    ``want["step_grads"]`` is at least ``TP_MOVE_MIN_G`` of the largest;
    returns the share of entries held."""
    top = max(float(g.abs().max()) for g in want["step_grads"].values())
    held = total = 0
    for n, g in want["step_grads"].items():
        mask = g.abs() >= TP_MOVE_MIN_G * top
        err = float((got["moves"][n] - want["moves"][n])[mask].abs()
                    .max()) if bool(mask.any()) else 0.0
        assert err <= TP_MOVE_TOL * lr, \
            f"{what} {n}: a move off by {err} past {TP_MOVE_TOL} x {lr}"
        held += int(mask.sum())
        total += mask.numel()
    return held / total


def tp_config(name, mod):
    """The variant ``name`` built from ``mod.smoke(mod.get_config(arch))``
    (``mod``: the port's ``repro_torch.configs`` or the reference's
    ``repro.configs``, which build the same fields)."""
    import dataclasses
    arch, over = TP_VARIANTS[name]
    cfg = dataclasses.replace(mod.smoke(mod.get_config(arch)), **over)
    if name in TP_MOE_EXPERTS:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=TP_MOE_EXPERTS[name]))
    if name in TP_SSM:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, **TP_SSM[name]))
    return cfg


def tp_batch(cfg):
    """Tokens ``[4, 64]`` (+ the audio stub's frames), numpy seed 3."""
    rng = np.random.default_rng(3)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (TP_BATCH, TP_SEQ)).astype(np.int64)}
    if cfg.is_encoder_decoder:
        out["audio_frames"] = rng.standard_normal(
            (TP_BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def tp_case(out_dir, params_dir):
    """On 4 ranks, for each ``TP_VARIANTS`` model (parameters from
    ``params_dir/<name>.npz``, the reference's draw) and each mesh of
    ``TP_MESHES``: the forward logits, ``loss_fn`` and every gradient on
    the whole batch, one AdamW train step (data-parallel over ``data``:
    the gradients it hands the optimizer, the updated parameters, and
    each entry's move by :func:`moves_close`) and ``TP_DECODE`` decode
    steps on a ``kv_seq``-split cache, under
    ``rules_for``'s tensor parallelism with the parameters stored as
    blocks, against the same on one rank (this rank, no mesh), within
    ``TP_TOL`` of the one-rank result's max |value|.  Rank 0 records the
    partitioned results for the reference."""
    from repro_torch import convert
    from repro_torch import configs as port_configs
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_debug_mesh, rules_for
    from repro_torch.models import transformer as tf
    from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer
    from repro_torch.train.train_step import make_train_step

    torch.set_num_threads(1)
    rec = Record()

    def close(got, want, what):
        """Every leaf of ``got`` (a tensor, or a dict of them) within
        ``TP_TOL`` of ``want``'s largest |value| over all its leaves."""
        if not isinstance(want, dict):
            got, want = {"": got}, {"": want}
        top = max(float(w.detach().abs().max()) for w in want.values())
        tol = TP_TOL * max(top, 1e-30)
        for n, w in want.items():
            err = float((got[n].detach().float() - w.detach().float())
                        .abs().max())
            assert err <= tol, f"{what} {n}: max |err| {err} past {tol}"

    def run(model, cfg, batch, mesh=None, rules=None):
        """The results of ``model`` (stored on ``mesh`` per ``rules`` when
        given): logits, (loss, {name: whole gradient}), the decode
        logits, and of one AdamW train step its gradients, the updated
        parameters and their moves."""
        ctx = sharding.use_sharding(mesh, rules) if mesh is not None \
            else contextlib.nullcontext()
        out = {}
        with ctx:
            out["logits"] = tf.forward(model, batch, cfg)
            loss, _ = tf.loss_fn(model, batch, cfg)
            named = list(model.named_parameters())
            gs = torch.autograd.grad(loss, [p for _, p in named],
                                     allow_unused=True)
            out["loss"] = loss.detach()
            out["grads"] = {n: torch.zeros(p.shape) if g is None
                            else sharding.gather(g)
                            for (n, p), g in zip(named, gs)}
            state = tf.init_decode_state(cfg, TP_BATCH, TP_CACHE,
                                         dtype=torch.float32, device="cpu")
            if cfg.is_encoder_decoder:
                state = tf.fill_cross_cache(model, state, batch, cfg)
            steps = []
            for t in range(TP_DECODE):
                lg, state = tf.decode_step(
                    model, state, batch["tokens"][:, t:t + 1], t, cfg)
                steps.append(lg[:, 0])
            out["decode"] = torch.stack(steps, 1)
            before = {n: sharding.gather(p.detach()).clone()
                      for n, p in model.named_parameters()}
            opt = make_optimizer(model, OptimizerConfig(lr=TP_LR))
            out["step_grads"] = step_gradients(opt)
            make_train_step(cfg, opt)(model, 0, batch)
            out["updated"] = {n: sharding.gather(p.detach())
                              for n, p in model.named_parameters()}
            out["moves"] = {n: out["updated"][n] - before[n]
                            for n in before}
            out["moved"] = {n: float(m.abs().max())
                            for n, m in out["moves"].items()}
        return out

    def variant(name):
        cfg = tp_config(name, port_configs)
        with np.load(os.path.join(params_dir, f"{name}.npz")) as z:
            tree = convert._nest(dict(z))
        base = convert.lm_params_from_numpy(tree, cfg, "cpu")
        batch = {k: torch.from_numpy(v) for k, v in tp_batch(cfg).items()}
        want = run(copy.deepcopy(base), cfg, batch)
        for label, shape in TP_MESHES.items():
            mesh = make_debug_mesh(*shape, device_type="cpu")
            rules = rules_for(cfg, mesh, global_batch=TP_BATCH)
            assert sharding.tensor_parallel_of(mesh, rules).size == shape[1]
            model = sharding.shard_module(copy.deepcopy(base), mesh, rules)
            got = run(model, cfg, batch, mesh, rules)
            tag = f"{name}/{label}"
            close(got["logits"], want["logits"], f"{tag} logits")
            close(got["loss"], want["loss"], f"{tag} loss")
            close(got["grads"], want["grads"], f"{tag} gradient")
            close(got["step_grads"], want["step_grads"],
                  f"{tag} train-step gradient")
            close(got["updated"], want["updated"], f"{tag} AdamW update")
            for n, moved in want["moved"].items():
                assert got["moved"][n] >= 0.5 * moved, (tag, n, moved)
            held = moves_close(got, want, TP_LR, f"{tag} AdamW move")
            assert held >= 0.5, (tag, held)
            rec.arrays[f"{tag}/moves_held"] = np.float64(held)
            close(got["decode"], want["decode"], f"{tag} decode")
            _all_ranks_equal(got["logits"].numpy())
            rec.arrays[f"{tag}/logits"] = got["logits"].numpy()
            rec.arrays[f"{tag}/loss"] = got["loss"].numpy()
            rec.arrays[f"{tag}/decode"] = got["decode"].numpy()
            for n, g in got["grads"].items():
                rec.arrays[f"{tag}/grad/{n}"] = g.numpy()

    def stale_split():
        """A decode state made under ``kv_seq`` holds half the slots a
        rank: decoding it with no sharding, or on a model axis of a
        different split, raises at the first slot no rank holds instead
        of dropping the write."""
        cfg = tp_config("qwen2-padded", port_configs)
        model = tf.init_params(torch.Generator().manual_seed(0), cfg,
                               "cpu")
        tokens = torch.from_numpy(tp_batch(cfg)["tokens"])
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        rules = rules_for(cfg, mesh, global_batch=TP_BATCH)
        with sharding.use_sharding(mesh, rules):
            split = tf.init_decode_state(cfg, TP_BATCH, TP_CACHE,
                                         dtype=torch.float32, device="cpu")
        half = TP_CACHE // 2
        assert split["blocks"][0]["0"]["k"].shape[1] == half
        for t in range(half):
            tf.decode_step(model, split, tokens[:, t:t + 1], t, cfg)
        try:
            tf.decode_step(model, split, tokens[:, half:half + 1], half,
                           cfg)
        except ValueError as e:
            assert "past the cache" in str(e), e
        else:
            raise AssertionError("a write past the split cache was dropped")
        wide = make_debug_mesh(1, 4, device_type="cpu")
        with sharding.use_sharding(wide, rules_for(cfg, wide,
                                                   global_batch=TP_BATCH)):
            split = tf.init_decode_state(cfg, TP_BATCH, TP_CACHE,
                                         dtype=torch.float32, device="cpu")
        with sharding.use_sharding(mesh, rules):
            try:
                tf.decode_step(model, split, tokens[:, half:half + 1],
                               half, cfg)
            except ValueError as e:
                assert "past the cache" in str(e), e
            else:
                raise AssertionError("a write no rank holds was dropped")

    def stale_ssm_split():
        """SSM decode states hold the heads of the split they were made
        under: zamba2's (Mamba2) and xlstm's (mLSTM) made under no
        sharding or on ``(1, 4)`` and decoded on ``(2, 2)`` raise before
        the first step computes."""
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        wide = make_debug_mesh(1, 4, device_type="cpu")
        for name in ("zamba2", "xlstm"):
            cfg = tp_config(name, port_configs)
            model = tf.init_params(torch.Generator().manual_seed(0), cfg,
                                   "cpu")
            tokens = torch.from_numpy(tp_batch(cfg)["tokens"])
            for made in (None, wide):
                ctx = sharding.use_sharding(made, rules_for(
                    cfg, made, global_batch=TP_BATCH)) if made is not None \
                    else contextlib.nullcontext()
                with ctx:
                    state = tf.init_decode_state(
                        cfg, TP_BATCH, TP_CACHE, dtype=torch.float32,
                        device="cpu")
                with sharding.use_sharding(mesh, rules_for(
                        cfg, mesh, global_batch=TP_BATCH)):
                    try:
                        tf.decode_step(model, state, tokens[:, :1], 0, cfg)
                    except ValueError as e:
                        assert "under the sharding" in str(e), e
                    else:
                        raise AssertionError(
                            f"{name}: a decode state of another split "
                            "was decoded")

    def slstm_collectives():
        """One ``apply_slstm`` (xlstm's sLSTM layer stored on ``(2, 2)``)
        forward and backward, data-parallel as a train step runs it, at
        each of ``TP_SLSTM_SEQS``: the all-gathers and all-reduces it
        issues, recorded for the test."""
        from repro_torch.models import ssm
        cfg = tp_config("xlstm", port_configs)
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        rules = rules_for(cfg, mesh, global_batch=TP_BATCH)
        layer = sharding.shard_module(ssm.SLSTM(
            torch.Generator().manual_seed(0), cfg, device="cpu"), mesh,
            rules)
        assert sharding.partitioned(layer.w_gates)
        counts = {"gather": 0, "reduce": 0}
        gather, reduce = sharding._all_gather, sharding.all_reduce_sum

        def counted(kind, fn):
            def call(*a, **k):
                counts[kind] += 1
                return fn(*a, **k)
            return call
        sharding._all_gather = counted("gather", gather)
        sharding.all_reduce_sum = counted("reduce", reduce)
        seen = []
        try:
            for seq in TP_SLSTM_SEQS:
                u = torch.from_numpy(np.random.default_rng(seq)
                                     .standard_normal((2, seq, cfg.d_model))
                                     .astype(np.float32))
                counts.update(gather=0, reduce=0)
                with sharding.use_sharding(mesh, rules), \
                        sharding.data_parallel(
                            sharding.data_parallel_of(mesh, rules)):
                    out = ssm.apply_slstm(layer, u, cfg)
                    fwd = counts["gather"]
                    out.square().sum().backward()
                seen.append([fwd, counts["gather"] - fwd, counts["reduce"]])
        finally:
            sharding._all_gather, sharding.all_reduce_sum = gather, reduce
        rec.arrays["slstm/collectives"] = np.array(seen)

    for name in TP_VARIANTS:
        rec.check(name, lambda name=name: variant(name))
    rec.check("stale_split", stale_split)
    rec.check("stale_ssm_split", stale_ssm_split)
    rec.check("slstm_collectives", slstm_collectives)
    rec.save(out_dir)

