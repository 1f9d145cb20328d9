"""The port's dry run (``repro_torch.launch.shapes``, ``launch.dryrun``)
against the reference's (``repro.launch.shapes``, ``repro.launch.dryrun``).

* The cell tables equal the reference's value for value: ``SHAPES``,
  ``LM_ARCHS``, ``applicable``, ``cells(include_skipped=True)``,
  ``cell_config`` field by field, ``TRAIN_MICROBATCHES``,
  ``PURE_DP_ARCHS`` and the TM cells.
* At the published widths of every arch (``jax.eval_shape`` on the
  reference, the ``meta`` device on the port, nothing allocated): the
  abstract parameters have the reference's leaf shapes and dtypes under
  ``convert``'s name map; ``model_flops_per_step`` equals the reference's
  exactly for all four kinds; the abstract decode state has the
  reference's shapes and dtypes (bf16); the input specs the reference's
  shapes (token ids int64, a recorded difference: int32 there).
* The traced cells, on torch's in-process fake process group, in one
  subprocess (the group is process-wide): ``trace_cell`` of a ``smoke()``
  arch on a ``(2, 2)`` mesh for each kind (at batch 8 x 128) returns a
  complete record with collectives counted; under ``pure_dp`` rules (no
  tensor axis) a rank counts exactly the no-mesh step on its quarter of
  the batch, and under the default rules (tensor parallelism) at most
  0.55x the matrix-product FLOPs of the same step on ``(2, 1)``, for
  qwen2 and for zamba2 (Mamba2 split on ``model``); the TM
  cells at their own shapes too, and ``main`` on ``--mesh both`` (256 then 512 ranks) writes
  the reference's JSON layout.  The full widths and shapes run on the
  card's host (``chip_smoke.py``'s ``roofline`` path).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

# The reference's dry run sets XLA_FLAGS to 512 host devices when it is
# imported; restore them, so that no test in this worker sees 512 devices.
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_dryrun  # noqa: E402
if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS
from repro.launch import shapes as ref_shapes  # noqa: E402
from repro.roofline.analysis import \
    model_flops_per_step as ref_model_flops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import dryrun, shapes  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ref_shapes.LM_ARCHS
KINDS = ("train", "prefill", "decode")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cell_tables_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_shapes.SHAPES.items()}
    assert shapes.LM_ARCHS == ref_shapes.LM_ARCHS
    assert shapes.cells(include_skipped=True) == \
        ref_shapes.cells(include_skipped=True)
    assert shapes.cells() == ref_shapes.cells()
    for arch in ARCHS:
        for shape in shapes.SHAPES:
            assert shapes.applicable(arch, shape) == \
                ref_shapes.applicable(arch, shape)
            assert dataclasses.asdict(shapes.cell_config(arch, shape)) == \
                dataclasses.asdict(ref_shapes.cell_config(arch, shape))
    assert shapes.TRAIN_MICROBATCHES == ref_shapes.TRAIN_MICROBATCHES
    assert shapes.PURE_DP_ARCHS == ref_shapes.PURE_DP_ARCHS
    assert dryrun.TM_SHAPES == ref_dryrun.TM_SHAPES
    assert dryrun.TM_CELL_ARCHS == ref_dryrun.TM_CELL_ARCHS


def _ref_flat(tree):
    return convert._flatten(jax.tree.map(lambda a: a, tree))


def _port_vs_ref(port_flat, ref_flat):
    """Port leaves ``{path: (shape, dtype name)}`` mapped onto the
    reference's stacked paths: every reference leaf covered, every port
    leaf the reference's row (a superblock's) or leaf."""
    covered = set()
    for path, (shape, dtype) in port_flat.items():
        ref_path, row = convert._reference_leaf(path)
        want = ref_flat[ref_path]
        want_shape = tuple(want.shape[1:] if row is not None else want.shape)
        assert shape == want_shape, path
        assert dtype == str(want.dtype), path
        covered.add(ref_path)
    assert covered == set(ref_flat)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_model_flops_match_reference(arch):
    cfg = ref_shapes.cell_config(arch, "train_4k")
    ref_params = ref_shapes.abstract_params(cfg)
    model = shapes.abstract_params(shapes.cell_config(arch, "train_4k"))
    assert all(p.is_meta for p in model.parameters())
    _port_vs_ref({n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
                  for n, p in model.named_parameters()},
                 _ref_flat(ref_params))
    for shape, spec in shapes.SHAPES.items():
        for kind in KINDS:
            assert analysis.model_flops_per_step(
                cfg, model, kind, spec.global_batch, spec.seq) == \
                ref_model_flops(cfg, ref_params, kind, spec.global_batch,
                                spec.seq), (kind, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_decode_state_and_inputs_match_reference(arch):
    shape = "decode_32k"
    cfg = ref_shapes.cell_config(arch, shape)
    pcfg = shapes.cell_config(arch, shape)
    state = shapes.abstract_decode_state(pcfg, shape)
    port = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in convert._flatten(state).items()}
    assert all(t.is_meta for t in convert._flatten(state).values())
    _port_vs_ref(port, _ref_flat(ref_shapes.abstract_decode_state(cfg,
                                                                 shape)))
    for s in ("train_4k", shape):
        want = ref_shapes.input_specs(cfg, s)
        got = shapes.input_specs(pcfg, s)
        assert set(got) == set(want)
        for k, v in want.items():
            if k == "pos":
                assert got[k] == 0
                continue
            assert tuple(got[k].shape) == tuple(v.shape), k
            assert got[k].dtype == (torch.int64 if v.dtype == jnp.int32
                                    else torch.float32), k


_TRACE_SCRIPT = textwrap.dedent("""
    import contextlib, json, sys
    from repro_torch.configs import smoke
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun, shapes
    from repro_torch.launch.mesh import make_debug_mesh, rules_for
    full = shapes.get_config
    shapes.get_config = lambda arch: smoke(full(arch))
    # the cells' kinds at a small batch and sequence: what the trace
    # checks is the same, and its Python loops (attention blocks, chunked
    # losses) take seconds instead of minutes on the host
    shapes.SHAPES = {k: shapes.ShapeSpec(k, v.kind, 128,
                                         min(v.global_batch, 8))
                     for k, v in shapes.SHAPES.items()}
    ARCH = "qwen2-0.5b"
    SSM = "zamba2-1.2b"
    lm = ("train_4k", "prefill_32k", "decode_32k")

    def counted(shape, mesh=None, pure_dp=False):
        cfg = shapes.cell_config(ARCH, shape)
        spec = shapes.SHAPES[shape]
        rules = rules_for(cfg, mesh, global_batch=spec.global_batch,
                          pure_dp=pure_dp) if mesh is not None else None
        with sharding.use_sharding(mesh, rules) if mesh is not None \\
                else contextlib.nullcontext():
            cost, mem, _ = dryrun.count_step(dryrun.build_step(
                cfg, spec.kind, shapes.abstract_params(cfg),
                shapes.input_specs(cfg, shape),
                state=shapes.abstract_decode_state(cfg, shape)
                if spec.kind == "decode" else None, mesh=mesh, rules=rules,
                microbatches=shapes.TRAIN_MICROBATCHES.get(ARCH, 1)
                if spec.kind == "train" else 1))
        return {"flops": cost.flops, "bytes": cost.bytes,
                "args_bytes": mem["args_bytes"]}

    out = {}
    dryrun.fake_group(4)
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    for shape in lm:
        out[shape] = dryrun.trace_cell(ARCH, shape, mesh, verbose=False)
        out[SSM + ":" + shape] = dryrun.trace_cell(SSM, shape, mesh,
                                                   verbose=False)
        # pure data parallelism: the model axis folds into the batch
        out[shape + ":pure_dp"] = counted(shape, mesh, pure_dp=True)
    for shape in dryrun.TM_SHAPES:
        out[shape] = dryrun.trace_tm_cell("imbue-tm-mnist", shape, mesh,
                                          verbose=False)
    out["main"] = dryrun.main(["--arch", "deepseek-v2-lite-16b", "--shape",
                               "train_4k", "--mesh", "both", "--out",
                               sys.argv[1] + ".main"])
    # the same steps with a model axis of one rank
    dryrun.fake_group(2)
    one = make_debug_mesh(2, 1, device_type="cpu")
    for shape in lm:
        out[shape + ":2x1"] = dryrun.trace_cell(ARCH, shape, one,
                                                verbose=False)
        out[SSM + ":" + shape + ":2x1"] = dryrun.trace_cell(
            SSM, shape, one, verbose=False)
    # what a pure-DP rank should count: the same step with no mesh, on
    # its quarter of the batch (4 batch ranks)
    shapes.SHAPES = {k: shapes.ShapeSpec(k, v.kind, v.seq,
                                         v.global_batch // 4)
                     for k, v in shapes.SHAPES.items()}
    for shape in lm:
        out[shape + ":rank_rows"] = counted(shape)
    json.dump(out, open(sys.argv[1], "w"))
""")

RECORD_KEYS = {"arch", "shape", "mesh", "devices", "kind", "hlo_flops",
               "hlo_bytes", "collective_bytes", "per_device",
               "flops_by_dtype", "compute_s", "memory_s", "collective_s",
               "dominant", "model_flops", "useful_ratio", "collective_ops",
               "memory_analysis", "trace_s"}


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "traced.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", _TRACE_SCRIPT, str(out)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_trace_cell_on_a_fake_mesh(traced, shape):
    rec = traced[shape]
    assert set(rec) == RECORD_KEYS
    assert rec["mesh"] == "data=2xmodel=2" and rec["devices"] == 4
    assert rec["kind"] == shapes.SHAPES[shape].kind
    per = rec["per_device"]
    assert per["flops"] > 0 and per["bytes"] > 0
    assert rec["hlo_flops"] == 4 * per["flops"]
    # FSDP blocks are gathered whole at use
    assert rec["collective_ops"]["all-gather"] > 0
    if shape == "train_4k":      # the gradients' means over the data axis
        assert rec["collective_ops"]["all-reduce"] > 0
    mem = rec["memory_analysis"]
    assert mem["peak_bytes"] > mem["params_bytes"] > 0
    # under pure data parallelism (no tensor axis) a rank counts its own
    # rows: exactly the FLOPs and the argument bytes of the same step run
    # with no mesh on the rank's quarter of the batch
    pure, alone = traced[shape + ":pure_dp"], traced[shape + ":rank_rows"]
    assert pure["flops"] == alone["flops"]
    assert pure["args_bytes"] == alone["args_bytes"]
    assert rec["model_flops"] > 0 and rec["compute_s"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_tensor_parallel_splits_a_ranks_matmuls(traced, shape):
    """Under the default rules (heads, MLP, vocab and the decode cache's
    sequence on ``model``) qwen2's ``smoke()``, whose partitioned
    dimensions all divide by 2, counts at most 0.55x the matrix-product
    FLOPs a rank on ``(2, 2)`` that the same step counts on ``(2, 1)``,
    and its tensor-parallel all-reduces show on ``(2, 2)`` alone.  So
    does zamba2's, whose 8 Mamba2 heads split with its shared attention,
    MLP and vocab (only B / C and their conv stay whole)."""
    for prefix in ("", "zamba2-1.2b:"):
        tp, one = traced[prefix + shape], traced[prefix + shape + ":2x1"]
        assert one["mesh"] == "data=2xmodel=1"
        assert tp["per_device"]["flops"] <= \
            0.55 * one["per_device"]["flops"], (prefix, tp["per_device"],
                                                one["per_device"])
        assert tp["collective_ops"]["all-reduce"] > \
            one["collective_ops"].get("all-reduce", 0.0)


@pytest.mark.parametrize("shape", sorted(dryrun.TM_SHAPES))
def test_trace_tm_cell_on_a_fake_mesh(traced, shape):
    rec = traced[shape]
    assert set(rec) == RECORD_KEYS | {"counted"}
    assert rec["counted"] == "plain versions"
    assert rec["kind"] == "tm_" + dryrun.TM_SHAPES[shape][0]
    assert rec["memory_s"] > 0 and rec["model_flops"] > 0
    # the clause blocks' partial sums meet in an all-reduce over "model"
    assert rec["collective_ops"]["all-reduce"] > 0


def test_main_writes_the_reference_layout_on_both_meshes(traced):
    out = traced["main"]
    assert set(out) == {"results", "failures", "skipped"}
    assert out["failures"] == []
    assert [r["mesh"] for r in out["results"]] == [
        "data=16xmodel=16", "pod=2xdata=16xmodel=16"]
    assert [r["devices"] for r in out["results"]] == [256, 512]
    assert out["skipped"] == [
        {"arch": a, "shape": s, "reason": why}
        for a, s, ok, why in ref_shapes.cells(include_skipped=True)
        if not ok]
