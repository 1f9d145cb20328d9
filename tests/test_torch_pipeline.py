"""The GPipe demo (``repro_torch.distributed.pipeline``) and the LM
sharding rules (``launch.mesh.rules_for``, ``make_production_mesh``).

The multi-rank cases run once on 4 gloo host ranks
(``tests/torch_mesh_cases.py``, rendezvous under ``tmp_path``): the
pipelined forward on a ``(pipe 4,)`` mesh equals ``sequential_apply``
within rtol = atol = 2e-5 (the bar of the reference's
``tests/test_distributed.py::test_pipeline_parallel_demo``), and the qwen2
``smoke()`` forward with its parameters stored as blocks per
``rules_for`` on a ``(data 2, model 2)`` mesh equals the whole model's.
Here: the ranks' pipelined output against the reference's
``sequential_apply`` on the same numpy weights, ``rules_for`` against the
reference's on the same mesh sizes, and the demo's entry point under
``torch.distributed.run``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import torch_mesh_cases as cases  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.distributed import pipeline as ref_pipeline  # noqa: E402
from repro.launch import mesh as ref_mesh  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.distributed import pipeline  # noqa: E402
from repro_torch.launch import hostdev, mesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RANKS = 4


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The cases once on 4 host ranks: ``(status by check, arrays)``."""
    out = tmp_path_factory.mktemp("pipeline_mesh")
    hostdev.run_host_ranks(cases.pipeline_case, RANKS, (str(out),),
                           rdzv_dir=str(out), timeout=300)
    with open(out / "results.json") as f:
        status = json.load(f)
    with np.load(out / "arrays.npz") as z:
        arrays = dict(z)
    return status, arrays


def _ok(mesh_run, name):
    assert mesh_run[0][name] == "ok", mesh_run[0][name]


def test_pipeline_equals_sequential_and_the_reference(mesh_run):
    """On 4 ranks, whole and partitioned stage weights, 4 and 2
    microbatches: pipelined == sequential within 2e-5, every rank the
    same; and the ranks' output against the reference's
    ``sequential_apply`` on the same numpy weights."""
    _ok(mesh_run, "gpipe")
    params, x = cases.pipeline_params()
    want = ref_pipeline.sequential_apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    np.testing.assert_allclose(mesh_run[1]["pipeline"], np.asarray(want),
                               rtol=cases.PIPE_TOL, atol=cases.PIPE_TOL)


def test_sequential_apply_matches_reference():
    params, x = cases.pipeline_params()
    got = pipeline.sequential_apply(
        convert.pipeline_params_from_numpy(params, "cpu"),
        torch.from_numpy(x))
    want = ref_pipeline.sequential_apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="w1 and w2"):
        convert.pipeline_params_from_numpy({"w1": params["w1"]}, "cpu")


def test_pipeline_rejects_a_batch_that_does_not_split():
    params, x = cases.pipeline_params()
    t = convert.pipeline_params_from_numpy(params, "cpu")
    with pytest.raises(ValueError, match="microbatches"):
        pipeline.pipeline_apply(t, torch.from_numpy(x), {"pipe": 4},
                                microbatches=3)


def test_init_pipeline_params_shapes_and_scale():
    p = pipeline.init_pipeline_params(torch.Generator().manual_seed(0), 4,
                                      64, "cpu")
    assert p["w1"].shape == (4, 64, 256) and p["w2"].shape == (4, 256, 64)
    assert abs(float(p["w1"].std()) * 64 ** 0.5 - 1.0) < 0.02
    assert abs(float(p["w2"].std()) * 256 ** 0.5 - 1.0) < 0.02


def test_sharded_lm_forward_equals_unsharded(mesh_run):
    """qwen2 ``smoke()`` on a ``(data 2, model 2)`` mesh, its partitioned
    parameters (embed, q/k/v/o, MLP) held as DTensor blocks.  Under
    ``rules_for(..., pure_dp=True)`` (no tensor axis: the FSDP blocks
    gathered whole at use) the logits equal the whole model's exactly;
    under the default rules (each rank computing its heads, hidden units
    and vocab block: tensor parallelism) within ``TP_TOL`` = 2e-5 of its
    max |logit| (the ranks' partial sums add in another order); here as
    on the ranks."""
    _ok(mesh_run, "sharded_lm")
    cfg = smoke(get_config("qwen2-0.5b"))
    model = tf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    want = tf.forward(model, {"tokens": torch.from_numpy(
        cases.lm_tokens(cfg.vocab_size))}, cfg).numpy()
    np.testing.assert_array_equal(mesh_run[1]["lm_sharded_logits_fsdp"],
                                  want)
    err = float(np.abs(mesh_run[1]["lm_sharded_logits_tp"] - want).max())
    assert err <= cases.TP_TOL * float(np.abs(want).max()), err


MESHES = [{"data": 2, "model": 2}, {"data": 2, "model": 4},
          {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"pipe": 4}]


@pytest.mark.parametrize("shape", MESHES, ids=[str(m) for m in MESHES])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "arctic-480b"])
def test_rules_for_matches_reference(shape, arch):
    """Every combination of global batch (none, dividing, not dividing)
    and ``pure_dp``, with and without sequence parallelism."""
    for seq_parallel in (False, True):
        cfg = dataclasses.replace(get_config(arch),
                                  seq_parallel=seq_parallel)
        rcfg = dataclasses.replace(ref_get_config(arch),
                                   seq_parallel=seq_parallel)
        for gb in (None, 512, 3):
            for pure_dp in (False, True):
                got = mesh.rules_for(cfg, shape, global_batch=gb,
                                     pure_dp=pure_dp)
                want = ref_mesh.rules_for(
                    rcfg, types.SimpleNamespace(shape=dict(shape)),
                    global_batch=gb, pure_dp=pure_dp)
                assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                    (gb, pure_dp, seq_parallel)


def test_production_mesh_needs_its_ranks():
    with pytest.raises(ValueError, match="256 ranks"):
        mesh.make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        mesh.make_production_mesh(multi_pod=True, device_type="cpu")


def test_pipeline_demo_under_torch_distributed_run():
    """The demo's entry point on 2 ranks, as ``chip_smoke.py`` runs it on
    4 sharing the card: one JSON line, pipelined equal to sequential."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.distributed.pipeline",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    line = json.loads([ln for ln in run.stdout.splitlines()
                       if ln.startswith("{")][-1])
    assert line["stages"] == 2 and line["ticks"] == 5
    assert line["equal_to_sequential"] and line["max_abs_err"] <= 2e-5
