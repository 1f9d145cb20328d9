"""Sharded TM training and inference, checkpoint re-sharding, the sharded
stream and the ``--host-devices`` entry points (the port of
``core/tm_distributed.py``, the ``shardings=`` of
``distributed/checkpoint.py`` and the mesh flags of the CLIs).

The multi-rank cases run once on 4 gloo host ranks
(``tests/torch_mesh_cases.py``, rendezvous under ``tmp_path``):
``tm_train_step`` on a ``(data 2, model 2)`` mesh equals the single-device
``train_step_batch`` from the same generator exactly (the config of
``tests/test_distributed.py::test_tm_sharded_matches_single``), and on a
``(1, 4)`` mesh after ``pad_clauses_for_mesh`` (held to the single-device
step on the same padded config); a checkpoint written on 1 rank restores
on 4 and one written on 4 restores on 1; the port of
``tests/test_stream.py::test_streamed_equals_offline_on_sharded_mesh``.
``tm_infer_step`` / ``imbue_infer_step`` and ``pad_clauses_for_mesh``
are held to the reference's in process on numpy inputs: the predictions
are equal, with no mismatch allowed (none of these inputs puts a column
current within rounding of ``v_ref``).
"""

import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_mesh_cases as cases  # noqa: E402
from repro.core import tm as ref_tm  # noqa: E402
from repro.core import tm_distributed as ref_tmd  # noqa: E402
from repro_torch.core import tm  # noqa: E402
from repro_torch.core import tm_distributed as tmd  # noqa: E402
from repro_torch.core import variations as var  # noqa: E402
from repro_torch.core.imbue import IMBUEConfig  # noqa: E402
from repro_torch.distributed import checkpoint as ckpt  # noqa: E402
from repro_torch.launch import hostdev  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import stream as stream_cli  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RANKS = 4


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The cases once on 4 host ranks, after a 1-rank checkpoint save:
    ``(status by check, arrays, checkpoint directory)``."""
    out = tmp_path_factory.mktemp("dist_mesh")
    cfg = tm.TMConfig(**cases.TRAIN_CFG)
    ta = tm.init_ta_state(torch.Generator().manual_seed(1), cfg, "cpu")
    ckpt_dir = out / "ckpt"
    ckpt.save(str(ckpt_dir), 1, {"ta": ta})
    hostdev.run_host_ranks(cases.distributed_case, RANKS,
                           (str(out), str(ckpt_dir)), rdzv_dir=str(out),
                           timeout=300)
    with open(out / "results.json") as f:
        status = json.load(f)
    with np.load(out / "arrays.npz") as z:
        arrays = dict(z)
    return status, arrays, ckpt_dir


def _ok(mesh_run, name):
    assert mesh_run[0][name] == "ok", mesh_run[0][name]


def test_tm_train_step_sharded_matches_single(mesh_run):
    """Clauses over ``model``, rows over ``data``: the sharded step equals
    the single-device step; its inference equals the single-device
    inference and the TM's predict, with rows split over ``data`` too."""
    _ok(mesh_run, "train_2x2")


def test_tm_train_step_on_padded_clauses(mesh_run):
    """6 clauses on a ``(1, 4)`` mesh: ``pad_clauses_for_mesh`` rounds them
    to 12, which split; the step on the padded config equals the
    single-device step on it, and the unpadded state, left whole, still
    trains as one device does."""
    _ok(mesh_run, "train_padded")


def test_checkpoint_restores_across_rank_counts(mesh_run):
    """Saved on 1 rank, restored sharded on 4 (DTensor blocks); saved from
    4 ranks (gathered, rank 0 writes), restored whole on 1: equal
    throughout."""
    _ok(mesh_run, "checkpoint")
    cfg = tm.TMConfig(**cases.TRAIN_CFG)
    ta = tm.init_ta_state(torch.Generator().manual_seed(1), cfg, "cpu")
    back, _ = ckpt.restore(str(mesh_run[2]), 2, {"ta": ta}, device="cpu")
    assert torch.equal(back["ta"], ta)


def test_streamed_equals_offline_on_sharded_mesh(mesh_run):
    """Streamed windows equal offline ``api.predict`` on a sharded R = 8
    pool (``4x1`` and ``2x2``, sync and async) and the single-device
    engine's; at nominal they are the reference's digital TM on the same
    rows and TA state."""
    _ok(mesh_run, "stream")
    arrays = mesh_run[1]
    cfg = ref_tm.TMConfig(n_classes=6, clauses_per_class=6,
                          n_features=arrays["stream_rows"].shape[1],
                          n_states=100)
    want = np.asarray(ref_tm.predict(jnp.asarray(arrays["stream_ta"]),
                                     jnp.asarray(arrays["stream_rows"]),
                                     cfg))
    for key in arrays:
        if key.startswith("stream_") and key not in ("stream_rows",
                                                     "stream_ta"):
            np.testing.assert_array_equal(arrays[key], want, err_msg=key)


def _infer_inputs(seed):
    rng = np.random.default_rng(seed)
    shape = dict(n_classes=4, clauses_per_class=16, n_features=40,
                 n_states=100)
    cfg, ref_cfg = tm.TMConfig(**shape), ref_tm.TMConfig(**shape)
    inc = rng.random((cfg.n_clauses, cfg.n_literals)) < 0.08
    ta = np.where(inc, 101, 100).astype(np.int16)
    x = (rng.random((64, cfg.n_features)) < 0.5).astype(np.uint8)
    return cfg, ref_cfg, inc, ta, x, rng


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tm_infer_step_matches_reference(seed):
    cfg, ref_cfg, _, ta, x, _ = _infer_inputs(seed)
    got = tmd.tm_infer_step(torch.from_numpy(ta), torch.from_numpy(x), cfg)
    want = ref_tmd.tm_infer_step(jnp.asarray(ta), jnp.asarray(x), ref_cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), tm.predict(torch.from_numpy(ta), torch.from_numpy(x),
                                cfg).numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_imbue_infer_step_matches_reference(seed):
    """Conductances of a D2D-drawn crossbar (numpy), bf16 operands with a
    float32 product on both sides: equal predictions."""
    cfg, ref_cfg, inc, _, x, rng = _infer_inputs(seed)
    icfg = IMBUEConfig()
    r_nom = np.where(inc, var.LRS_MEAN_OHM, var.HRS_MEAN_OHM)
    r = (r_nom * np.exp(rng.normal(0, 0.05, inc.shape))).astype(np.float32)
    g = (1.0 / (icfg.series_factor * r)).astype(np.float32)
    leak = (np.where(inc, var.I_LEAK_INCLUDE, var.I_LEAK_EXCLUDE)
            * r_nom / r).astype(np.float32)
    kw = dict(v_read=icfg.v_read, r_div=icfg.r_divider,
              v_ref=icfg.reference_voltage())
    got = tmd.imbue_infer_step(torch.from_numpy(g), torch.from_numpy(leak),
                               torch.from_numpy(inc), torch.from_numpy(x),
                               cfg, **kw)
    want = ref_tmd.imbue_infer_step(jnp.asarray(g), jnp.asarray(leak),
                                    jnp.asarray(inc), jnp.asarray(x),
                                    ref_cfg, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [dict(data=2, model=4),
                                   dict(data=2, model=16),
                                   dict(pod=2, data=16, model=16),
                                   dict(data=8)])
@pytest.mark.parametrize("classes,per_class", [(10, 500), (10, 200),
                                               (3, 2), (2, 8), (7, 6)])
def test_pad_clauses_for_mesh_matches_reference(shape, classes, per_class):
    cfg = tm.TMConfig(n_classes=classes, clauses_per_class=per_class,
                      n_features=12)
    ref_cfg = ref_tm.TMConfig(n_classes=classes, clauses_per_class=per_class,
                              n_features=12)
    got = tmd.pad_clauses_for_mesh(cfg, shape)
    want = ref_tmd.pad_clauses_for_mesh(ref_cfg,
                                        types.SimpleNamespace(shape=shape))
    assert got.clauses_per_class == want.clauses_per_class


def test_tm_shardings_specs():
    """The reference's rule: clauses over ``model`` when they divide it,
    rows over the batch axes when the batch divides them."""
    cfg = tm.TMConfig(n_classes=2, clauses_per_class=8, n_features=12)
    st, x, y = tmd.tm_shardings(cfg, {"data": 2, "model": 4}, 256)
    assert (st.spec, x.spec, y.spec) == ((("model"), None),
                                         (("data",), None), (("data",),))
    st, x, _ = tmd.tm_shardings(cfg, {"data": 3, "model": 5}, 256)
    assert (st.spec, x.spec) == ((None, None), (None, None))


def _rank0_text(capfd):
    return capfd.readouterr().out


def test_serve_cli_on_host_ranks(capfd):
    """``--host-devices 4 --mesh 2x2``: the rank-0 summary names the mesh
    and the plane-packed kernel backend, and the accuracy equals the
    unsharded run's."""
    argv = ["--device", "cpu", "--epochs", "0", "--requests", "32",
            "--replicas", "4", "--nominal", "--routing", "ensemble"]
    assert serve_cli.main(argv + ["--host-devices", str(RANKS),
                                  "--mesh", "2x2"]) == 0
    out = _rank0_text(capfd)
    assert "pool sharded over mesh {'replica': 2, 'batch': 2}" in out
    assert out.count("[serve] training TM") == 1        # rank 0 alone
    assert "backend=analog-cuda-packed2" in out
    whole = serve_cli.main(argv + ["--json"])
    acc = f"analog acc {whole['analog_accuracy']:.3f}"
    assert acc in out, (acc, out)


def test_stream_cli_on_host_ranks(capfd):
    argv = ["--device", "cpu", "--sessions", "4", "--frames", "64",
            "--epochs", "2", "--replicas", "4", "--async-serve",
            "--host-devices", str(RANKS), "--mesh", "2x2"]
    assert stream_cli.main(argv) == 0
    out = _rank0_text(capfd)
    assert "pool sharded over mesh {'replica': 2, 'batch': 2}" in out
    assert out.count("decisions across 4 sessions") == 1


def test_tm_scaleout_example_on_host_ranks():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_tm_scaleout.py"),
         "--device", "cpu", "--host-devices", str(RANKS), "--mesh", "2x2",
         "--epochs", "1", "--train-rows", "512"],
        capture_output=True, text=True, timeout=300,
        env={**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mesh {'data': 2, 'model': 2}" in out.stdout
    assert out.stdout.count("epoch 0: test acc") == 1
    assert "includes:" in out.stdout
