"""The port stands alone and never falls back to the host quietly.

* An AST scan of ``src/repro_torch/**`` and ``chip_smoke.py`` finds no
  import of ``jax`` or of the reference package ``repro``.
* Entry points called with no ``device`` on a machine without CUDA raise
  (CUDA is hidden with monkeypatch, so this holds on any machine).
* ``chip_smoke.py`` exits non-zero and prints no result without CUDA, and
  in a directory that holds nothing else of the repository.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import (booleanize, coalesced, imbue, tm,  # noqa: E402
                              variations)
from repro_torch.data import tm_datasets  # noqa: E402
from repro_torch.distributed import checkpoint  # noqa: E402
from repro_torch.train import online  # noqa: E402
from repro_torch.core.imbue import IMBUEConfig  # noqa: E402
from repro_torch.kernels import bitpack, flash_attention, ops  # noqa: E402
from repro_torch.launch import stream as stream_cli  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
CFG = tm.TMConfig(n_classes=2, clauses_per_class=4, n_features=5)


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_reference(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_scan_covers_the_port():
    names = {p.name for p in PORT_FILES}
    assert {"engine.py", "ops.py", "imbue_infer.py", "clause_eval.py",
            "coalesced.py", "tm_train.py", "online.py", "checkpoint.py",
            "tm_datasets.py", "flash_attention.py", "booleanize.py",
            "stream.py", "chip_smoke.py"} <= names
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} >= {
        "imbue_infer_planes.cu", "imbue_infer_packed.cu", "imbue_infer.cu",
        "tm_infer_planes.cu", "tm_infer_packed.cu", "tm_infer.cu",
        "clause_eval_packed.cu", "clause_eval.cu", "flash_fwd.cu",
        "flash_bwd_dkv.cu", "flash_bwd_dq.cu"}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_pool_args():
    rng = np.random.default_rng(0)
    inc = rng.random((CFG.n_clauses, CFG.n_literals)) < 0.3
    r = np.where(inc, variations.LRS_MEAN_OHM,
                 variations.HRS_MEAN_OHM)[None].astype(np.float32)
    return r, inc


def test_entry_points_raise_without_device_and_cuda(no_cuda):
    r, inc = _tiny_pool_args()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.pool_from_numpy(r, inc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.ta_from_numpy(np.ones(inc.shape, np.int16), CFG)
    pool = convert.pool_from_numpy(
        r, inc, vcfg=variations.VariationConfig.nominal(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.ServeEngine(pool, CFG)
    ta = torch.ones(inc.shape, dtype=torch.int16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.ServeEngine.from_ta_state(ta, CFG)
    lits = torch.ones(3, CFG.n_literals, dtype=torch.uint8)
    litw = bitpack.pack_bits(lits)
    inc_t = torch.from_numpy(inc)
    idx = bitpack.pack_bits(inc_t)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.imbue_class_sums_planes(litw, idx, None, IMBUEConfig(), CFG,
                                    l_valid=CFG.n_literals)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.imbue_class_sums_stack_planes(litw, idx, None, IMBUEConfig(),
                                          CFG, l_valid=CFG.n_literals,
                                          n_replicas=2)
    g = torch.ones(2, CFG.n_clauses, CFG.n_literals)
    dense = {"imbue_class_sums_stack": (lits, g, inc_t, IMBUEConfig(), CFG),
             "imbue_class_sums_stack_packed": (litw, g, inc_t, IMBUEConfig(),
                                               CFG)}
    for name, args in dense.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(ops, name)(*args)
        assert getattr(ops, name)(*args, device="cpu").shape == (
            2, 3, CFG.n_classes)
    raw = (g[0], g[0], inc_t, 0.2, 100.0, 0.007, CFG)
    for name, lit in (("imbue_class_sums_raw", lits),
                      ("imbue_class_sums_raw_packed", litw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(ops, name)(lit, *raw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.crossbar_state_from_numpy(r[0], inc, CFG)
    # With device="cpu" the same calls run on the plain versions.
    out = ops.imbue_class_sums_stack_planes(
        litw, idx, None, IMBUEConfig(), CFG, l_valid=CFG.n_literals,
        n_replicas=2, device="cpu")
    assert out.shape == (2, 3, CFG.n_classes)
    eng = engine.ServeEngine(pool, CFG, device="cpu")
    assert eng.device.type == "cpu"


def test_coalesced_entry_points_raise_without_device_and_cuda(no_cuda):
    ccfg = coalesced.CoalescedConfig(n_classes=2, n_clauses=4, n_features=5)
    dcfg = tm.TMConfig(n_classes=2, clauses_per_class=2, n_features=5)
    ta = np.full((4, 10), ccfg.n_states + 1, np.int16)
    w = np.ones((4, 2), np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.coalesced_pool_from_numpy(ta, w, ccfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.ServeEngine.from_coalesced(torch.from_numpy(ta),
                                          torch.from_numpy(w), ccfg)
    pool = convert.coalesced_pool_from_numpy(ta, w, ccfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.ServeEngine(pool, ccfg)
    lits = torch.ones(3, 10, dtype=torch.uint8)
    inc = torch.from_numpy(ta > ccfg.n_states)
    litw, incw = bitpack.pack_bits(lits), bitpack.pack_bits(inc)
    combs = (ops.coalesced_combine(torch.from_numpy(w), inc.any(-1)),
             ops.polarity_matrix(dcfg, inc))
    calls = {
        "tm_class_sums_planes": (litw, incw),
        "tm_class_sums_packed": (litw, incw),
        "tm_class_sums": (lits, inc),
    }
    for comb in combs:
        for name, args in calls.items():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                getattr(ops, name)(*args, comb)
            assert getattr(ops, name)(*args, comb, device="cpu").shape == (
                3, 2)
    eng = engine.ServeEngine.from_coalesced(
        torch.from_numpy(ta), torch.from_numpy(w), ccfg, device="cpu")
    assert eng.device.type == "cpu"


def test_training_entry_points_raise_without_device_and_cuda(no_cuda,
                                                            tmp_path):
    gen = torch.Generator()
    ccfg = coalesced.CoalescedConfig(n_classes=2, n_clauses=4, n_features=5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init_ta_state(gen, CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        coalesced.init_coalesced(gen, ccfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm_datasets.noisy_xor(gen, 4, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm_datasets.synthetic_image_dataset(gen, 2, 4, 4, side=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        online.OnlineTrainer(CFG, gen)
    lits = torch.ones(3, CFG.n_literals, dtype=torch.uint8)
    inc = torch.zeros(CFG.n_clauses, CFG.n_literals, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.clause_eval(lits, inc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.clause_eval_packed(ops.pack_literals(lits), ops.pack_include(inc))
    checkpoint.save(str(tmp_path), 1, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        checkpoint.restore(str(tmp_path), 1, {"w": None})
    # With device="cpu" they run on the plain versions.
    assert ops.clause_eval(lits, inc, device="cpu").shape == (
        3, CFG.n_clauses)
    assert tm.init_ta_state(gen, CFG, "cpu").device.type == "cpu"
    assert online.OnlineTrainer(CFG, gen, device="cpu").device.type == "cpu"


def test_stream_and_montecarlo_entry_points_raise_without_device_and_cuda(
        no_cuda):
    gen = torch.Generator()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm_datasets.synthetic_kws6(gen, 2, 8, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm_datasets.synthetic_sensor_anomaly(gen, 2, 8, 2, burst_frames=4)
    frames = np.linspace(0.0, 1.0, 24, dtype=np.float32).reshape(6, 4)
    for fit in (booleanize.fit_quantile, booleanize.fit_uniform):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fit(frames, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.booleanizer_from_numpy(np.zeros((4, 2), np.float32))
    ta = torch.full((CFG.n_clauses, CFG.n_literals), CFG.n_states + 1,
                    dtype=torch.int16)
    x = torch.ones(3, CFG.n_features, dtype=torch.uint8)
    y = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        imbue.monte_carlo_accuracy(ta, x, y, gen, CFG, draws=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        imbue.clause_error_rate(ta, x, gen, CFG, draws=2)
    r = torch.full((2, CFG.n_clauses, CFG.n_literals), 1.64e3)
    inc = tm.include_mask(ta, CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        imbue.stacked_class_sums(r, inc, x, CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stream_cli.main(["--sessions", "1", "--frames", "16"])
    # With device="cpu" they run on the plain versions.
    assert imbue.monte_carlo_accuracy(
        ta, x, y, gen, CFG, variations.VariationConfig.nominal(), draws=2,
        device="cpu").shape == (2,)
    assert imbue.stacked_class_sums(r, inc, x, CFG, device="cpu").shape == (
        2, 3, CFG.n_classes)
    b = booleanize.fit_quantile(frames, 2, device="cpu")
    assert b.transform(frames).shape == (6, 8)


def test_flash_wrappers_take_only_cpu_or_cuda_tensors():
    """The flash entry points run where their tensors lie: the plain
    versions for CPU tensors, the kernels for CUDA ones, and nothing else
    (here: the meta device) quietly."""
    q, k, v = (torch.zeros(1, 8, 1, 32, device="meta") for _ in range(3))
    stats = torch.zeros(1, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention.flash_bwd_dkv(q, k, v, q, stats, stats)
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention.flash_bwd_dq(q, k, v, q, stats, stats)
    cpu = [torch.zeros(t.shape) for t in (q, k, v)]
    assert flash_attention.flash_attention(*cpu).device.type == "cpu"


def _run_smoke(cwd: Path):
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_cuda_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    here = _run_smoke(ROOT)
    assert here.returncode != 0
    assert '"ok": true' not in here.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = _run_smoke(tmp_path)
    assert alone.returncode != 0
    assert '"ok": true' not in alone.stdout
