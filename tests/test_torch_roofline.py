"""The port's roofline count (``repro_torch.roofline``) against analytic
counts and against the reference's HLO walker (``repro.roofline``).

* ``StepCost`` counts matrix-product FLOPs exactly (a Python loop is
  unrolled, so every iteration is counted: the counterpart of the
  reference's trip-count tests), 3x under autograd (within 5 %, as the
  reference's ``test_walker_counts_grad_of_scan``), batched einsums, the
  byte rules, and the collectives of a fake group of 4 ranks (in a
  subprocess: the group is process-wide), all-reduce x 2.
* On the reference's ``smoke()`` cells (B = 2, S = 64, float32) the port's
  counted forward FLOPs equal the reference's ``HloCost`` FLOPs exactly,
  and a train step's within 5 % (the two programs' optimizers and
  recomputation differ in a few small products).
* ``report.table`` and ``fmt_s`` render the same text as the reference's
  on the same records.
"""

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

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke as ref_smoke  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.optim import optimizers as ref_optim  # noqa: E402
from repro.roofline import report as ref_report  # noqa: E402
from repro.roofline.analysis import HloCost  # noqa: E402
from repro.train import train_step as ref_train  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.launch import dryrun, shapes  # noqa: E402
from repro_torch.roofline import analysis, report  # noqa: E402
from repro_torch.roofline.analysis import StepCost  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 64
TRAIN_RTOL = 0.05


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chained_matmuls_count_every_iteration():
    x = torch.randn(256, 256)
    ws = torch.randn(8, 256, 256)
    with StepCost() as cost:
        y = x
        for i in range(8):
            y = y @ ws[i]
    assert cost.flops == 2.0 * 8 * 256 ** 3
    assert cost.flops_by_dtype == {"float32": 2.0 * 8 * 256 ** 3}


def test_autograd_counts_forward_and_two_backward_products():
    x = torch.randn(256, 256, requires_grad=True)
    ws = torch.randn(8, 256, 256, requires_grad=True)
    with StepCost() as cost:
        y = x
        for i in range(8):
            y = y @ ws[i]
        (y ** 2).sum().backward()
    assert cost.flops == pytest.approx(3 * 2.0 * 8 * 256 ** 3, rel=0.05)


def test_batched_einsum_flops():
    a, b = torch.randn(4, 32, 64), torch.randn(4, 64, 16)
    with StepCost() as cost:
        torch.einsum("bij,bjk->bik", a, b)
    assert cost.flops == 2 * 4 * 32 * 64 * 16


def test_flops_split_by_dtype():
    a = torch.randn(16, 32, dtype=torch.bfloat16)
    b = torch.randn(32, 8, dtype=torch.bfloat16)
    with StepCost() as cost:
        a @ b
        a.float() @ b.float()
    assert cost.flops_by_dtype == {"bfloat16": 2 * 16 * 32 * 8,
                                   "float32": 2 * 16 * 32 * 8}
    t = analysis.step_times(cost)
    assert t["compute_s"] == pytest.approx(
        2 * 16 * 32 * 8 * (1 / analysis.BF16_FLOPS + 1 / analysis.FP32_FLOPS))


def test_byte_rules():
    t = torch.randn(64, 32)
    with StepCost() as views:
        t.view(32, 64).t()[:10].unsqueeze(0).expand(3, -1, -1).detach()
        torch.empty(100)
    assert views.bytes == 0.0
    idx = torch.tensor([1, 2, 3])
    with StepCost() as sel:
        r = torch.index_select(t, 0, idx)
    assert sel.bytes == 2 * r.numel() * 4          # 2 x the result
    cache = torch.zeros(2, 100, 4, 8)
    upd = torch.randn(2, 1, 4, 8)
    with StepCost() as put:
        cache[:, 5:6] = upd
    assert put.bytes == 2 * upd.numel() * 4
    a, b = torch.randn(10), torch.randn(10)
    with StepCost() as add:
        a + b
    assert add.bytes == 3 * 10 * 4


def test_peak_tracks_live_storages():
    with StepCost() as cost:
        a = torch.randn(1000)
        v = a[:10]
        b = torch.randn(1000)
        del a, b
        c = torch.randn(500)
    assert cost.peak_bytes == 8000      # a and b; the view adds nothing
    assert cost.live_bytes == 2000 + 4000   # c, and a's storage under v
    del v, c
    assert cost.live_bytes == 0


_COLLECTIVES_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.roofline.analysis import StepCost, collective_bytes
    fake_group(4)
    x = torch.randn(128)
    with StepCost() as cost:
        dist.all_gather([torch.empty_like(x) for _ in range(4)], x)
        dist.all_to_all_single(torch.empty_like(x), x)
        dist.all_reduce(x)
        dist.reduce_scatter_tensor(torch.empty(32), x)
        dist.broadcast(x, src=0)
    dist.destroy_process_group()
    json.dump(collective_bytes(cost), open(sys.argv[1], "w"))
""")


def test_collectives_classified_on_a_fake_group(tmp_path):
    out = tmp_path / "coll.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", _COLLECTIVES_SCRIPT,
                          str(out)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    got = json.loads(out.read_text())
    n = 128 * 4
    assert got == {"total": 6 * n, "all-gather": n, "all-to-all": n,
                   "all-reduce": 2 * n, "reduce-scatter": n,
                   "broadcast": n}


# --------------------------------------------- parity with the reference

def _ref_batch(cfg):
    out = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    if cfg.vision_tokens:
        out["vision_embeds"] = jax.ShapeDtypeStruct(
            (B, cfg.vision_tokens, cfg.vision_dim), jnp.float32)
    if cfg.is_encoder_decoder:
        out["audio_frames"] = jax.ShapeDtypeStruct(
            (B, cfg.encoder_seq, cfg.d_model), jnp.float32)
    return out


def _meta_batch(cfg):
    meta = shapes.META
    out = {"tokens": torch.empty((B, S), dtype=torch.int64, device=meta)}
    if cfg.vision_tokens:
        out["vision_embeds"] = torch.empty(
            (B, cfg.vision_tokens, cfg.vision_dim), device=meta)
    if cfg.is_encoder_decoder:
        out["audio_frames"] = torch.empty(
            (B, cfg.encoder_seq, cfg.d_model), device=meta)
    return out


def _ref_params(cfg):
    return jax.eval_shape(lambda k: ref_tf.init_params(k, cfg),
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma2-2b",
                                  "deepseek-v2-lite-16b", "whisper-large-v3",
                                  "internvl2-76b"])
def test_forward_flops_equal_reference_hlo(arch):
    from repro_torch.models import transformer as tf
    cfg = ref_smoke(ref_get_config(arch))
    compiled = jax.jit(lambda p, b: ref_tf.forward(p, b, cfg)).lower(
        _ref_params(cfg), _ref_batch(cfg)).compile()
    want = HloCost(compiled.as_text()).flops
    pcfg = smoke(get_config(arch))
    model = shapes.abstract_params(pcfg)
    with StepCost() as cost:
        tf.forward(model, _meta_batch(pcfg), pcfg)
    assert cost.flops == want


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v2-lite-16b"])
def test_train_step_flops_near_reference_hlo(arch):
    cfg = ref_smoke(ref_get_config(arch))
    opt = ref_optim.make_optimizer(ref_optim.OptimizerConfig(name="adamw"))
    params = _ref_params(cfg)
    compiled = jax.jit(ref_train.make_train_step(cfg, opt)).lower(
        params, jax.eval_shape(opt.init, params),
        jax.ShapeDtypeStruct((), jnp.int32), _ref_batch(cfg)).compile()
    want = HloCost(compiled.as_text()).flops
    pcfg = smoke(get_config(arch))
    cost, mem, _ = dryrun.count_step(dryrun.build_step(
        pcfg, "train", shapes.abstract_params(pcfg), _meta_batch(pcfg)))
    assert cost.flops == pytest.approx(want, rel=TRAIN_RTOL)
    assert mem["optimizer_bytes"] == 2 * mem["params_bytes"]   # AdamW m, v


RECORDS = [
    {"arch": "qwen2-0.5b", "shape": "train_4k", "mesh": "data=16xmodel=16",
     "compute_s": 0.0915, "memory_s": 1.2e-4, "collective_s": 0.0,
     "dominant": "compute", "useful_ratio": 0.0623},
    {"arch": "arctic-480b", "shape": "decode_32k",
     "mesh": "pod=2xdata=16xmodel=16", "compute_s": 3.1e-7,
     "memory_s": 2.5, "collective_s": 0.4, "dominant": "memory",
     "useful_ratio": 1.0},
]


def test_report_table_matches_reference():
    for mesh in ("single", "multi"):
        assert report.table(RECORDS, mesh) == ref_report.table(RECORDS, mesh)
    for x in (0, 3e-7, 5e-4, 0.25, 12.5):
        assert report.fmt_s(x) == ref_report.fmt_s(x)
