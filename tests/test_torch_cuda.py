"""CUDA-only checks of the port's kernels: each kernel against its plain
PyTorch version on the card, at ragged shapes, with its launch counter
moving by one per call.  Marked ``cuda``; they skip (with a reason)
on a machine without a CUDA device.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.api.states import _deviation_plane  # noqa: E402
from repro_torch.core import tm  # noqa: E402
from repro_torch.core.imbue import (IMBUEConfig,  # noqa: E402
                                    conductances, program_replica_stack)
from repro_torch.core.variations import VariationConfig  # noqa: E402
from repro_torch.kernels import clause_eval, ops  # noqa: E402
from repro_torch.kernels import imbue_infer  # noqa: E402
from repro_torch.kernels.imbue_infer import (  # noqa: E402
    imbue_infer_planes, imbue_infer_planes_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("f,b,r,with_dev", [
    (37, 13, 3, True), (37, 1, 1, False), (64, 40, 2, True),
    (300, 70, 4, True), (300, 33, 1, False)])
def test_imbue_infer_planes_matches_plain_version(cuda, f, b, r, with_dev):
    cfg = tm.TMConfig(n_classes=5, clauses_per_class=14, n_features=f)
    rng = np.random.default_rng(f + b)
    inc = torch.from_numpy(rng.random((cfg.n_clauses, cfg.n_literals))
                           < 4.0 / cfg.n_literals).to(cuda)
    dev = None
    if with_dev:
        gen = torch.Generator(device=cuda).manual_seed(b)
        _, dev = _deviation_plane(
            program_replica_stack(inc, gen, r, VariationConfig()), inc)
    x = torch.from_numpy((rng.random((b, f)) < 0.5).astype(np.uint8))
    litw = ops.pack_literals(tm.literals(x.to(cuda)))
    args = (litw, ops.pack_literals(inc), dev,
            ops.polarity_matrix(cfg, inc, device=cuda).contiguous(),
            ops.plane_scalars(IMBUEConfig(), cfg.n_literals))
    before = imbue_infer_planes.launches
    got = imbue_infer_planes(*args)
    torch.cuda.synchronize()
    assert imbue_infer_planes.launches == before + 1
    assert torch.equal(got, imbue_infer_planes_ref(*args))


@pytest.mark.parametrize("name", ("tm_infer_planes", "tm_infer_packed",
                                  "tm_infer"))
@pytest.mark.parametrize("b,c,f,m", [
    (13, 37, 50, 5), (9, 70, 51, 3), (1, 64, 16, 2), (70, 130, 300, 10),
    (33, 1000, 784, 10)])
def test_tm_infer_kernels_match_plain_versions(cuda, name, b, c, f, m):
    rng = np.random.default_rng(b + c + f)
    x = torch.from_numpy((rng.random((b, f)) < 0.5).astype(np.uint8))
    lits = tm.literals(x).to(cuda)
    inc = np.zeros((c, 2 * f), bool)
    for ci in range(c):            # 1-6 literals that are 1 on some row
        ones = np.flatnonzero(lits[rng.integers(0, b)].cpu().numpy())
        inc[ci, rng.choice(ones, size=int(rng.integers(1, 7)))] = True
    inc[c // 2] = False            # an empty clause
    inc = torch.from_numpy(inc).to(cuda)
    comb = torch.from_numpy(rng.integers(-127, 128, (c, m)).astype(
        np.int32)).to(cuda)
    comb[c // 2] = 0
    if name == "tm_infer":
        args = (lits.contiguous(), inc.contiguous(), comb)
    else:
        args = (ops.pack_literals(lits), ops.pack_literals(inc), comb)
    wrapper = getattr(clause_eval, name)
    before = wrapper.launches
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = getattr(clause_eval, f"{name}_ref")(*args)
    assert torch.equal(got, want)
    assert int((want != 0).sum()) > 0


@pytest.mark.parametrize("name", ("imbue_infer_packed", "imbue_infer"))
@pytest.mark.parametrize("f,b,r", [(37, 13, 3), (16, 1, 1), (24, 9, 2),
                                   (64, 40, 2), (300, 70, 4)])
def test_dense_plane_analog_kernels_match_plain_versions(cuda, name, f, b,
                                                         r):
    cfg = tm.TMConfig(n_classes=5, clauses_per_class=14, n_features=f)
    rng = np.random.default_rng(f + b + r)
    inc = torch.from_numpy(rng.random((cfg.n_clauses, cfg.n_literals))
                           < 4.0 / cfg.n_literals).to(cuda)
    inc[3] = False                                    # an empty clause
    gen = torch.Generator(device=cuda).manual_seed(b)
    icfg = IMBUEConfig()
    g, leak = conductances(
        program_replica_stack(inc, gen, r, VariationConfig()), inc, icfg)
    x = torch.from_numpy((rng.random((b, f)) < 0.5).astype(np.uint8))
    lits = tm.literals(x.to(cuda)).contiguous()
    pol = ops.polarity_matrix(cfg, inc, device=cuda).contiguous()
    a = ops.pack_literals(lits) if name == "imbue_infer_packed" else lits
    args = (a, g.contiguous(), leak.contiguous(), pol,
            icfg.reference_voltage() / icfg.r_divider, icfg.v_read)
    wrapper = getattr(imbue_infer, name)
    before = wrapper.launches
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = getattr(imbue_infer, f"{name}_ref")(*args)
    assert torch.equal(got, want)
    assert int((want != 0).sum()) > 0


@pytest.mark.parametrize("name", ("imbue_infer_planes", "imbue_infer_packed",
                                  "imbue_infer"))
def test_empty_batch_launches_nothing(cuda, name):
    cfg = tm.TMConfig(n_classes=3, clauses_per_class=4, n_features=20)
    inc = torch.zeros((cfg.n_clauses, cfg.n_literals), dtype=torch.bool,
                      device=cuda)
    inc[:, 0] = True
    icfg = IMBUEConfig()
    pol = ops.polarity_matrix(cfg, inc, device=cuda).contiguous()
    lits = torch.zeros((0, cfg.n_literals), dtype=torch.uint8, device=cuda)
    if name == "imbue_infer_planes":
        args = (ops.pack_literals(lits), ops.pack_literals(inc), None, pol,
                ops.plane_scalars(icfg, cfg.n_literals))
    else:
        g, leak = conductances(
            program_replica_stack(inc, torch.Generator(device=cuda), 2,
                                  VariationConfig()), inc, icfg)
        a = ops.pack_literals(lits) if name == "imbue_infer_packed" else lits
        args = (a.contiguous(), g.contiguous(), leak.contiguous(), pol,
                icfg.reference_voltage() / icfg.r_divider, icfg.v_read)
    wrapper = getattr(imbue_infer, name)
    before = wrapper.launches
    got = wrapper(*args)
    assert wrapper.launches == before
    assert got.shape[1:] == (0, cfg.n_classes)
