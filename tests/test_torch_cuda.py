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


def _clause_case(b, c, l, seed, device):
    """0/1 literals ``[B, L]`` and an include plane ``[C, L]`` with 1-6
    includes per clause from one row's ones (two clauses in three) or from
    any literal; clause C // 2 is empty and must fire."""
    rng = np.random.default_rng(seed)
    lits = (rng.random((b, l)) < 0.5).astype(np.uint8)
    inc = np.zeros((c, l), bool)
    for ci in range(c):
        src = lits[rng.integers(0, b)]
        ones = np.flatnonzero(src) if src.any() and ci % 3 else np.arange(l)
        inc[ci, rng.choice(ones, size=int(rng.integers(1, 7)))] = True
    inc[c // 2] = False
    return (torch.from_numpy(lits).to(device),
            torch.from_numpy(inc).to(device))


@pytest.mark.parametrize("name", ("clause_eval_packed", "clause_eval"))
@pytest.mark.parametrize("b,c,l", [
    (13, 101, 74), (1, 64, 16), (9, 70, 102), (70, 130, 600), (1, 2000, 1568),
    (256, 2000, 1568), (33, 1000, 1568), (5, 37, 96)])
def test_clause_eval_kernels_match_plain_versions(cuda, name, b, c, l):
    lits, inc = _clause_case(b, c, l, b + c + l, cuda)
    if name == "clause_eval":
        args = (lits.contiguous(), inc.contiguous())
    else:
        args = (ops.pack_literals(lits), ops.pack_include(inc))
    wrapper = getattr(clause_eval, name)
    before = wrapper.launches
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = getattr(clause_eval, f"{name}_ref")(*args)
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    assert bool((got[:, c // 2] == 1).all())          # the empty clause
    share = float(want.float().mean())
    assert 0.0 < share < 1.0


@pytest.mark.parametrize("name", ("clause_eval_packed", "clause_eval"))
def test_clause_eval_empty_batch_launches_nothing(cuda, name):
    lits, inc = _clause_case(3, 9, 40, 0, cuda)
    lits = lits[:0].contiguous()
    args = ((lits, inc) if name == "clause_eval"
            else (ops.pack_literals(lits), ops.pack_include(inc)))
    wrapper = getattr(clause_eval, name)
    before = wrapper.launches
    got = wrapper(*args)
    assert wrapper.launches == before and tuple(got.shape) == (0, 9)


def test_training_steps_launch_once_per_step_or_example(cuda):
    from repro_torch.core import coalesced, tm_train
    cfg = tm.TMConfig(n_classes=3, clauses_per_class=6, n_features=40)
    gen = torch.Generator(device=cuda).manual_seed(0)
    state = tm.init_ta_state(gen, cfg, cuda)
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.random((7, 40)) < 0.5).astype(np.uint8))
    y = torch.from_numpy(rng.integers(0, 3, 7))
    packed, dense = clause_eval.clause_eval_packed, clause_eval.clause_eval
    p0, d0 = packed.launches, dense.launches
    tm_train.train_step_batch(state, gen, x, y, cfg)
    assert (packed.launches, dense.launches) == (p0 + 1, d0)
    tm_train.train_step(state, gen, x, y, cfg)
    assert (packed.launches, dense.launches) == (p0 + 1, d0 + 7)
    ccfg = coalesced.CoalescedConfig(n_classes=3, n_clauses=20,
                                     n_features=40)
    ta, w = coalesced.init_coalesced(gen, ccfg, cuda)
    coalesced.train_step_batch(ta, w, gen, x, y, ccfg)
    assert packed.launches == p0 + 2


def test_batch_step_on_the_kernel_equals_the_plain_version(cuda,
                                                           monkeypatch):
    """One train_step_batch from one CUDA generator seed, with the kernel
    and with the wrapper swapped for its plain version: identical TA
    states."""
    from repro_torch.core import tm_train
    cfg = tm.TMConfig(n_classes=4, clauses_per_class=10, n_features=300)
    rng = np.random.default_rng(2)
    inc = rng.random((cfg.n_clauses, cfg.n_literals)) < 0.01
    state = torch.from_numpy(np.where(inc, cfg.n_states + 5,
                                      cfg.n_states - 5).astype(np.int16))
    state = state.to(cuda)
    x = torch.from_numpy((rng.random((64, 300)) < 0.5).astype(np.uint8))
    y = torch.from_numpy(rng.integers(0, 4, 64))
    outs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(clause_eval, "clause_eval_packed",
                                clause_eval.clause_eval_packed_ref)
        gen = torch.Generator(device=cuda).manual_seed(7)
        outs.append(tm_train.train_step_batch(state, gen, x, y, cfg))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], state)
