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


# F_MNIST features select the imbue-tm-mnist width (10 classes x 200
# clauses, L = 1568: 49 columns, 62.5 clause tiles of 32); any other
# feature count a 5 x 14 = 70-clause model.
F_MNIST = 784


def _analog_config(f):
    if f == F_MNIST:
        return tm.TMConfig(n_classes=10, clauses_per_class=200,
                           n_features=f)
    return tm.TMConfig(n_classes=5, clauses_per_class=14, n_features=f)


def _planes_args(cfg, inc, x, r, with_dev, seed, device, pol=None):
    """``imbue_infer_planes`` operands: literal and include words, the
    deviation plane of ``r`` D2D-programmed chips (or None), the
    polarity (signed one-hot x nonempty unless given) and the scalars."""
    dev = None
    if with_dev:
        gen = torch.Generator(device=device).manual_seed(seed)
        _, dev = _deviation_plane(
            program_replica_stack(inc, gen, r, VariationConfig()), inc)
    if pol is None:
        pol = ops.polarity_matrix(cfg, inc, device=device)
    return (ops.pack_literals(tm.literals(x.to(device))),
            ops.pack_literals(inc), dev, pol.contiguous(),
            ops.plane_scalars(IMBUEConfig(), cfg.n_literals))


def _dense_args(name, cfg, inc, x, r, d2d, seed, device, pol=None):
    """Operands of a dense-plane analog kernel: literal words or bytes,
    the g / leak planes of ``r`` D2D-programmed (or nominal) chips, the
    polarity, ``i_ref`` and ``v_read``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    icfg = IMBUEConfig()
    vcfg = VariationConfig() if d2d else VariationConfig.nominal()
    g, leak = conductances(program_replica_stack(inc, gen, r, vcfg), inc,
                           icfg)
    lits = tm.literals(x.to(device)).contiguous()
    if pol is None:
        pol = ops.polarity_matrix(cfg, inc, device=device)
    a = ops.pack_literals(lits) if name == "imbue_infer_packed" else lits
    return (a, g.contiguous(), leak.contiguous(), pol.contiguous(),
            icfg.reference_voltage() / icfg.r_divider, icfg.v_read)


def _analog_call(name, args):
    """One call of analog kernel ``name``: its output, after checking that
    it launched once and equals the plain version."""
    wrapper = getattr(imbue_infer, name)
    before = wrapper.launches
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.equal(got, getattr(imbue_infer, f"{name}_ref")(*args))
    return got


@pytest.mark.parametrize("f,b,r,with_dev", [
    (37, 13, 3, True), (37, 1, 1, False), (64, 40, 2, True),
    (300, 70, 4, True), (300, 33, 1, False),
    # Full width: one row, a few, and one past a 128-row block.
    (F_MNIST, 1, 4, True), (F_MNIST, 8, 4, True), (F_MNIST, 129, 4, True),
    (F_MNIST, 1, 1, False), (F_MNIST, 8, 1, False), (F_MNIST, 129, 1, False),
    # 9 columns: not a multiple of the 8-column split.
    (144, 40, 2, True)])
def test_imbue_infer_planes_matches_plain_version(cuda, f, b, r, with_dev):
    cfg = _analog_config(f)
    rng = np.random.default_rng(f + b)
    inc = torch.from_numpy(rng.random((cfg.n_clauses, cfg.n_literals))
                           < 4.0 / cfg.n_literals).to(cuda)
    x = torch.from_numpy((rng.random((b, f)) < 0.5).astype(np.uint8))
    _analog_call("imbue_infer_planes",
                 _planes_args(cfg, inc, x, r, with_dev, b, cuda))


TM_KERNELS = ("tm_infer_planes", "tm_infer_packed", "tm_infer")


def _tm_case(name, b, c, f, m, case, device):
    """Operands of TM kernel ``name``: ``b`` rows of ``f`` features, ``c``
    clauses and an int32 ``[c, m]`` combine matrix.  "mixed": 1-6
    literals a clause that are 1 on some row, clause c // 2 empty with its
    combine row zeroed (the callers' contract); "empty": every clause
    empty (each fires, so its combine row is added: the rows are left
    non-zero here to show it); "fire": every clause includes x_0 alone
    and x_0 = 1 on every row, so every clause fires for every row."""
    rng = np.random.default_rng(b + c + f + m)
    x = (rng.random((b, f)) < 0.5).astype(np.uint8)
    if case == "fire":
        x[:, 0] = 1
    lits = tm.literals(torch.from_numpy(x)).to(device)
    inc = np.zeros((c, 2 * f), bool)
    if case == "fire":
        inc[:, 0] = True
    elif case == "mixed":
        for ci in range(c):        # 1-6 literals that are 1 on some row
            ones = np.flatnonzero(lits[rng.integers(0, b)].cpu().numpy())
            inc[ci, rng.choice(ones, size=int(rng.integers(1, 7)))] = True
        inc[c // 2] = False        # an empty clause
    inc = torch.from_numpy(inc).to(device)
    comb = torch.from_numpy(rng.integers(-127, 128, (c, m)).astype(
        np.int32)).to(device)
    if case == "mixed":
        comb[c // 2] = 0
    if name == "tm_infer":
        return lits.contiguous(), inc.contiguous(), comb
    return ops.pack_literals(lits), ops.pack_literals(inc), comb


def _tm_call(name, args):
    """One call of TM kernel ``name``: its output, after checking that it
    launched once and equals the plain version."""
    wrapper = getattr(clause_eval, name)
    before = wrapper.launches
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = getattr(clause_eval, f"{name}_ref")(*args)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    return want


@pytest.mark.parametrize("name", TM_KERNELS)
@pytest.mark.parametrize("b,c,f,m,case", [
    (13, 37, 50, 5, "mixed"), (9, 70, 51, 3, "mixed"), (1, 64, 16, 2, "mixed"),
    (70, 130, 300, 10, "mixed"), (33, 1000, 784, 10, "mixed"),
    # Rows that fill the b1 kernels' geometry at the coalesced and the
    # digital width (tiles of 32 and 64 rows, one row past them, 256).
    (128, 1000, 784, 10, "mixed"), (129, 2000, 784, 10, "mixed"),
    (256, 2000, 784, 10, "mixed"),
    # One class; every clause empty; every clause firing.
    (64, 1000, 784, 1, "mixed"), (70, 300, 784, 10, "empty"),
    (129, 2000, 784, 10, "fire"), (9, 70, 51, 3, "fire"),
    # 200 classes: a 32-clause combine slice (25.6 KB) is too large to
    # stage, so the b1 kernels read it from device memory.
    (40, 130, 300, 200, "mixed"),
    # 5000 clauses (157 clause tiles of 32); the same with rows too long
    # for one staging pass (10000 literals: the b1 kernels stage K in
    # chunks); 4000 classes (the combine read from device memory by
    # every block).
    (33, 5000, 784, 10, "mixed"), (5, 5000, 5000, 3, "mixed"),
    (64, 300, 784, 4000, "mixed")])
def test_tm_infer_kernels_match_plain_versions(cuda, name, b, c, f, m, case):
    want = _tm_call(name, _tm_case(name, b, c, f, m, case, cuda))
    assert int((want != 0).sum()) > 0


@pytest.mark.parametrize("b", [1, 8, 129])
def test_tm_infer_unaligned_views_match_plain_version(cuda, b):
    """Byte operands that start one byte past a 16-byte boundary take
    tm_infer's byte-by-byte loads."""
    lits, inc, comb = _tm_case("tm_infer", b, 1000, 784, 10, "mixed", cuda)
    views = []
    for t in (lits, inc.view(torch.uint8)):
        buf = torch.empty(t.numel() + 1, dtype=torch.uint8, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 == 1
        views.append(view)
    want = _tm_call("tm_infer", (*views, comb))
    assert torch.equal(want, clause_eval.tm_infer_ref(lits, inc, comb))
    assert int((want != 0).sum()) > 0


@pytest.mark.parametrize("name", TM_KERNELS)
def test_tm_infer_kernels_are_deterministic(cuda, name):
    """Two launches on the same inputs give equal sums (the K-split's
    flags meet in shared memory; the sums are int32 atomics, exact in any
    order)."""
    args = _tm_case(name, 129, 2000, 784, 10, "mixed", cuda)
    assert torch.equal(_tm_call(name, args), _tm_call(name, args))


@pytest.mark.parametrize("b", [1, 129])
@pytest.mark.parametrize("case", ["mixed", "zero"])
def test_tm_infer_packed_writes_every_sum(cuda, b, case):
    """No earlier contents of the output's memory survive a call, zero
    sums included.  A [B, M] int32 tensor of 0x7f7f7f7f words is
    allocated and freed right before the call in a fresh memory pool,
    which then hands that block back as the output.  "zero": comb is all
    zeros, so every sum is 0."""
    litw, incw, comb = _tm_case("tm_infer_packed", b, 1000, 784, 10,
                                "mixed", cuda)
    if case == "zero":
        comb = torch.zeros_like(comb)
    pool = torch.cuda.MemPool()
    with torch.cuda.use_mem_pool(pool):
        poison = torch.full((b, comb.shape[1]), 0x7F7F7F7F,
                            dtype=torch.int32, device=cuda)
        ptr = poison.data_ptr()
        del poison
        got = clause_eval.tm_infer_packed(litw, incw, comb)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr            # the poisoned block came back
    want = clause_eval.tm_infer_packed_ref(litw, incw, comb)
    assert torch.equal(got, want)
    assert bool((want == 0).all()) == (case == "zero")
    del got


def test_tm_infer_packed_launches_one_kernel_per_call(cuda):
    """torch.profiler on the card sees, a call, one tm_infer_packed
    kernel and one device op besides it: the [B, M] zero fill that its
    int32 atomics add into."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args = _tm_case("tm_infer_packed", 64, 1000, 784, 10, "mixed", cuda)
    _tm_call("tm_infer_packed", args)       # built, checked and warm
    calls = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            clause_eval.tm_infer_packed(*args)
        torch.cuda.synchronize()
    device = [(e.key, e.count) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    kernel = sum(n for key, n in device if "packed_kernel" in key)
    assert kernel == calls and sum(n for _, n in device) == 2 * calls, device


@pytest.mark.parametrize("name", TM_KERNELS)
@pytest.mark.parametrize("b,c,m", [(0, 70, 3), (9, 0, 3), (9, 70, 0)])
def test_tm_infer_without_rows_clauses_or_classes_launches_nothing(
        cuda, name, b, c, m):
    """An empty batch, clause set or class set launches nothing and the
    sums are zeros (a [B, M] output with B, M > 0 when C = 0)."""
    dtype = torch.uint8 if name == "tm_infer" else torch.int32
    a = torch.zeros((b, 3), dtype=dtype, device=cuda)
    inc = torch.zeros((c, 3), dtype=dtype, device=cuda)
    comb = torch.ones((c, m), dtype=torch.int32, device=cuda)
    wrapper = getattr(clause_eval, name)
    before = wrapper.launches
    got = wrapper(a, inc, comb)
    assert wrapper.launches == before
    assert got.shape == (b, m) and got.dtype == torch.int32
    assert not bool(got.any())


@pytest.mark.parametrize("name", TM_KERNELS)
@pytest.mark.parametrize("b", [1, 129])
def test_tm_infer_without_literals_fires_every_clause(cuda, name, b):
    """Rows of no words (Lw = 0; the operands have no storage) still
    launch: every clause is empty and fires, so each row gets the column
    sums of comb."""
    rng = np.random.default_rng(b)
    c, m = 1000, 10
    comb = torch.from_numpy(rng.integers(-127, 128, (c, m)).astype(
        np.int32)).to(cuda)
    dtype = torch.uint8 if name == "tm_infer" else torch.int32
    a = torch.zeros((b, 0), dtype=dtype, device=cuda)
    inc = torch.zeros((c, 0), dtype=dtype, device=cuda)
    got = _tm_call(name, (a, inc, comb))
    assert torch.equal(got, comb.sum(0, dtype=torch.int32).expand(b, m))


@pytest.mark.parametrize("name", ("imbue_infer_packed", "imbue_infer"))
@pytest.mark.parametrize("f,b,r,d2d", [
    (37, 13, 3, True), (16, 1, 1, True), (24, 9, 2, True),
    (64, 40, 2, True), (300, 70, 4, True),
    (F_MNIST, 1, 4, True), (F_MNIST, 8, 4, True), (F_MNIST, 129, 4, True),
    (F_MNIST, 1, 1, False), (F_MNIST, 8, 1, False), (F_MNIST, 129, 1, False),
    (144, 40, 2, True)])
def test_dense_plane_analog_kernels_match_plain_versions(cuda, name, f, b,
                                                         r, d2d):
    cfg = _analog_config(f)
    rng = np.random.default_rng(f + b + r)
    inc = torch.from_numpy(rng.random((cfg.n_clauses, cfg.n_literals))
                           < 4.0 / cfg.n_literals).to(cuda)
    inc[3] = False                                    # an empty clause
    x = torch.from_numpy((rng.random((b, f)) < 0.5).astype(np.uint8))
    args = _dense_args(name, cfg, inc, x, r, d2d, b, cuda)
    want = _analog_call(name, args)
    assert int((want != 0).sum()) > 0


def _edge_case(cfg, b, fate, seed):
    """An include plane and ``b`` rows where every clause includes
    literal x_0 (column 0): with x_0 = 0 on every row ("die") every clause
    fails its first column; with x_0 = 1 ("fire") and nothing else
    included, every clause fires for every row.  The polarity is a
    positive one-hot, so the class sums are 0 or clauses_per_class."""
    rng = np.random.default_rng(seed)
    x = (rng.random((b, cfg.n_features)) < 0.5).astype(np.uint8)
    x[:, 0] = 1 if fate == "fire" else 0
    inc = np.zeros((cfg.n_clauses, cfg.n_literals), bool)
    if fate == "die":
        inc = rng.random(inc.shape) < 4.0 / cfg.n_literals
    inc[:, 0] = True
    pol = torch.nn.functional.one_hot(
        torch.arange(cfg.n_clauses) // cfg.clauses_per_class,
        cfg.n_classes).to(torch.int32)
    return torch.from_numpy(inc), torch.from_numpy(x), pol


@pytest.mark.parametrize("name", ("imbue_infer_planes", "imbue_infer_packed",
                                  "imbue_infer"))
@pytest.mark.parametrize("fate", ("die", "fire"))
@pytest.mark.parametrize("f,b,r,varied", [
    (37, 13, 3, True), (F_MNIST, 129, 4, True), (F_MNIST, 64, 1, False)])
def test_analog_kernels_every_clause_dies_or_fires(cuda, name, fate, f, b,
                                                   r, varied):
    """The early exit neither drops a live row nor keeps a dead one: every
    clause dead in its first column gives all-zero sums, every clause
    firing gives clauses_per_class in every sum."""
    cfg = _analog_config(f)
    inc, x, pol = _edge_case(cfg, b, fate, f + b)
    inc, pol = inc.to(cuda), pol.to(cuda)
    if name == "imbue_infer_planes":
        args = _planes_args(cfg, inc, x, r, varied, b, cuda, pol)
    else:
        args = _dense_args(name, cfg, inc, x, r, varied, b, cuda, pol)
    got = _analog_call(name, args)
    want = 0 if fate == "die" else cfg.clauses_per_class
    assert got.shape == (r, b, cfg.n_classes) and bool((got == want).all())


@pytest.mark.parametrize("name", ("imbue_infer_planes", "imbue_infer_packed",
                                  "imbue_infer"))
def test_analog_kernels_are_deterministic(cuda, name):
    """Two launches on the same inputs give equal outputs (the votes are
    int32 atomics, exact in any order)."""
    cfg = _analog_config(F_MNIST)
    rng = np.random.default_rng(5)
    inc = torch.from_numpy(rng.random((cfg.n_clauses, cfg.n_literals))
                           < 4.0 / cfg.n_literals).to(cuda)
    x = torch.from_numpy((rng.random((129, F_MNIST)) < 0.5).astype(np.uint8))
    if name == "imbue_infer_planes":
        args = _planes_args(cfg, inc, x, 4, True, 5, cuda)
    else:
        args = _dense_args(name, cfg, inc, x, 4, True, 5, cuda)
    assert torch.equal(_analog_call(name, args), _analog_call(name, args))


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


def _small_route():
    """clause_eval's route(B, L): 1 where a launch takes its
    warp-per-clause kernel, 0 where it takes the tile kernel."""
    import ctypes
    from repro_torch.kernels import _build
    _build.build(["clause_eval"])
    return ctypes.CDLL(str(_build.library_path("clause_eval"))
                       ).clause_eval_small_route


def _rows(b):
    """A batch size of the parametrisations below: an int, or "small" /
    "small+1" for the most rows clause_eval's warp-per-clause kernel takes
    at L = 1568 (the threshold lives in csrc/clause_eval.cu alone) and
    one more."""
    if isinstance(b, int):
        return b
    route = _small_route()
    small = max((n for n in range(1, 33) if route(n, 1568)), default=0)
    return small + (b == "small+1")


@pytest.mark.parametrize("name", ("clause_eval_packed", "clause_eval"))
@pytest.mark.parametrize("b,c,l", [
    (13, 101, 74), (1, 64, 16), (9, 70, 102), (70, 130, 600), (1, 2000, 1568),
    (256, 2000, 1568), (33, 1000, 1568), (5, 37, 96),
    # Around clause_eval's small-batch route (B_SMALL = 8 rows in
    # csrc/clause_eval.cu): C not a multiple of its 8 warps a block,
    # ragged L, L past 64 words (a lane's second step of include words).
    (2, 37, 1568), (3, 2001, 200), ("small", 75, 1568),
    ("small+1", 75, 1568), (2, 13, 47), ("small", 2000, 1568),
    (1, 9, 4000),
    # clause_eval_packed's choose: a ragged batch of 208 rows (13 16-row
    # tiles, no whole 64-row one) and one row past 256 at the digital
    # width, 257 at the coalesced width; C a multiple of none of its clause
    # tiles (32, 64, 128); Lw = 2 words, fewer than one 8-word step; rows
    # too long for one staged chunk (375 words), and 125 words at C = 37.
    (208, 2000, 1568), (257, 2000, 1568), (257, 1000, 1568),
    (64, 1001, 1568), (1, 2000, 64), (64, 300, 12000), (5, 37, 4000)])
def test_clause_eval_kernels_match_plain_versions(cuda, name, b, c, l):
    b = _rows(b)
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


def _geometry(name, *shape):
    """``name``'s launch geometry at ``shape`` (``<name>_geometry``): grid,
    threads, shared bytes, resident blocks an SM, K-split, tile, words
    staged a chunk, and the launched warps an SM."""
    import ctypes
    from repro_torch.kernels import _build
    _build.build([name])
    lib = ctypes.CDLL(str(_build.library_path(name)))
    info = (ctypes.c_int * 9)()
    assert getattr(lib, f"{name}_geometry")(*shape, info) == 0
    gx, gy, threads, smem, per_sm, ksplit, bt, ct, kc = list(info)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(gx=gx, gy=gy, threads=threads, smem=smem, per_sm=per_sm,
                ksplit=ksplit, bt=bt, ct=ct, kc=kc, n_sm=n_sm,
                launched=min(gx * gy * threads / 32 / n_sm,
                             per_sm * threads / 32))


def test_clause_eval_packed_is_deterministic(cuda):
    """Two launches on the same inputs give equal bits (the K-split's
    partial flags meet in shared memory, every writer writing 1)."""
    lits, inc = _clause_case(257, 2000, 1568, 11, cuda)
    args = (ops.pack_literals(lits), ops.pack_include(inc))
    first = clause_eval.clause_eval_packed(*args)
    assert torch.equal(first, clause_eval.clause_eval_packed(*args))
    assert torch.equal(first, clause_eval.clause_eval_packed_ref(*args))


@pytest.mark.parametrize("b", [1, 8, 64, 208, 256])
@pytest.mark.parametrize("c", [1000, 2000])
def test_clause_eval_packed_geometry_fills_the_card(cuda, b, c):
    """chip_smoke.py's clause-timing rows (the batch training step's 256
    rows, the extra ragged batch of 208, 1, 8 and 64; the digital and
    coalesced widths, L = 1568) launch at least 16 warps an SM, except
    where the b1 product's grid cannot: its K-split is at its cap, one
    warp an 8-word step (7 at Lw = 49), and a warp takes 16 rows x 32
    clauses, so the grid holds at most 7 warps a 16 x 32 tile, fewer than
    16 an SM at B = 1 and 8 (one row tile) and at B = 64 (four)."""
    lw = 49
    g = _geometry("clause_eval_packed", b, c, lw)
    assert g["gx"] * g["bt"] >= b and g["gy"] * g["ct"] >= c
    assert g["smem"] <= 48 * 1024 and g["kc"] == 56 and g["per_sm"] >= 1
    assert g["launched"] >= 16 or g["ksplit"] == -(-lw // 8)


@pytest.mark.parametrize("b", [8, 64, 128])
@pytest.mark.parametrize("c", [1000, 2000])
def test_tm_infer_geometry_fills_the_card(cuda, b, c):
    """chip_smoke.py's TM timing rows (the coalesced and the digital width,
    L = 1568, M = 10).  tm_infer_planes and tm_infer_packed, on
    clause_eval_packed's layouts, launch at least 16 warps an SM except
    where the K-split is at its cap (7 steps of 8 words at Lw = 49), as
    for clause_eval_packed.
    tm_infer reads 32x the bytes of a word row, so it keeps its row tiles
    few (at most 4 at B <= 128) and fills the card with clause tiles: one
    block an SM at most (each SM reads one tile's bytes), on at least half
    of the SMs where the 16 x 32 tiles allow it."""
    for name in ("tm_infer_planes", "tm_infer_packed"):
        g = _geometry(name, b, c, 49, 10, 0, 0)
        assert g["gx"] * g["bt"] >= b and g["gy"] * g["ct"] >= c
        assert g["smem"] <= 48 * 1024 and g["kc"] == 56
        assert g["per_sm"] >= 1
        assert g["launched"] >= 16 or g["ksplit"] == 7
    g = _geometry("tm_infer", b, c, 1568, 10, 0, 0)
    assert g["gx"] * g["bt"] >= b and g["gy"] * g["ct"] >= c
    assert g["smem"] <= 48 * 1024 and g["kc"] == 56 and g["per_sm"] >= 1
    blocks, n_sm = g["gx"] * g["gy"], g["n_sm"]
    assert g["gx"] <= 4 and blocks <= n_sm
    assert blocks >= min(n_sm, -(-b // 16) * -(-c // 32)) // 2


@pytest.mark.parametrize("b", [1, 2, 3, "small", "small+1"])
def test_clause_eval_unaligned_views_match_plain_version(cuda, b):
    """Operands that start one byte past a 16-byte boundary take the
    byte-by-byte loads of both clause_eval kernels."""
    b, c, l = _rows(b), 75, 1568
    lits, inc = _clause_case(b, c, l, 7 * b, cuda)
    views = []
    for t in (lits, inc.view(torch.uint8)):
        buf = torch.empty(t.numel() + 1, dtype=torch.uint8, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 == 1
        views.append(view)
    before = clause_eval.clause_eval.launches
    got = clause_eval.clause_eval(*views)
    torch.cuda.synchronize()
    assert clause_eval.clause_eval.launches == before + 1
    assert torch.equal(got, clause_eval.clause_eval_ref(lits, views[1]))
    assert bool((got[:, c // 2] == 1).all())          # the empty clause


def test_clause_eval_small_route_takes_a_prefix_of_batches(cuda):
    """At L = 1568 the library takes its warp-per-clause kernel for every
    B up to a threshold of at least 1 row (the sequential step), the tile
    kernel above; a literal row too long for its shared memory takes the
    tile kernel."""
    route = _small_route()
    small = _rows("small")
    assert small >= 1
    assert [route(b, 1568) for b in range(1, 257)] == \
        [1] * small + [0] * (256 - small)
    assert route(1, 1 << 20) == 0


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


# ------------------------------------------------------- flash attention
# float32: max|kernel - plain| <= tol * max|plain| at the reference's
# bounds (tests/test_kernels.py:166,207), 2e-5 forward, 5e-4 gradients.
# bfloat16: both sides read the same inputs, compute in float32 and round
# to bf16, so each element is held at one bf16 ulp (<= 2^-7 of the value)
# plus 2e-3 (o, whose P is rounded to bf16 on both sides) or 1e-3 (dQ, dK,
# dV) of max|plain|, as chip_smoke.FLASH_TOL; lse is float32 in both.
FLASH_CASES = [
    (2, 300, 2, 32, True, 0, 0.0, torch.float32),
    (2, 256, 2, 128, True, 0, 50.0, torch.float32),
    (2, 97, 1, 64, False, 40, 30.0, torch.float32),
    (1, 200, 3, 64, False, 0, 0.0, torch.bfloat16),
    (1, 130, 2, 256, True, 64, 50.0, torch.bfloat16),
    # The bf16 backward's tensor-core instances at the other head dims
    # (D = 32 reads 64-byte swizzled rows), and S = 197, a multiple of
    # neither the 64- nor the 128-row tiles, non-causal, with a window and
    # with a softcap.
    (2, 300, 2, 32, True, 0, 0.0, torch.bfloat16),
    (1, 256, 2, 128, True, 100, 0.0, torch.bfloat16),
    (1, 197, 2, 64, False, 50, 30.0, torch.bfloat16),
    (2, 197, 1, 128, False, 0, 30.0, torch.bfloat16),
    # The bf16 forward's tensor-core edges (query tiles of 192 rows at
    # D <= 64 and 128 above, key tiles of 128 rows at D <= 128 and 64 at
    # D = 256): S = 1, 63 and 129 at D = 64 and 256, a window smaller
    # than one key tile, and non-causal ragged S with a softcap.  A query
    # row that sees one key has dS = p (dP - D) = 0 in exact arithmetic,
    # so its dQ is float noise on both sides: with S = 1 only o, lse and
    # dV are compared, and S = 63 (where causal row 0 would be more than
    # 1 % of the rows) is not causal.
    (2, 1, 2, 64, True, 0, 0.0, torch.bfloat16),
    (1, 1, 2, 256, False, 0, 50.0, torch.bfloat16),
    (2, 63, 2, 64, False, 0, 0.0, torch.bfloat16),
    (1, 63, 2, 256, False, 30, 0.0, torch.bfloat16),
    (2, 129, 2, 64, False, 0, 0.0, torch.bfloat16),
    (1, 129, 2, 256, True, 0, 50.0, torch.bfloat16),
    (1, 300, 2, 64, True, 16, 0.0, torch.bfloat16),
    (1, 200, 2, 128, False, 20, 0.0, torch.bfloat16),
    (2, 333, 2, 32, False, 0, 20.0, torch.bfloat16),
    (1, 150, 2, 256, False, 0, 50.0, torch.bfloat16),
]


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()) / float(
        want.float().abs().max())


def _within(got, want, dtype, f32_tol, bf16_atol=1e-3):
    if dtype == torch.float32:
        return _rel(got, want) <= f32_tol
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= 2.0 ** -7 * w.abs()
                 + bf16_atol * w.abs().max()).all())


@pytest.mark.parametrize("b,s,h,d,causal,window,cap,dtype", FLASH_CASES)
def test_flash_kernels_match_plain_versions(cuda, b, s, h, d, causal,
                                            window, cap, dtype):
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(s + d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32)).to(cuda, dtype) for _ in range(4))
    opts = dict(causal=causal, window=window, softcap=cap)
    before = (fa.flash_fwd.launches, fa.flash_bwd_dkv.launches,
              fa.flash_bwd_dq.launches)
    o, lse = fa.flash_fwd(q, k, v, **opts)
    want_o, want_lse = fa.flash_fwd_plain(q, k, v, causal, window, cap)
    torch.cuda.synchronize()
    assert o.dtype == dtype and _within(o, want_o, dtype, 2e-5, 2e-3)
    assert lse.shape == (b * h, s) and bool(torch.isfinite(lse).all())
    assert _rel(lse, want_lse) <= 2e-5
    dd = fa.row_dots(do, want_o)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, want_lse, dd, **opts)
    dq = fa.flash_bwd_dq(q, k, v, do, want_lse, dd, **opts)
    want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, do, want_lse, dd,
                                              causal, window, cap)
    want_dq = fa.flash_bwd_dq_plain(q, k, v, do, want_lse, dd, causal,
                                    window, cap)
    torch.cuda.synchronize()
    grads = ((dq, want_dq), (dk, want_dk), (dv, want_dv)) if s > 1 else \
        ((dv, want_dv),)
    for got, want in grads:
        assert got.dtype == dtype and _within(got, want, dtype, 5e-4)
    for got in (o, *(g for g, _ in grads)):
        assert float((got.float().abs().amax(-1) > 0).float().mean()) > 0.99
    assert (fa.flash_fwd.launches, fa.flash_bwd_dkv.launches,
            fa.flash_bwd_dq.launches) == tuple(n + 1 for n in before)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_backward_is_deterministic(cuda, d):
    """Two launches of each bf16 backward kernel on the same inputs are
    bit-identical: every block owns its output rows (no atomics), so the
    result does not depend on the order in which blocks run."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 333, 3, d))
                                    .astype(np.float32)).to(cuda,
                                                            torch.bfloat16)
                   for _ in range(4))
    opts = dict(causal=True, window=0, softcap=0.0)
    o, lse = fa.flash_fwd(q, k, v, **opts)
    dd = fa.row_dots(do, o)
    first = (*fa.flash_bwd_dkv(q, k, v, do, lse, dd, **opts),
             fa.flash_bwd_dq(q, k, v, do, lse, dd, **opts))
    second = (*fa.flash_bwd_dkv(q, k, v, do, lse, dd, **opts),
              fa.flash_bwd_dq(q, k, v, do, lse, dd, **opts))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
        assert float(a.float().abs().max()) > 0.0


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_forward_is_deterministic(cuda, d):
    """Two launches of the bf16 forward on the same inputs are
    bit-identical (each block owns its query rows)."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(10 + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 333, 3, d))
                                .astype(np.float32)).to(cuda, torch.bfloat16)
               for _ in range(3))
    opts = dict(causal=True, window=100, softcap=30.0)
    first = fa.flash_fwd(q, k, v, **opts)
    second = fa.flash_fwd(q, k, v, **opts)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
        assert bool(torch.isfinite(a.float()).all())
    assert float(first[0].float().abs().max()) > 0.0


def test_flash_fwd_tensor_core_shared_memory(cuda):
    """The bf16 forward's tensor-core instance at each head dim reports its
    dynamic shared memory, within the 227 KB a block can have."""
    import ctypes
    from repro_torch.kernels import _build
    _build.build(["flash_fwd"])
    smem = ctypes.CDLL(str(_build.library_path("flash_fwd"))
                       ).flash_fwd_tc_smem
    for d in (32, 64, 128, 256):
        assert 0 < smem(d) <= 232448
    assert smem(48) == 0


def test_flash_trainable_launches_each_kernel_once(cuda):
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 70, 2, 64)).astype(
        np.float32)).to(cuda).requires_grad_(True) for _ in range(3))
    def counts():
        return (fa.flash_fwd.launches, fa.flash_bwd_dkv.launches,
                fa.flash_bwd_dq.launches)
    c0 = counts()
    fa.flash_attention_trainable(q, k, v, True, 16, 0.0).sum().backward()
    assert counts() == (c0[0] + 1, c0[1] + 1, c0[2] + 1)
    c1 = counts()
    fa.flash_attention_trainable(q.detach(), k.detach(), v).sum().backward()
    assert counts() == (c1[0] + 1, c1[1] + 1, c1[2])     # no dQ wanted
    fa.flash_attention(q.detach(), k.detach(), v.detach())
    assert counts() == (c1[0] + 2, c1[1] + 1, c1[2])
    empty = q.detach()[:, :0].contiguous()
    assert fa.flash_attention(empty, empty, empty).shape == (1, 0, 2, 64)
    assert counts() == (c1[0] + 2, c1[1] + 1, c1[2])


def test_flash_plain_backward_gradcheck_on_the_card(cuda):
    """The plain forward and backward in float64 on the card, through
    torch.autograd.gradcheck."""
    from repro_torch.kernels import flash_attention as fa

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            o, lse = fa.flash_fwd_plain(q, k, v, True, 3, 2.0, bk=8)
            ctx.save_for_backward(q, k, v, o, lse)
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            do = do.contiguous()
            dd = fa.row_dots(do, o)
            dk, dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, dd, True, 3,
                                            2.0)
            return (fa.flash_bwd_dq_plain(q, k, v, do, lse, dd, True, 3,
                                          2.0), dk, dv)

    rng = np.random.default_rng(4)
    ts = [torch.from_numpy(rng.standard_normal((1, 7, 2, 4))).to(cuda)
          .requires_grad_(True) for _ in range(3)]
    assert torch.autograd.gradcheck(Plain.apply, ts, eps=1e-6, atol=1e-6,
                                    rtol=1e-5)


def _live_engines(cuda, cls, routing, n_replicas=4, **ecfg_kw):
    """An engine at imbue-tm-mnist width under D2D + C2C on the card, on
    a seed-drawn sparse TA state."""
    from repro_torch.serve import BatcherConfig, EngineConfig
    cfg = _analog_config(F_MNIST)
    rng = np.random.default_rng(5)
    inc = rng.random((cfg.n_clauses, cfg.n_literals)) < 0.006
    ta = torch.from_numpy(np.where(inc, cfg.n_states + 1,
                                   cfg.n_states).astype(np.int16))
    eng = cls.from_ta_state(
        ta, cfg, n_replicas=n_replicas, seed=13,
        vcfg=VariationConfig(csa_offset=False),
        ecfg=EngineConfig(routing=routing,
                          batcher=BatcherConfig(max_batch=64,
                                                bucket_sizes=(8, 64)),
                          **ecfg_kw), device=cuda)
    return eng, cfg, rng


@pytest.mark.parametrize("routing", ["round_robin", "ensemble"])
def test_async_engine_on_cuda_events_equals_sync(cuda, routing):
    """The async engine keeps ``max_in_flight`` issues outstanding (each
    with a CUDA event behind pinned host copies) and answers bit for bit
    as the sync engine on the same seed."""
    from repro_torch.serve import AsyncServeEngine, ServeEngine
    out, reached = {}, []
    for cls in (ServeEngine, AsyncServeEngine):
        eng, cfg, rng = _live_engines(cuda, cls, routing)
        xs = (rng.random((320, cfg.n_features)) < 0.5).astype(np.uint8)
        if cls is AsyncServeEngine:
            orig = eng._dispatch

            def dispatch(b, eng=eng, orig=orig):
                orig(b)
                reached.append(eng.in_flight)
                fl = eng._pending[-1]
                assert isinstance(fl.event, torch.cuda.Event)
                assert fl.sums.is_pinned() and fl.preds.is_pinned()
                assert fl.device_tensors[0].is_cuda

            eng._dispatch = dispatch
        eng.submit_many(list(xs))
        eng.pump(force=True)
        out[cls.__name__] = (eng.drain(), eng.summary())
    (got, s), (want, _) = out["AsyncServeEngine"], out["ServeEngine"]
    assert max(reached) == 2 and s["fallback_dispatches"] == 0
    assert len(got) == len(want) == 320
    for g, w in zip(got, want):
        assert (g.rid, g.pred, g.replica) == (w.rid, w.pred, w.replica)
        np.testing.assert_array_equal(g.class_sums, w.class_sums)


def test_canary_of_the_serving_state_replays_the_noise(cuda):
    """At R = 1 under C2C, a canary armed with the serving state itself
    scores agreement 1.0, with canary sums equal to the shadow's: the
    serving generator's state is replayed for the shadow read."""
    from repro_torch.serve import CANARY, ServeEngine
    eng, cfg, rng = _live_engines(cuda, ServeEngine, "round_robin",
                                  n_replicas=1)
    reads = []
    orig = eng._forward

    def spy(state, lits, generator, mask):
        sums, preds = orig(state, lits, generator, mask)
        reads.append(sums.clone())
        return sums, preds

    eng._forward = spy
    eng.arm_canary(eng._slices[0], 1, 1.0)
    xs = (rng.random((128, cfg.n_features)) < 0.5).astype(np.uint8)
    eng.submit_many(list(xs))
    out = eng.drain()
    assert all(r.replica == CANARY for r in out)
    assert eng.metrics.canary_rows == 128
    assert eng.metrics.canary_agreement() == 1.0
    assert len(reads) == 4
    for canary, shadow in zip(reads[::2], reads[1::2]):
        assert torch.equal(canary, shadow)
    assert any(bool((r != 0).any()) for r in reads)


@pytest.mark.parametrize("routing", ["round_robin", "ensemble"])
def test_an_issue_never_waits_for_the_card(cuda, routing):
    """``_issue``, with and without a canary, performs no synchronizing
    CUDA operation: the rows reach the card from a page-locked slot
    without blocking, so every host wait of a dispatch is in its collect,
    where the overlap accounting counts it."""
    from repro_torch.serve import ServeEngine
    eng, cfg, rng = _live_engines(cuda, ServeEngine, routing)
    xs = (rng.random((64, cfg.n_features)) < 0.5).astype(np.uint8)
    eng.arm_canary(eng._slices[0], 1, 1.0)      # warm: kernels built and
    eng.submit_many(list(xs))                   # every slot buffer made
    eng.drain()
    eng.disarm_canary()
    for canary in (False, True):
        if canary:
            eng.arm_canary(eng._slices[0], 1, 1.0)
        eng.submit_many(list(xs))
        batch = eng.batcher.cut(eng.clock(), force=True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fl = eng._issue(batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        eng._collect(fl)
    assert eng._n_slots == 1 and eng.metrics.canary_rows == 128


def test_responses_keep_their_sums_when_slots_are_reused(cuda):
    """A Response's class sums are its own copy: serving more batches
    through the same page-locked slots leaves earlier Responses as they
    were, and the engine holds no more slots than ``max_in_flight``."""
    from repro_torch.serve import AsyncServeEngine
    eng, cfg, rng = _live_engines(cuda, AsyncServeEngine, "round_robin")
    xs = (rng.random((448, cfg.n_features)) < 0.5).astype(np.uint8)
    eng.submit_many(list(xs[:64]))
    first = eng.drain()
    kept = [(r.pred, r.class_sums.copy()) for r in first]
    for lo in range(64, len(xs), 128):
        eng.submit_many(list(xs[lo:lo + 128]))
        eng.pump(force=True)
    eng.drain()
    assert eng._n_slots == eng.ecfg.max_in_flight == 2
    for r, (pred, sums) in zip(first, kept):
        assert r.pred == pred
        np.testing.assert_array_equal(r.class_sums, sums)
        assert r.class_sums.base.flags.owndata      # numpy's, not a slot's


def test_a_failed_issue_gives_up_its_slot(cuda):
    """An issue that raises drops its host slot (a copy may still read
    it), so the engine goes on serving with a fresh one."""
    from repro_torch.serve import ServeEngine
    eng, cfg, rng = _live_engines(cuda, ServeEngine, "round_robin")
    xs = (rng.random((64, cfg.n_features)) < 0.5).astype(np.uint8)
    orig = eng._forward

    def fail(*args):
        raise RuntimeError("injected")

    eng._forward = fail
    eng.submit_many(list(xs))
    with pytest.raises(RuntimeError, match="injected"):
        eng.pump(force=True)
    assert eng._n_slots == 0 and not eng._free_slots
    eng._forward = orig
    eng.submit_many(list(xs))
    assert len(eng.drain()) == 64 and eng._n_slots == 1


# KWS-6 streaming width: 8 frames x 12 mels x 4 bits = 384 features
# (L = 768, 24 words), 6 classes x 300 clauses (C = 1800).
KWS_STREAM = dict(mels=12, bits=4, window=8, hop=4)


def _stream_setup(cuda, cls, routing, vcfg, sessions=8, frames=64):
    """A stream server at the KWS width on the card: numpy-drawn frames,
    a quantile booleanizer on the card, a sparse TA state (~3 includes a
    clause), R = 4 under ``vcfg``; and each session's frames."""
    from repro_torch.core.booleanize import fit_quantile
    from repro_torch.serve import (BatcherConfig, EngineConfig, StreamConfig,
                                   StreamServer)
    k = KWS_STREAM
    cfg = tm.TMConfig(n_classes=6, clauses_per_class=300,
                      n_features=k["window"] * k["mels"] * k["bits"],
                      n_states=127)
    rng = np.random.default_rng(8)
    streams = rng.normal(size=(sessions, frames, k["mels"])).astype(
        np.float32)
    b = fit_quantile(streams.reshape(-1, k["mels"]), k["bits"], device=cuda)
    inc = rng.random((cfg.n_clauses, cfg.n_literals)) < 0.004
    ta = torch.from_numpy(np.where(inc, cfg.n_states + 1,
                                   cfg.n_states).astype(np.int16))
    eng = cls.from_ta_state(ta, cfg, n_replicas=4, seed=13, vcfg=vcfg,
                            ecfg=EngineConfig(
                                routing=routing,
                                batcher=BatcherConfig.for_max_batch(64)),
                            device=cuda)
    server = StreamServer(eng, b, StreamConfig(window=k["window"],
                                               hop=k["hop"], vote=5))
    return server, cfg, ta, streams


def _stream_rounds(server, streams, hop):
    for lo in range(0, streams.shape[1], hop):
        for i, s in enumerate(streams):
            server.feed(f"s{i}", s[lo:lo + hop])
        server.pump()
    server.drain()


@pytest.mark.parametrize("routing", ["round_robin", "ensemble"])
@pytest.mark.parametrize("engine", ["sync", "async"])
def test_streamed_equals_offline_at_nominal_on_the_card(cuda, routing,
                                                        engine):
    """At the KWS width and nominal, eight sessions fed hop by hop decide
    every window as offline ``api.predict`` and the digital TM do, with
    one ``imbue_infer_planes`` launch a dispatch and no fallback."""
    from repro_torch import api
    from repro_torch.core.booleanize import StreamingBooleanizer
    from repro_torch.serve import AsyncServeEngine, ServeEngine
    cls = AsyncServeEngine if engine == "async" else ServeEngine
    server, cfg, ta, streams = _stream_setup(cuda, cls, routing,
                                             VariationConfig.nominal())
    eng = server.engine
    assert eng.backend.name == "analog-cuda-packed2"
    launches0 = imbue_infer_planes.launches
    _stream_rounds(server, streams, KWS_STREAM["hop"])
    s = eng.summary()
    assert imbue_infer_planes.launches - launches0 == s["batches"]
    assert s["fallback_dispatches"] == 0
    sb = StreamingBooleanizer(server.booleanizer, KWS_STREAM["window"],
                              KWS_STREAM["hop"])
    seen = set()
    for i, frames in enumerate(streams):
        rows = torch.from_numpy(sb.transform_offline(frames)).to(cuda)
        got = [d.pred for d in server.sessions[f"s{i}"].decisions]
        assert got == api.predict(eng.state, rows).tolist()
        assert got == tm.predict(ta.to(cuda), rows, cfg).tolist()
        seen.update(got)
    assert len(seen) > 1


@pytest.mark.parametrize("routing", ["round_robin", "ensemble"])
def test_stream_sync_equals_async_under_c2c_on_the_card(cuda, routing):
    """Under D2D + C2C, the sync and the async engine on one seed give
    every session bit-equal decisions (preds, keywords, versions)."""
    from repro_torch.serve import AsyncServeEngine, ServeEngine
    out = {}
    for cls in (ServeEngine, AsyncServeEngine):
        server, _, _, streams = _stream_setup(
            cuda, cls, routing, VariationConfig(csa_offset=False))
        _stream_rounds(server, streams, KWS_STREAM["hop"])
        out[cls.__name__] = {
            sid: [(d.index, d.pred, d.keyword, d.version)
                  for d in sess.decisions]
            for sid, sess in server.sessions.items()}
        assert server.summary()["fallback_dispatches"] == 0
    assert out["AsyncServeEngine"] == out["ServeEngine"]
    assert sum(map(len, out["ServeEngine"].values())) == 8 * 15


# ------------------------------------------------------- tile overrides

ANALOG_KERNELS = ("imbue_infer_planes", "imbue_infer_packed", "imbue_infer")
ANALOG_TILES = [{}] + [{"ks": ks, "ng": ng} for ng in (1, 2, 4)
                       for ks in (1, 2, 4, 8)]
TM_TILES = [{}] + [{"wm": wm, "wn": wn} for wm in (1, 2, 4)
                   for wn in (1, 2, 4)]


def _tile_id(t):
    return "-".join(f"{k}{v}" for k, v in sorted(t.items())) or "auto"


def _analog_tile_args(name, f, b, r, dev, device):
    cfg = _analog_config(f)
    rng = np.random.default_rng(f + b + r)
    inc = torch.from_numpy(rng.random((cfg.n_clauses, cfg.n_literals))
                           < 4.0 / cfg.n_literals).to(device)
    x = torch.from_numpy((rng.random((b, f)) < 0.5).astype(np.uint8))
    if name == "imbue_infer_planes":
        return _planes_args(cfg, inc, x, r, dev, b, device)
    return _dense_args(name, cfg, inc, x, r, dev, b, device)


@pytest.mark.parametrize("tiles", ANALOG_TILES, ids=_tile_id)
@pytest.mark.parametrize("name", ANALOG_KERNELS)
@pytest.mark.parametrize("f,b,r,dev", [
    (37, 13, 3, True),            # 3 columns: ks 4 and 8 are refused
    (300, 70, 4, True), (300, 33, 1, False),
    (F_MNIST, 8, 1, False),       # ng = 4: one live row group of four
    (F_MNIST, 129, 4, True)])
def test_analog_kernels_exact_at_every_tile(cuda, tiles, name, f, b, r, dev):
    """Each analog kernel at every tile override equals its plain version
    (and its own "auto" launch); a ks past the columns raises before
    launching."""
    args = _analog_tile_args(name, f, b, r, dev, cuda)
    wrapper = getattr(imbue_infer, name)
    before = wrapper.launches
    if tiles.get("ks", 0) > -(-2 * f // 32):
        with pytest.raises(ValueError, match="tile"):
            wrapper(*args, tiles=tiles)
        assert wrapper.launches == before
        return
    got = wrapper(*args, tiles=tiles)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = getattr(imbue_infer, f"{name}_ref")(*args)
    assert torch.equal(got, want) and int((want != 0).sum()) > 0
    if tiles:
        geo = imbue_infer.launch_geometry(
            name, got.shape[0], b, args[3].shape[0],
            args[2].shape[2] if name != "imbue_infer_planes"
            else args[4].l_valid, dev, tiles)
        assert geo["column_splits"] == tiles["ks"]
        assert geo["row_groups"] == tiles["ng"]
        assert geo["grid"] == [-(-b // (32 * tiles["ng"])),
                               -(-args[3].shape[0] // 32), got.shape[0]]


@pytest.mark.parametrize("tiles", TM_TILES, ids=_tile_id)
@pytest.mark.parametrize("name", TM_KERNELS)
@pytest.mark.parametrize("b,c,f,m,case", [
    (13, 37, 50, 5, "mixed"), (129, 2000, 784, 10, "mixed"),
    (8, 1000, 784, 10, "mixed"),  # wm = 4: three row tiles past B
    (5, 5000, 5000, 3, "mixed"),  # K in chunks
    (9, 70, 51, 3, "fire")])
def test_tm_kernels_exact_at_every_tile(cuda, tiles, name, b, c, f, m, case):
    """Each fused TM kernel at every tile override equals its plain
    version, and its geometry reports the override."""
    args = _tm_case(name, b, c, f, m, case, cuda)
    wrapper = getattr(clause_eval, name)
    before = wrapper.launches
    got = wrapper(*args, tiles=tiles)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = getattr(clause_eval, f"{name}_ref")(*args)
    assert torch.equal(got, want) and int((want != 0).sum()) > 0
    geo = clause_eval.launch_geometry(name, b, c, args[0].shape[1], m, tiles)
    if tiles:
        assert geo["row_tile"] == 16 * tiles["wm"]
        assert geo["clause_tile"] == 32 * tiles["wn"]
        ks = geo["k_splits"]
        assert tiles["wm"] * tiles["wn"] * ks <= 32
        if name != "tm_infer":
            assert ks <= max(1, -(-args[0].shape[1] // 8))
        assert geo["threads"] == tiles["wm"] * tiles["wn"] * ks * 32
    assert geo["grid"][0] * geo["row_tile"] >= b
    assert geo["grid"][1] * geo["clause_tile"] >= c


@pytest.mark.parametrize("name,tiles", [
    ("imbue_infer_planes", {"ks": 9, "ng": 1}),
    ("imbue_infer_packed", {"ks": 2, "ng": 3}),
    ("imbue_infer", {"ks": 0, "ng": 2}),
    ("imbue_infer", {"wm": 1, "wn": 1}),
    ("tm_infer_planes", {"wm": 3, "wn": 1}),
    ("tm_infer_packed", {"wm": 1, "wn": 8}),
    ("tm_infer", {"ks": 2, "ng": 1})], ids=str)
def test_invalid_tile_raises_and_does_not_launch(cuda, name, tiles):
    if name.startswith("imbue"):
        args = _analog_tile_args(name, 300, 40, 2, True, cuda)
        wrapper = getattr(imbue_infer, name)
    else:
        args = _tm_case(name, 13, 37, 50, 5, "mixed", cuda)
        wrapper = getattr(clause_eval, name)
    before = wrapper.launches
    with pytest.raises(ValueError, match="tile"):
        wrapper(*args, tiles=tiles)
    torch.cuda.synchronize()
    assert wrapper.launches == before


@pytest.mark.parametrize("name", ANALOG_KERNELS + TM_KERNELS)
def test_launch_exports_refuse_a_bad_tile(cuda, name):
    """The C entries themselves return TILE_INVALID (-1) for a tile outside
    its set, launching nothing, and so does the geometry export."""
    import ctypes
    from repro_torch.kernels import _build
    lib = _build.library(name)
    info = (ctypes.c_int * 9)()
    geometry = getattr(lib, f"{name}_geometry")
    if name.startswith("imbue"):
        shape = ((4, 128, 2000, 49, 1) if name == "imbue_infer_planes"
                 else (4, 128, 2000, 1568))
        assert geometry(*shape, 9, 1, info) == -1
        assert geometry(*shape, 2, 3, info) == -1
        assert geometry(*shape, 50, 1, info) == -1
        assert geometry(*shape, 8, 4, info) == 0
        args = _analog_tile_args(name, 300, 40, 2, True, cuda)
        out = torch.zeros((2, 40, 5), dtype=torch.int32, device=cuda)
        launch = getattr(lib, f"{name}_launch")
        stream = torch.cuda.current_stream().cuda_stream
        if name == "imbue_infer_planes":
            litw, incw, dev, pol, scal = args
            launch.argtypes = imbue_infer._ARGTYPES
            err = launch(litw.data_ptr(), incw.data_ptr(), dev.data_ptr(),
                         pol.data_ptr(), out.data_ptr(), 2, 40,
                         litw.shape[1], pol.shape[0], 5, scal.l_valid,
                         scal.i_ref, scal.v_read, scal.r_lrs, scal.r_hrs,
                         scal.leak_inc, scal.leak_exc, scal.series_factor,
                         9, 1, stream)
        else:
            a, g, leak, pol, i_ref, v_read = args
            launch.argtypes = imbue_infer._DENSE_ARGTYPES
            err = launch(a.data_ptr(), g.data_ptr(), leak.data_ptr(),
                         pol.data_ptr(), out.data_ptr(), 2, 40, g.shape[2],
                         g.shape[1], 5, i_ref, v_read, 9, 1, stream)
    else:
        assert geometry(128, 1000, 49, 10, 3, 1, info) == -1
        assert geometry(128, 1000, 49, 10, 1, 8, info) == -1
        assert geometry(128, 1000, 49, 10, 4, 4, info) == 0
        a, inc, comb = _tm_case(name, 13, 37, 50, 5, "mixed", cuda)
        out = torch.zeros((13, 5), dtype=torch.int32, device=cuda)
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = clause_eval._ARGTYPES
        err = launch(a.data_ptr(), inc.data_ptr(), comb.data_ptr(),
                     out.data_ptr(), 13, a.shape[1], 37, 5, 3, 1,
                     torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == -1
    assert int(out.abs().sum()) == 0          # nothing ran

