"""Host ranks for ``--host-devices N`` (port of ``repro.launch.hostdev``).

The reference forces N CPU devices into one jax process.  Here a mesh is
one process a rank, so ``--host-devices N`` runs an entry point's
``main(argv)`` in N spawned host processes joined in a gloo process group
(rendezvous through a ``file://`` store in a fresh temporary directory,
``torch.set_num_threads(1)`` in each), every rank running the same
program on the same seeds; the entry points print on rank 0 only
(:func:`rank0_print`).  ``launched_group`` joins the group that
``torch.distributed.run`` describes, for the same entry points on the
card.  This module imports
nothing heavy at load time, so it is safe at the very top of an entry
point.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
from typing import Callable, Optional, Sequence

FLAG = "--host-devices"


def parse_host_devices(argv: Sequence[str]) -> Optional[int]:
    """The value of ``--host-devices N`` / ``--host-devices=N`` in
    ``argv``, or None.  Malformed forms (missing or non-integer value)
    return None and are left for argparse to reject with a real usage
    error."""
    value = None
    for i, tok in enumerate(argv):
        if tok == FLAG and i + 1 < len(argv):
            value = argv[i + 1]
        elif tok.startswith(FLAG + "="):
            value = tok.split("=", 1)[1]
    if value is None:
        return None
    try:
        return int(value)
    except ValueError:
        return None


def strip_host_devices(argv: Sequence[str]) -> list:
    """``argv`` without ``--host-devices`` and its value."""
    out, skip = [], False
    for tok in argv:
        if skip:
            skip = False
        elif tok == FLAG:
            skip = True
        elif not tok.startswith(FLAG + "="):
            out.append(tok)
    return out


def _rank(rank: int, world: int, init_file: str, fn: Callable,
          args: tuple) -> None:
    """One host rank: join the group, run ``fn(*args)``, leave.  An
    exception exits the process non-zero (multiprocessing prints it); a
    ``SystemExit`` keeps its code."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        code = fn(*args)
    finally:
        dist.destroy_process_group()
    if isinstance(code, int) and code:
        sys.exit(code)


def run_host_ranks(fn: Callable, n: int, args: tuple = (), *,
                   rdzv_dir: Optional[str] = None,
                   timeout: Optional[float] = None) -> int:
    """Run ``fn(*args)`` in ``n`` spawned host ranks of one gloo group and
    return rank 0's exit code; raise if any rank fails (the others are then
    stopped: they may wait on it in a collective) or the ranks outlive
    ``timeout`` seconds.  ``fn`` and ``args`` are pickled (``fn`` by its
    import path); the rendezvous file goes under ``rdzv_dir`` (default: a
    fresh temporary directory)."""
    import multiprocessing
    import multiprocessing.connection
    import time

    if n < 1:
        raise ValueError(f"{FLAG} must be >= 1, got {n}")
    ctx = multiprocessing.get_context("spawn")
    init_file = os.path.join(rdzv_dir or tempfile.mkdtemp(prefix="hostdev-"),
                             "rendezvous")
    procs = [ctx.Process(target=_rank, args=(r, n, init_file, fn, args))
             for r in range(n)]
    deadline = None if timeout is None else time.monotonic() + timeout
    for p in procs:
        p.start()
    try:
        while any(p.is_alive() for p in procs) and \
                not any(p.exitcode for p in procs):
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                break
            # A sentinel can stay unready after its rank exits (a process
            # it started may hold the pipe), so the ranks are polled too.
            multiprocessing.connection.wait(
                [p.sentinel for p in procs if p.is_alive()],
                1.0 if left is None else min(left, 1.0))
    finally:
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    codes = [p.exitcode for p in procs]
    if alive or any(codes):
        raise RuntimeError(
            f"host ranks failed: exit codes {codes}"
            + (f", ranks {alive} stopped while running" if alive else ""))
    return codes[0]


def run_main(main: Callable, argv: Sequence[str]) -> Optional[int]:
    """``main(argv)`` on ``--host-devices N`` host ranks (the flag taken
    out of ``argv``) when the flag is given and no process group is up;
    None otherwise, and the caller runs on."""
    n = parse_host_devices(argv)
    if n is None:
        return None
    import torch.distributed as dist
    if dist.is_initialized():
        return None
    return run_host_ranks(main, n, (strip_host_devices(argv),))


@contextlib.contextmanager
def launched_group():
    """Inside the block, the gloo process group that a launcher such as
    ``torch.distributed.run`` describes in the environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), joined on entry and
    left on exit; nothing when no launcher set it or a group is up.  Gloo,
    because NCCL refuses two ranks on one card."""
    import torch.distributed as dist
    join = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if join:
        dist.init_process_group("gloo")
    try:
        yield
    finally:
        if join:
            dist.destroy_process_group()


def shared_tempdir(prefix: str) -> str:
    """A fresh temporary directory, rank 0's on every rank of an
    initialised group (a checkpoint is written by rank 0 and read by all)."""
    path = tempfile.mkdtemp(prefix=prefix)
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return path
    box = [path]
    dist.broadcast_object_list(box, src=0)
    if box[0] != path:
        os.rmdir(path)
    return box[0]


def is_rank0() -> bool:
    """True on rank 0 of an initialised group, or without one."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def rank0_print(*args, **kw) -> None:
    """``print`` on rank 0 of an initialised group (or without one)."""
    if is_rank0():
        print(*args, **kw)
