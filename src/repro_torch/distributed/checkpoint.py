"""Checkpoints with atomic commit, a content digest and elastic restore
(port of ``repro.distributed.checkpoint``).

Format, byte-compatible with the reference: one ``leaves.npz`` per save
holding every leaf of a tree of dicts / lists / tuples under its path
(``"/"``-joined keys), plus ``manifest.json`` with the step, the leaf
dtypes and an ``extra`` block.  Leaves are stored as numpy arrays, so a
checkpoint written by either package restores in the other.

Durability: a save is written to ``<dir>/tmp-<step>`` and renamed to
``<dir>/step-<step:09d>``; :func:`latest_step` sees committed saves only.

Integrity: ``save`` records a sha256 digest over every leaf (path, dtype,
shape and bytes, in sorted path order) in ``extra["content_digest"]``,
and ``restore`` recomputes and verifies it, raising a typed error for a
missing file, an unreadable manifest or a digest mismatch.  Checkpoints
without a digest still restore.

Leaves are saved whole, keyed by path and never by mesh coordinate, so a
checkpoint written on N ranks restores on M.  Saving a tree with
``DTensor`` leaves gathers them (a collective: every rank calls ``save``),
and in a process group of more than one rank only rank 0 writes, the
others waiting at a barrier until the save is committed.  Leaves restore
as tensors on ``device`` (default ``cuda``), or with ``shardings`` (a
tree of ``sharding.NamedSharding`` matching ``like``, e.g.
``sharding.tree_shardings``) as ``DTensor``s of this rank's blocks on
their meshes.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.distributed import sharding

DIGEST_KEY = "content_digest"


class CheckpointError(Exception):
    """Base of the restore failures; each subclass also inherits the
    builtin type callers may already catch."""


class CheckpointMissingError(CheckpointError, FileNotFoundError):
    """A required checkpoint file (array blob or manifest) is absent."""


class CheckpointManifestError(CheckpointError, ValueError):
    """The manifest exists but cannot be parsed (truncated/garbled)."""


class CheckpointDigestError(CheckpointError, ValueError):
    """The leaves do not match the manifest's content digest."""


def content_digest(arrays: Dict[str, np.ndarray]) -> str:
    """sha256 over the flattened leaves: path, dtype, shape and raw bytes
    in sorted path order."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _flatten(tree) -> dict:
    flat = {}

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + (str(k),), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(path + (str(i),), v)
        elif node is not None:
            flat["/".join(path)] = node
    walk((), tree)
    return flat


def _unflatten_into(tree, flat: dict):
    """Rebuild ``tree``'s structure with leaves from ``flat``."""
    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + (str(k),), v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(path + (str(i),), v) for i, v in enumerate(node)]
        if isinstance(node, tuple):
            return tuple(walk(path + (str(i),), v)
                         for i, v in enumerate(node))
        if node is None:
            return None
        key = "/".join(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        return flat[key]
    return walk((), tree)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return sharding.gather(leaf.detach()).cpu().numpy()
    return np.asarray(leaf)


def _place(tree, shardings):
    """``tree``'s leaves placed per the matching ``shardings`` leaves (a
    ``None`` sharding leaves its leaf as it is)."""
    if isinstance(tree, dict):
        return {k: _place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, s) for v, s in zip(tree, shardings))
    return tree if shardings is None else shardings.place(tree)


def save(ckpt_dir: str, step: int, tree: Any, *, extra: dict = None,
         keep: int = 3) -> str:
    """Atomic checkpoint save of ``tree`` (tensors, arrays or scalars as
    leaves); returns the committed directory.  Keeps the newest ``keep``
    steps."""
    final = os.path.join(ckpt_dir, f"step-{step:09d}")
    arrays = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    ranks = sharding.world_size()
    if ranks == 1 or dist.get_rank() == 0:
        _write(ckpt_dir, step, final, arrays, extra, keep)
    if ranks > 1:
        dist.barrier()
    return final


def _write(ckpt_dir: str, step: int, final: str, arrays: dict,
           extra: Optional[dict], keep: int) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp-{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "leaves.npz"), **arrays)
    extra = dict(extra or {})
    extra[DIGEST_KEY] = content_digest(arrays)
    manifest = {"step": step, "extra": extra,
                "leaves": {k: str(v.dtype) for k, v in arrays.items()}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic commit
    _gc(ckpt_dir, keep)


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step-"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("-")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step-")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any,
            device: DeviceLike = None,
            shardings: Any = None) -> Tuple[Any, dict]:
    """``(tree, manifest)``: the leaves of step ``step`` in the structure
    of ``like``, as tensors on ``device``, after the digest check; with
    ``shardings`` placed on their meshes (the elastic path: any mesh
    works)."""
    device = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step-{step:09d}")
    leaves_path = os.path.join(path, "leaves.npz")
    manifest_path = os.path.join(path, "manifest.json")
    try:
        with np.load(leaves_path) as z:
            flat = {k: z[k] for k in z.files}
    except FileNotFoundError as e:
        raise CheckpointMissingError(
            f"checkpoint {path} has no array blob ({leaves_path}): the "
            "save was removed or never committed") from e
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except FileNotFoundError as e:
        raise CheckpointMissingError(
            f"checkpoint {path} has no manifest ({manifest_path}): the "
            "save was removed or never committed") from e
    except json.JSONDecodeError as e:
        raise CheckpointManifestError(
            f"checkpoint {path} manifest is unreadable ({e}): the file "
            "is truncated or garbled — refusing to restore") from e
    expected = manifest.get("extra", {}).get(DIGEST_KEY)
    if expected is not None:
        actual = content_digest(flat)
        if actual != expected:
            raise CheckpointDigestError(
                f"checkpoint {path} failed content-digest verification "
                f"(manifest {expected[:12]}…, leaves {actual[:12]}…): "
                "the snapshot is truncated or corrupted — refusing to "
                "restore it")
    tensors = {k: torch.from_numpy(np.array(v)).to(device)
               for k, v in flat.items()}
    tree = _unflatten_into(like, tensors)
    if shardings is not None:
        tree = _place(tree, shardings)
    return tree, manifest


def restore_latest(ckpt_dir: str, like: Any, device: DeviceLike = None,
                   shardings: Any = None):
    """``(step, tree, manifest)`` of the newest committed save, or None."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    tree, manifest = restore(ckpt_dir, step, like, device, shardings)
    return step, tree, manifest
