"""Generate ``docs/backends_torch.md`` from the port's live capability
registry (port of ``repro.api.doctable``).

The port's backend table is generated, never edited by hand:
``python -m repro_torch.api.doctable`` renders every registered backend
(name, priority, state types, capabilities, and the shape buckets of the
committed tuning table with the device each was measured on) to
markdown, and ``tests/test_torch_doctable.py`` holds the committed file
to the live registry: a new backend cannot land without its row, and a
stale row cannot survive a registry or table change.

  PYTHONPATH=src python -m repro_torch.api.doctable            # write
  PYTHONPATH=src python -m repro_torch.api.doctable --check    # no write
  PYTHONPATH=src python -m repro_torch.api.doctable --stdout   # print
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
DEFAULT_OUT = os.path.join(REPO, "docs", "backends_torch.md")

HEADER = """\
# Backend registry of the PyTorch port

<!-- GENERATED FILE - do not edit by hand.
     Regenerate with: PYTHONPATH=src python -m repro_torch.api.doctable
     tests/test_torch_doctable.py fails when this file drifts from the
     live registry. -->

Every inference path of `src/repro_torch/` is a **backend**: one callable
with the uniform signature `class_sums(state, lits, generator) -> [..., M]`,
registered in `repro_torch.api.registry` with the state types it accepts,
the physics it models (capabilities) and a selection priority.
`api.select_backend(state, generator=...)` picks the highest-priority
backend whose capabilities cover what the state's noise configuration
*requires*, and reports a loud, inspectable fallback
(`Selection.fell_back` / `fallback_reason`) when a preferred backend
cannot honour the requested physics.  The JAX reference's table is
`docs/backends.md`.

Tuned shape buckets come from the committed measured tuning table
(`src/repro_torch/kernels/tuning_table.json`, regenerated on the card by
`python -m benchmarks.kernel_bench_torch`), each with the device it was
measured on: an entry applies only on that device
(`api.get_tuning`).  `-` means the backend takes no kernel tiles (not
a fused kernel) or has no measured entry yet (it runs on its kernel's
own geometry, or one lazy measurement with `EngineConfig.lazy_tune`).
"""


def _doc_first_line(fn) -> str:
    doc = (fn.__doc__ or "").strip()
    return doc.split("\n")[0].rstrip() if doc else ""


def _tuned(shapes: dict) -> str:
    """``shape_key (device)`` for each entry of one backend, sorted."""
    return ", ".join(
        f"{skey} ({e.get('device_name') or e.get('platform') or '?'})"
        for skey, e in sorted(shapes.items())) or "-"


def render() -> str:
    """The full markdown document for the current registry and table."""
    from repro_torch import api
    from repro_torch.kernels import autotune

    try:
        table = autotune.normalize_table(
            autotune.load_table(autotune.DEFAULT_TABLE_PATH))
    except (OSError, ValueError):
        table = {}

    lines = [HEADER]
    lines.append("| backend | priority | state types | capabilities | "
                 "tuned buckets (device) |")
    lines.append("|---|---|---|---|---|")
    for b in api.list_backends():
        states = ", ".join(t.__name__ for t in b.state_types)
        caps = ", ".join(f"`{c}`" for c in sorted(b.capabilities))
        lines.append(f"| `{b.name}` | {b.priority} | {states} | {caps} | "
                     f"{_tuned(table.get(b.name, {}))} |")
    lines.append("")
    lines.append("## What each backend is\n")
    for b in api.list_backends():
        first = _doc_first_line(b.fn)
        gate = (" Selection-gated: only eligible when the state is in "
                "its packed form (`predicate`)." if b.predicate else "")
        lines.append(f"- **`{b.name}`** (priority {b.priority}): "
                     f"{first}{gate}")
    lines.append("")
    lines.append("## Capability glossary\n")
    for cap in sorted(api.KNOWN_CAPABILITIES):
        lines.append(f"- `{cap}`")
    lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if the committed file differs from the "
                         "live registry render (drift gate)")
    ap.add_argument("--stdout", action="store_true",
                    help="print the render instead of writing")
    args = ap.parse_args(argv)
    text = render()
    if args.stdout:
        sys.stdout.write(text)
        return 0
    if args.check:
        try:
            with open(args.out) as f:
                committed = f.read()
        except OSError:
            print(f"[doctable] DRIFT: {args.out} missing")
            return 1
        if committed != text:
            print(f"[doctable] DRIFT: {args.out} does not match the "
                  "live registry; regenerate with "
                  "PYTHONPATH=src python -m repro_torch.api.doctable")
            return 1
        print(f"[doctable] OK: {args.out} matches the registry")
        return 0
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)
    print(f"[doctable] wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
