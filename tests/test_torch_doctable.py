"""Docs drift gate for the port: ``docs/backends_torch.md`` must match the
port's live registry and its committed tuning table (port of
``tests/test_doctable.py``).

The port's backend table is generated, never edited by hand
(``python -m repro_torch.api.doctable``), so a new backend registration
without its row, a hand edit, or a table regeneration without the
regenerated docs fails here.  ``docs/backends.md`` is the reference's
and is not touched.
"""

import os

import pytest

pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.api import doctable  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402


def test_backends_torch_md_matches_live_registry():
    assert os.path.exists(doctable.DEFAULT_OUT), (
        f"missing {doctable.DEFAULT_OUT}; generate it with "
        "`PYTHONPATH=src python -m repro_torch.api.doctable`")
    with open(doctable.DEFAULT_OUT) as f:
        committed = f.read()
    assert committed == doctable.render(), (
        "docs/backends_torch.md has drifted from the live backend registry; "
        "regenerate with `PYTHONPATH=src python -m repro_torch.api.doctable` "
        "(never edit it by hand)")


def test_doctable_mentions_every_registered_backend():
    """Every registry name has its row (localises a missing row to the
    backend that lacks it)."""
    text = doctable.render()
    for b in api.list_backends():
        assert f"| `{b.name}` |" in text, f"no docs row for {b.name}"
        assert f"- **`{b.name}`**" in text


def test_doctable_names_each_tuned_bucket_with_its_device():
    table = autotune.normalize_table(autotune.load_default_table())
    text = doctable.render()
    for name, shapes in table.items():
        row = next(line for line in text.splitlines()
                   if line.startswith(f"| `{name}` |"))
        for skey, entry in shapes.items():
            assert f"{skey} ({entry['device_name']})" in row


def test_doctable_check_cli(capsys):
    assert doctable.main(["--check"]) == 0
    assert "OK" in capsys.readouterr().out


def test_doctable_check_fails_on_drift(tmp_path, capsys):
    out = tmp_path / "backends_torch.md"
    assert doctable.main(["--check", "--out", str(out)]) == 1
    assert doctable.main(["--out", str(out)]) == 0
    assert doctable.main(["--check", "--out", str(out)]) == 0
    out.write_text(out.read_text() + "hand edit\n")
    assert doctable.main(["--check", "--out", str(out)]) == 1
    assert "DRIFT" in capsys.readouterr().out
