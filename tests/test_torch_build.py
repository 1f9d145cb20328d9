"""The kernel build's cache key: a library is rebuilt when its source, a
shared header of ``csrc/`` or the flags change, and reused otherwise.
Nothing is compiled here (no ``nvcc`` is needed)."""

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("constexpr int TILE = 64;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


def test_edited_header_changes_library_path(csrc):
    before = _build.library_path("k")
    assert before == _build.library_path("k")            # stable
    (csrc / "common.cuh").write_text("constexpr int TILE = 32;\n")
    assert _build.library_path("k") != before


@pytest.mark.parametrize("edit", ("source", "new_header", "flags"))
def test_source_new_header_and_flags_change_library_path(csrc, monkeypatch,
                                                         edit):
    before = _build.library_path("k")
    if edit == "source":
        (csrc / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    elif edit == "new_header":
        (csrc / "other.cuh").write_text("#pragma once\n")
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS",
                            _build.NVCC_FLAGS + ("-lineinfo",))
    after = _build.library_path("k")
    assert after != before
    assert after.name == "libk.so" and after.parent.name.startswith("k-")


def test_every_kernel_source_is_in_csrc():
    names = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert {"imbue_infer_planes", "tm_infer_planes", "tm_infer_packed",
            "tm_infer"} <= names
    assert (_build.CSRC / "tm_common.cuh").exists()
    assert (_build.CSRC / "tm_b1.cuh").exists()
