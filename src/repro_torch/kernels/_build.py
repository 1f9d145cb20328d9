"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface,
compiled by ``nvcc`` for Hopper into a shared library and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  A source may
include the shared headers of ``csrc/`` (``*.cuh``).  Libraries go to
``kernels/.build/<name>-<hash>/``, keyed by a hash of the source, the
headers and the flags, so an edited source or header rebuilds and an
unchanged one is reused.
``.build/`` is listed in ``.gitignore``: the library is built at first
use, on the machine with the card.

There is no quiet way around a failed build: :func:`build` raises with
the compiler's output, and the wrappers have no fallback for CUDA
tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

from repro_torch.trace import span

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_ROOT = _HERE / ".build"

# IEEE division and comparisons are part of the kernels' contract: never
# --use_fast_math.  -Xptxas -v records registers/spills in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def source_path(name: str) -> Path:
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    """Where ``name``'s library goes, keyed by its source, every header in
    ``csrc/`` (a source may include any of them, so an edited header
    rebuilds) and the flags."""
    h = hashlib.sha256(source_path(name).read_bytes())
    for header in sorted([*CSRC.glob("*.cuh"), *CSRC.glob("*.h")]):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every kernel in ``names`` whose library is missing, one
    ``nvcc`` per source, all started together.  Returns the seconds each
    build took (0.0 for a library already built).  Raises RuntimeError
    with the compiler output if any build fails.  The ``nvcc`` runs sit
    in one ``repro_torch.kernels.build`` span."""
    secs: Dict[str, float] = {}
    missing = []
    for name in dict.fromkeys(names):
        lib = library_path(name)
        if lib.exists():
            secs[name] = 0.0
        else:
            missing.append((name, lib))
    if not missing:
        return secs
    failed = []
    with span("repro_torch.kernels.build"):
        procs = {}
        for name, lib in missing:
            lib.parent.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(source_path(name))]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, lib, time.perf_counter())
        for name, (proc, tmp, lib, t0) in procs.items():
            log, _ = proc.communicate()
            secs[name] = time.perf_counter() - t0
            (lib.parent / "build.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
                continue
            os.replace(tmp, lib)      # atomic: no reader sees a partial .so
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return secs


def build_log(name: str) -> str:
    """The compiler output (incl. ptxas register/spill lines) of the
    library :func:`library_path` names, or "" if it was not built here."""
    log = library_path(name).parent / "build.log"
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The kernel's library, built at first use."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def load(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """``<name>_launch`` from the kernel's library (built at first use),
    with its ``argtypes`` declared and an ``int`` (CUDA error) result."""
    fn = getattr(library(name), f"{name}_launch")
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
