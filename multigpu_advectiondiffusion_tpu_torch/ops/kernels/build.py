"""Build the hand-written CUDA kernels at first use and load them.

Each source under ``csrc/`` has a plain C interface and is compiled
by ``nvcc`` into its own shared library, for ``ctypes`` to load — no
PyTorch headers, so a build takes seconds. Libraries go to
``build/kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of the source, the headers it may include
(``csrc/*.cuh``) and the flags (a source may add its own, e.g.
``-fmad=false``), so an edited source, header or flag set is rebuilt
and an unchanged one is reused. Nothing here runs at import
time: the CPU tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


_LAUNCH_LOCK = threading.Lock()
# one lock a library: the shards of a mesh may ask for one at once
_BUILD_LOCKS: dict = {}
_BUILD_GUARD = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (a kernel wrapper's launch count),
    under a lock: the shards of a device mesh launch from threads of
    their own."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1


class Built(NamedTuple):
    path: Path
    seconds: float  # 0.0 when an existing build was reused
    log: str  # nvcc's output (ptxas register/spill report)


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(source: str, extra_flags: tuple = ()) -> Built:
    """Compile ``csrc/<source>`` into a shared library (or reuse it),
    with ``extra_flags`` after the common ones."""
    src = CSRC_DIR / source
    flags = (*NVCC_FLAGS, *extra_flags)
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(flags).encode())
    digest = digest.hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}-{digest}.so"
    with _BUILD_GUARD:
        lock = _BUILD_LOCKS.setdefault(out, threading.Lock())
    with lock:
        return _build(src, flags, out)


def _build(src: Path, flags: tuple, out: Path) -> Built:
    if out.exists():
        return Built(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc(), *flags, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return Built(out, seconds, log)
