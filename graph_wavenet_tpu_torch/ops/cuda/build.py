"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``. Libraries go to
``graph_wavenet_tpu_torch/_build/`` (git-ignored), named by a digest of
the sources, so an edited source rebuilds and an unchanged one loads
as is. All sources compile in parallel, one ``nvcc`` each, at first use;
processes that share ``_build/`` (the ranks of a parallel run) take turns
through a file lock, so one builds and the others load.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("mix_flat.cu", "mix_flat2.cu", "outer_flat.cu", "mix_padded.cu",
           "outer_padded.cu", "chan_proj.cu", "bn_tail.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas resource report of the last build, per source (registers, spills)
build_log: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME and /usr/local/cuda); "
        "the CUDA kernels are built from csrc/ at first use")


def _lib_path(source: str) -> Path:
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build_all() -> float:
    """Compile every source whose library is missing, all at once; returns
    the seconds taken. Raises with nvcc's output if any build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [s for s in SOURCES if not _lib_path(s).exists()]
        if todo:
            _compile(todo)
    return time.perf_counter() - t0


def _compile(todo: list[str]) -> None:
    nvcc = _nvcc()
    procs = []
    for src in todo:
        out = _lib_path(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_log[src] = log
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one ``csrc`` source, built on first use."""
    with _lock:
        if source not in _libs:
            path = _lib_path(source)
            if not path.exists():
                build_all()
            _libs[source] = ctypes.CDLL(str(path))
        return _libs[source]
