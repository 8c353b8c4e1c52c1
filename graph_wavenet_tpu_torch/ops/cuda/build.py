"""The seam of the hand kernels: how each is built, loaded, launched,
registered as an op and counted.

Build: each ``csrc/*.cu`` source compiles with ``nvcc`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Libraries
go to ``graph_wavenet_tpu_torch/_build/`` (git-ignored), named by a digest
of the sources, so an edited source rebuilds and an unchanged one loads as
is. All sources compile in parallel, one ``nvcc`` each, at first use;
processes that share ``_build/`` (the ranks of a parallel run) take turns
through a file lock, so one builds and the others load.

Launch: every entry a library exports has one signature (``csrc/
entry.cuh``), ``int gwt_<name>(const long long* d, void* stream)``: ``d``
the call's int64 descriptor (sizes, flags and pointers, 0 for an absent
one), the result a ``cudaError_t`` code. :func:`launch` is the one caller:
it passes the descriptor and the current stream of the device, raises on a
non-zero code and counts the op's launch. :func:`sms` keeps each card's SM
count, which the launch plans read.

Register: every kernel is an op of the ``gwt_torch`` namespace (:data:`LIB`,
one ``torch.library`` definition), made with :class:`Op`: its schema, a CPU
kernel (the plain PyTorch version), a CUDA kernel (the launch), a fake
kernel (shapes for tracing, ``torch.export`` and CUDA graph capture) and a
FLOP formula (``torch.utils.flop_counter``). The modules beside this one
define the ops: ``block_diffusion`` (kernels 1-5), ``chan_proj`` and
``bn_tail``.

Count: :data:`LAUNCHES` holds one count per op, by its ``gwt_torch`` name:
the C entry calls since the last :func:`reset_launch_counts`. They are host
counters: a CUDA graph counts its launches once, at capture, and nothing on
replay.
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

import torch
from torch.utils.flop_counter import register_flop_formula

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


_LL = ctypes.c_longlong


def call(lib: ctypes.CDLL, fn: str, desc: list[int],
         device: torch.device) -> None:
    """``lib.fn(desc, stream)`` on ``device``'s current stream; raises
    ``RuntimeError`` with the error string on a non-zero code."""
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = [ctypes.POINTER(_LL), ctypes.c_void_p]
        f.restype = ctypes.c_int
        lib.gwt_error_string.argtypes = [ctypes.c_int]
        lib.gwt_error_string.restype = ctypes.c_char_p
    with torch.cuda.device(device):
        rc = f((_LL * len(desc))(*desc),
               torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = lib.gwt_error_string(rc).decode()
        raise RuntimeError(f"{fn} failed: {msg} ({rc})")


def launch(source: str, fn: str, desc: list[int], device: torch.device,
           op: str | None = None) -> None:
    """Call entry ``fn`` of ``source``'s library with ``desc`` on
    ``device`` and, on success, count one launch of ``op`` (None: a query,
    or a launch outside the ops, not counted)."""
    call(load(source), fn, desc, device)
    if op is not None:
        LAUNCHES[op] += 1


_SMS: dict = {}


def sms(device: torch.device) -> int:
    """The SM count of ``device``'s card, asked once per device."""
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device.index]


# ---------------------------------------------------------------------------
# the ops and their launch counts
# ---------------------------------------------------------------------------

LIB = torch.library.Library("gwt_torch", "DEF")

# C entry calls per op since the last reset_launch_counts()
LAUNCHES: dict[str, int] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Op:
    """One kernel's op: its schema and CPU kernel at construction; the
    decorators register its fake kernel, FLOP formula and CUDA kernel.
    Registered straight with the dispatcher (``torch.library.Library``),
    with no autograd kernel: the autograd functions around the ops call
    them under no-grad, and ``torch.library.custom_op``'s Python autograd
    layer would double the host time of every launch."""

    def __init__(self, name: str, schema: str, cpu):
        LIB.define(name + schema)
        LIB.impl(name, cpu, "CPU")
        LAUNCHES[name] = 0
        self.name = name

    def fake(self, fn):
        torch.library.register_fake(f"gwt_torch::{self.name}", fn, lib=LIB)
        return fn

    def flops(self, fn):
        register_flop_formula(getattr(torch.ops.gwt_torch, self.name))(fn)
        return fn

    def cuda(self, fn):
        LIB.impl(self.name, fn, "CUDA")
        return fn
