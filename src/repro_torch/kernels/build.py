"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` compiles on first use into a shared library with a
plain C interface, ``_build/<name>-<hash>.so`` next to this file (the
directory is git-ignored), and is loaded through ``ctypes``.  The hash
covers the source and the flags, so an edited source is rebuilt.  Only
the sources in this package are built.

``launches`` counts the kernels' launches by kernel: each wrapper calls
:func:`count` where it launches.  A launch on a stream listed in
``recording`` (a CUDA graph's capture, or the warm-up before it) is
added to that stream's record instead; a graph's replays then add its
record (:mod:`repro_torch.core.graph`).  These libraries carry nvcc's
static CUDA runtime, and their launches are captured into a graph like
PyTorch's own (``tests/test_torch_cuda.py`` replays them bit for bit).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Per-source flags.  No source is compiled with --use_fast_math: divisions
# and square roots must round the IEEE way.
EXTRA_FLAGS = {
    # Unfused products, as in the plain version (see the source's note).
    "costmodel_eval": ["-fmad=false"],
    "lstm_cell": [],
    "flash_decode": [],
}
SOURCES = tuple(EXTRA_FLAGS)

_libs: Dict[str, ctypes.CDLL] = {}
_raw_stream = None
# Threads that launch a kernel for the first time at once build it once.
_load_lock = threading.Lock()

KERNELS = ("cost_eval", "cost_eval_multi", "lstm_cell", "lstm_cell_bwd",
           "flash_decode", "flash_decode_combine", "flash_decode_partials")
launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
# Raw stream handle -> {kernel: launches} recorded on it.
recording: Dict[int, Dict[str, int]] = {}
# Worker and dispatcher threads of the search service launch concurrently.
_count_lock = threading.Lock()


def count(kernel: str, stream: int) -> None:
    """Count one launch of ``kernel`` on the raw stream ``stream``, or
    record it if that stream is in ``recording``."""
    with _count_lock:
        rec = recording.get(stream)
        if rec is None:
            launches[kernel] += 1
        else:
            rec[kernel] = rec.get(kernel, 0) + 1


def add_launches(counts: Dict[str, int]) -> None:
    """Count each kernel's launches in ``counts`` (a replay's record)."""
    with _count_lock:
        for kernel, n in counts.items():
            launches[kernel] += n


def reset_launches() -> None:
    with _count_lock:
        for kernel in launches:
            launches[kernel] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit (nvcc on PATH or under "
                           "/usr/local/cuda/bin)")
    return path


def _flags(name: str):
    return FLAGS + EXTRA_FLAGS[name]


def lib_path(name: str) -> Path:
    """Where the library of source ``name`` lives for its current hash."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every listed source whose library is missing, in parallel.

    One ``nvcc`` per source, all started together.  Returns the seconds
    each build took (0.0 where the library was already there); the
    compiler's register and shared-memory report lands in
    ``_build/<name>.log``.  Raises on any failed build.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        if name not in EXTRA_FLAGS:
            raise ValueError(f"unknown kernel source {name!r}")
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed."""
    with _load_lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
    return lib


def check_inputs(tensors, names, shapes):
    """Raise unless every tensor is a contiguous float32 CUDA tensor of its
    shape, all on one card; return their data pointers and the card's
    index, for one kernel launch.  One pass, one query of each property."""
    import torch

    ptrs = []
    index = None
    for t, name, shape in zip(tensors, names, shapes):
        d = t.get_device()
        if d < 0:
            raise ValueError(f"{name}: expected a CUDA tensor")
        if index is None:
            index = d
        elif d != index:
            raise ValueError(f"{name}: on cuda:{d}, expected cuda:{index}")
        if t.dtype is not torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, expected float32")
        if t.shape != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        ptrs.append(t.data_ptr())
    return ptrs, index


def stream(index: int) -> int:
    """The raw handle of PyTorch's current stream on card ``index``, taken
    without building a ``torch.cuda.Stream`` object where PyTorch offers
    that call (its CUDA builds do)."""
    global _raw_stream
    if _raw_stream is None:
        import torch

        _raw_stream = getattr(
            torch._C, "_cuda_getCurrentRawStream",
            lambda i: torch.cuda.current_stream(i).cuda_stream)
    return _raw_stream(index)


def build_log(name: str) -> str:
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""
