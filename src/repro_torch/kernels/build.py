"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` compiles on first use into a shared library with a
plain C interface, ``_build/<name>-<hash>.so`` next to this file (the
directory is git-ignored), and is loaded through ``ctypes``.  The hash
covers the source and the flags, so an edited source is rebuilt.  Only
the sources in this package are built.
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
# Threads that launch a kernel for the first time at once build it once.
_load_lock = threading.Lock()


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


def check_input(t, name: str, shape, device) -> int:
    """Raise unless ``t`` is a contiguous float32 CUDA tensor of ``shape`` on
    ``device``; return its data pointer for a kernel launch."""
    import torch

    if not torch.is_tensor(t) or not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.data_ptr()


def build_log(name: str) -> str:
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""
