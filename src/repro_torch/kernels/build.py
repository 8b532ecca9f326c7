"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under ``csrc/`` is compiled on first use into a shared library
with a plain C interface, ``build/lib<stem>-<hash>.so`` beside this module
(``build/`` is git-ignored), for ``sm_90a``.  The file name carries a hash of
the source, the ``csrc/`` headers it includes and the flags, so an edited
source or header is rebuilt and an unchanged one is loaded as it is.
:func:`build_all` starts one ``nvcc`` per source at once.

Nothing here runs at import: the CPU tests import every module of the port,
and this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
SOURCES = ("gossip_mix", "quantized_gossip_mix", "sparse_segment_mix",
           "linear_recurrence", "flash_attention", "decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCAL_INCLUDE = re.compile(rb'^\s*#include\s+"([^"]+)"', re.MULTILINE)
_LIBS: dict = {}        # stem -> loaded ctypes.CDLL (one load per process)
BUILD_SECONDS: dict = {}  # stem -> wall seconds of the nvcc run that built it


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin): the CUDA kernels cannot be "
                           "built on this machine")
    return found


def library_path(stem: str) -> Path:
    src = (CSRC / f"{stem}.cu").read_bytes()
    for name in _LOCAL_INCLUDE.findall(src):
        src += (CSRC / name.decode()).read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{stem}-{tag}.so"


def _start(stem: str):
    """Start nvcc for ``stem`` unless its library exists; returns
    (process, temporary output, final path, start time) or None."""
    path = library_path(stem)
    if path.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, path, time.perf_counter()


def build_all(stems=SOURCES) -> dict:
    """Compile every missing library in parallel; raise on a failed build.
    Returns {stem: path}.  The compiler's output (``-Xptxas -v``: registers,
    shared memory, spills) is kept in ``build/<stem>.log``."""
    started = {stem: _start(stem) for stem in stems}
    for stem, job in started.items():
        if job is None:
            continue
        proc, tmp, path, t0 = job
        out, _ = proc.communicate()
        BUILD_SECONDS[stem] = time.perf_counter() - t0
        (BUILD_DIR / f"{stem}.log").write_text(out)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {stem}.cu "
                               f"(exit {proc.returncode}):\n{out}")
        os.replace(tmp, path)  # atomic: a half-written library is never seen
    return {stem: library_path(stem) for stem in stems}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<stem>.cu``, built first if needed."""
    lib = _LIBS.get(stem)
    if lib is None:
        path = build_all((stem,))[stem]
        lib = ctypes.CDLL(str(path))
        _LIBS[stem] = lib
    return lib
