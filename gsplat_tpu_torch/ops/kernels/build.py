"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/kernels/lib<name>-<hash>.so`` at the repository root (a
directory git ignores), the hash covering the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source builds anew. Sources
build only from this checkout, at first use; nothing is built when a module
is imported. Every function takes ``csrc``, another copy of the sources (an
older commit's, to time beside this one's); the wrappers launch from the
checkout's, or inside ``kernels_from`` from another copy.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
KERNELS = ("composite_fwd", "composite_bwd", "slab_tmit", "scan", "ssim_fwd",
           "ssim_bwd", "preprocess_fwd", "preprocess_bwd", "gather_entries_fwd",
           "gather_entries_bwd")
_csrc = [CSRC]      # the sources the wrappers launch: the last one


@contextlib.contextmanager
def kernels_from(csrc):
    """Inside the block the wrappers build and launch their kernels from
    ``csrc``, another copy of the sources (an older commit's, to hold and
    time beside this checkout's in one process)."""
    _csrc.append(Path(csrc).resolve())
    try:
        yield
    finally:
        _csrc.pop()


def sources() -> Path:
    """The sources the wrappers launch from now."""
    return _csrc[-1]


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str, csrc: Path = CSRC) -> Path:
    src = (csrc / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(csrc.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build(names=KERNELS, csrc: Path = CSRC) -> dict:
    """Compile every named source that has no library yet, one nvcc each,
    all started together. Returns {name: (library path, seconds, ptxas
    report)}, the report kept beside the library for a later call (seconds
    0 for a library that was built already); raises with nvcc's output if
    any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name, csrc)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    report = {}
    for name in names:
        log = library_path(name, csrc).with_suffix(".log")
        report[name] = (library_path(name, csrc), 0.0,
                        log.read_text() if log.exists() else "cached")
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        report[name] = (out, time.perf_counter() - t0, log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return report


@functools.lru_cache(maxsize=None)
def load(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """The kernel library, built first if needed."""
    build((name,), csrc)
    return ctypes.CDLL(str(library_path(name, csrc)))
