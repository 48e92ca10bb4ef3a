"""ctypes bindings for the native (C++) image loader, built on demand.
Counterpart of gsplat_tpu/native/__init__.py, with the same functions and
fallback semantics.

``loader.cpp`` compiles with the system's g++ against libjpeg and libpng
at first use, into ``build/native/libgsplat_loader-<hash>.so`` at the
repository root (a directory git ignores), the hash covering the source
and the flags, so an edited source builds anew. Nothing is built when the
module is imported; a library that does not load (one built on another
machine) is built once more. ``available()`` is False when the build or
the load fails (its error is printed once) or when
``GSPLAT_NATIVE_LOADER=0``; the callers (scene/cameras.py) then decode
with PIL.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-ljpeg", "-lpng"]
_lock = threading.Lock()
_lib = None
_tried = False
build_error = None     # a failed build's output (or load error), or None


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes()
                       + " ".join(FLAGS + LIBS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libgsplat_loader-{h}.so"


def _build(out: Path) -> bool:
    global build_error
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(SRC), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        build_error = str(e)
    else:
        if proc.returncode == 0:
            os.replace(tmp, out)
            return True
        build_error = proc.stderr[:2000]
    tmp.unlink(missing_ok=True)
    print(f"[gsplat_tpu_torch.native] build failed:\n{build_error}")
    return False


def _load():
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        built = not path.exists()
        if built and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            # a library built on another machine may not load here: build
            # it once more before giving up
            if built or not _build(path):
                build_error = build_error or f"load failed: {e}"
                print(f"[gsplat_tpu_torch.native] load failed: {e}")
                return None
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e2:
                build_error = f"load failed: {e2}"
                print(f"[gsplat_tpu_torch.native] {build_error}")
                return None
        lib.gs_image_size.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.gs_image_size.restype = ctypes.c_int
        lib.gs_decode_image.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float)]
        lib.gs_decode_image.restype = ctypes.c_int
        lib.gs_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.gs_decode_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return (os.environ.get("GSPLAT_NATIVE_LOADER", "1") != "0"
            and _load() is not None)


def image_size(path: str):
    """(width, height) or None."""
    lib = _load()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.gs_image_size(path.encode(), ctypes.byref(w),
                         ctypes.byref(h)) != 0:
        return None
    return w.value, h.value


def decode_image(path: str, out_w: int, out_h: int):
    """float32 (4, out_h, out_w) RGBA in [0,1] + has_alpha flag, or None."""
    lib = _load()
    if lib is None:
        return None
    buf = np.empty((4, out_h, out_w), np.float32)
    rc = lib.gs_decode_image(
        path.encode(), out_w, out_h,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc < 0:
        return None
    return buf, bool(rc)


def decode_batch(paths, out_w: int, out_h: int, n_threads: int = 0):
    """float32 (N, 4, out_h, out_w) + has_alpha (N,) bool, or None: the
    whole camera set decoded across a thread pool."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    buf = np.empty((n, 4, out_h, out_w), np.float32)
    flags = np.empty((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.gs_decode_batch(
        arr, n, out_w, out_h,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        flags.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads)
    if failures:
        return None
    return buf, flags.astype(bool)
