"""The tile compositor's dispatch and its CUDA kernel's wrapper.

``composite_tiles`` routes by where the entries lie: a CPU tensor goes to
the plain PyTorch version (ops/composite_ref.py), a CUDA tensor to the
hand-written kernel csrc/composite_fwd.cu, anything else raises. There is no
fallback: on the card the kernel launches or the call raises.

The kernel is forward-only for now (its backward comes with training), so
the wrapper refuses entries that require grad; the plain CPU version stays
differentiable and is the oracle the backward kernel will be held to.
"""
from __future__ import annotations

import ctypes

import torch

from gsplat_tpu_torch.ops.composite_ref import (CompositeOut,
                                                composite_tiles_plain)
from gsplat_tpu_torch.ops.kernels import build

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
              ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
             + [ctypes.c_void_p] * 4)


def _lib():
    lib = build.load("composite_fwd")
    lib.gsplat_composite_fwd.argtypes = _ARGTYPES
    lib.gsplat_composite_fwd.restype = ctypes.c_int
    lib.gsplat_composite_fwd_max_pixels.restype = ctypes.c_int
    return lib


def composite_fwd_cuda(entries: torch.Tensor, tile_start: torch.Tensor,
                       tile_count: torch.Tensor, *, n_tiles_x: int,
                       n_tiles_y: int, tile_h: int, tile_w: int, chunk: int,
                       alpha_min: float, alpha_max: float,
                       t_eps: float) -> CompositeOut:
    """Launch the CUDA compositor on the current stream. entries (M,16) f32,
    tile_start/tile_count (T,) i32 (ranges aligned to ``chunk``), all on one
    CUDA device."""
    T = n_tiles_x * n_tiles_y
    P = tile_h * tile_w
    dev = entries.device
    if dev.type != "cuda":
        raise ValueError(f"composite_fwd_cuda needs CUDA tensors, got {dev}")
    if entries.requires_grad:
        raise RuntimeError(
            "the CUDA compositor is forward-only; render under "
            "torch.no_grad() (the backward kernel comes with training)")
    if entries.dtype != torch.float32 or entries.dim() != 2 \
            or entries.shape[1] != 16:
        raise ValueError(f"entries must be (M,16) float32, got "
                         f"{tuple(entries.shape)} {entries.dtype}")
    for name, tab in (("tile_start", tile_start), ("tile_count", tile_count)):
        if tab.dtype != torch.int32 or tuple(tab.shape) != (T,) \
                or tab.device != dev:
            raise ValueError(f"{name} must be ({T},) int32 on {dev}, got "
                             f"{tuple(tab.shape)} {tab.dtype} {tab.device}")
    entries = entries.contiguous()
    tile_start = tile_start.contiguous()
    tile_count = tile_count.contiguous()
    lib = _lib()
    if P > lib.gsplat_composite_fwd_max_pixels():
        raise ValueError(f"tile of {P} pixels exceeds the kernel's "
                         f"{lib.gsplat_composite_fwd_max_pixels()}")
    accum = torch.empty((T, 4, P), dtype=torch.float32, device=dev)
    t_final = torch.empty((T, P), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((T, P), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.gsplat_composite_fwd(
            entries.data_ptr(), entries.shape[0], tile_start.data_ptr(),
            tile_count.data_ptr(), T, n_tiles_x, tile_h, tile_w, chunk,
            alpha_min, alpha_max, t_eps, accum.data_ptr(), t_final.data_ptr(),
            n_contrib.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"composite_fwd launch failed: cudaError_t {err}")
    composite_fwd_cuda.launches += 1
    return CompositeOut(accum=accum, t_final=t_final, n_contrib=n_contrib)


composite_fwd_cuda.launches = 0   # kernel launches since the last reset


def composite_tiles(entries: torch.Tensor, tile_start: torch.Tensor,
                    tile_count: torch.Tensor, *, n_tiles_x: int,
                    n_tiles_y: int, tile_h: int, tile_w: int, chunk: int,
                    alpha_min: float, alpha_max: float,
                    t_eps: float) -> CompositeOut:
    """Composite the chunk-aligned entry list, on the device it lies on."""
    kw = dict(n_tiles_x=n_tiles_x, n_tiles_y=n_tiles_y, tile_h=tile_h,
              tile_w=tile_w, chunk=chunk, alpha_min=alpha_min,
              alpha_max=alpha_max, t_eps=t_eps)
    if entries.device.type == "cpu":
        return composite_tiles_plain(entries, tile_start, tile_count, **kw)
    if entries.device.type == "cuda":
        return composite_fwd_cuda(entries, tile_start, tile_count, **kw)
    raise ValueError(f"no compositor for device {entries.device}")
