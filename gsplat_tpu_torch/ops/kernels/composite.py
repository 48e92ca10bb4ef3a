"""The tile compositor's dispatch and its CUDA kernels' wrappers.

``composite_tiles`` routes by where the entries lie: a CPU tensor goes to
the plain PyTorch version (ops/composite_ref.py), differentiated by
autograd; a CUDA tensor to the hand-written kernels csrc/composite_fwd.cu
and, for the gradient, csrc/composite_bwd.cu, joined by a
``torch.autograd.Function``; anything else raises. There is no fallback:
on the card the kernel launches or the call raises. Autograd through the
plain version is the oracle both kernels are held to.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from gsplat_tpu_torch.ops.composite_ref import (CompositeOut,
                                                composite_tiles_plain)
from gsplat_tpu_torch.ops.kernels import build

_P = ctypes.c_void_p
_FWD_ARGTYPES = ([_P, ctypes.c_longlong, _P, _P] + [ctypes.c_int] * 5
                 + [ctypes.c_float] * 3 + [_P] * 4)
_BWD_ARGTYPES = ([_P, ctypes.c_longlong, _P, _P] + [ctypes.c_int] * 4
                 + [ctypes.c_float] * 2 + [_P] * 6)


@functools.lru_cache(maxsize=None)
def _lib(name: str):
    lib = build.load(name)
    fn = getattr(lib, f"gsplat_{name}")
    fn.argtypes = _FWD_ARGTYPES if name == "composite_fwd" else _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    getattr(lib, f"gsplat_{name}_max_pixels").restype = ctypes.c_int
    return lib, fn


def _check(name: str, entries, tables, T: int, P: int, per_tile=()):
    """Raise on what the kernel does not take; return its C function."""
    dev = entries.device
    if dev.type != "cuda":
        raise ValueError(f"{name}_cuda needs CUDA tensors, got {dev}")
    if entries.dtype != torch.float32 or entries.dim() != 2 \
            or entries.shape[1] != 16:
        raise ValueError(f"entries must be (M,16) float32, got "
                         f"{tuple(entries.shape)} {entries.dtype}")
    for tname, tab in tables:
        if tab.dtype != torch.int32 or tuple(tab.shape) != (T,) \
                or tab.device != dev:
            raise ValueError(f"{tname} must be ({T},) int32 on {dev}, got "
                             f"{tuple(tab.shape)} {tab.dtype} {tab.device}")
    for tname, x, shape, dtype in per_tile:
        if x.dtype != dtype or tuple(x.shape) != shape or x.device != dev:
            raise ValueError(f"{tname} must be {shape} {dtype} on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} {x.device}")
    lib, fn = _lib(name)
    max_p = getattr(lib, f"gsplat_{name}_max_pixels")()
    if P > max_p:
        raise ValueError(f"tile of {P} pixels exceeds {name}'s {max_p}")
    return fn


def composite_fwd_cuda(entries: torch.Tensor, tile_start: torch.Tensor,
                       tile_count: torch.Tensor, *, n_tiles_x: int,
                       n_tiles_y: int, tile_h: int, tile_w: int, chunk: int,
                       alpha_min: float, alpha_max: float,
                       t_eps: float) -> CompositeOut:
    """Launch the CUDA compositor on the current stream. entries (M,16) f32,
    tile_start/tile_count (T,) i32 (ranges aligned to ``chunk``), all on one
    CUDA device. Not differentiable by itself: ``composite_tiles`` is."""
    T = n_tiles_x * n_tiles_y
    P = tile_h * tile_w
    dev = entries.device
    fn = _check("composite_fwd", entries, (("tile_start", tile_start),
                                           ("tile_count", tile_count)), T, P)
    entries = entries.detach().contiguous()
    tile_start = tile_start.contiguous()
    tile_count = tile_count.contiguous()
    accum = torch.empty((T, 4, P), dtype=torch.float32, device=dev)
    t_final = torch.empty((T, P), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((T, P), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(
            entries.data_ptr(), entries.shape[0], tile_start.data_ptr(),
            tile_count.data_ptr(), T, n_tiles_x, tile_h, tile_w, chunk,
            alpha_min, alpha_max, t_eps, accum.data_ptr(), t_final.data_ptr(),
            n_contrib.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"composite_fwd launch failed: cudaError_t {err}")
    composite_fwd_cuda.launches += 1
    return CompositeOut(accum=accum, t_final=t_final, n_contrib=n_contrib)


composite_fwd_cuda.launches = 0   # kernel launches since the last reset


def composite_bwd_cuda(entries: torch.Tensor, tile_start: torch.Tensor,
                       tile_count: torch.Tensor, t_final: torch.Tensor,
                       n_contrib: torch.Tensor,
                       g_accum: Optional[torch.Tensor],
                       g_t: Optional[torch.Tensor], *, n_tiles_x: int,
                       n_tiles_y: int, tile_h: int, tile_w: int,
                       alpha_min: float, alpha_max: float) -> torch.Tensor:
    """Launch the CUDA compositor backward on the current stream: d_entries
    (M,16) from the forward's t_final (T,P) and n_contrib (T,P) and the
    cotangents g_accum (T,4,P) and g_t (T,P); a None cotangent is zeros.
    Columns 10-15, and rows no pixel reaches, are 0."""
    T = n_tiles_x * n_tiles_y
    P = tile_h * tile_w
    dev = entries.device
    f32 = dict(dtype=torch.float32, device=dev)
    if g_accum is None:
        g_accum = torch.zeros((T, 4, P), **f32)
    if g_t is None:
        g_t = torch.zeros((T, P), **f32)
    fn = _check("composite_bwd", entries, (("tile_start", tile_start),
                                           ("tile_count", tile_count)), T, P,
                (("t_final", t_final, (T, P), torch.float32),
                 ("n_contrib", n_contrib, (T, P), torch.int32),
                 ("g_accum", g_accum, (T, 4, P), torch.float32),
                 ("g_t", g_t, (T, P), torch.float32)))
    args = [x.detach().contiguous() for x in (
        entries, tile_start, tile_count, t_final, n_contrib, g_accum, g_t)]
    d_entries = torch.zeros_like(args[0])
    with torch.cuda.device(dev):
        err = fn(
            args[0].data_ptr(), args[0].shape[0], args[1].data_ptr(),
            args[2].data_ptr(), T, n_tiles_x, tile_h, tile_w, alpha_min,
            alpha_max, *(a.data_ptr() for a in args[3:]),
            d_entries.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"composite_bwd launch failed: cudaError_t {err}")
    composite_bwd_cuda.launches += 1
    return d_entries


composite_bwd_cuda.launches = 0   # kernel launches since the last reset


class _CompositeCuda(torch.autograd.Function):
    """The CUDA forward, with the CUDA backward as its gradient."""

    @staticmethod
    def forward(ctx, entries, tile_start, tile_count, geo):
        out = composite_fwd_cuda(entries, tile_start, tile_count, **geo)
        ctx.save_for_backward(entries, tile_start, tile_count, out.t_final,
                              out.n_contrib)
        ctx.geo = geo
        ctx.mark_non_differentiable(out.n_contrib)
        ctx.set_materialize_grads(False)
        return out.accum, out.t_final, out.n_contrib

    @staticmethod
    def backward(ctx, g_accum, g_t, _):
        entries, tile_start, tile_count, t_final, n_contrib = \
            ctx.saved_tensors
        geo = {k: v for k, v in ctx.geo.items() if k not in ("chunk",
                                                             "t_eps")}
        d = composite_bwd_cuda(entries, tile_start, tile_count, t_final,
                               n_contrib, g_accum, g_t, **geo)
        return d, None, None, None


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
        return CompositeOut(*_CompositeCuda.apply(entries, tile_start,
                                                  tile_count, kw))
    raise ValueError(f"no compositor for device {entries.device}")
