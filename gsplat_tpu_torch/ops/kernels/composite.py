"""The tile compositor's dispatch and its CUDA kernels' wrappers.

``composite_tiles`` routes by where the entries lie: a CPU tensor goes to
the plain PyTorch version (ops/composite_ref.py), differentiated by
autograd; a CUDA tensor to the hand-written kernels csrc/composite_fwd.cu
and, for the gradient, csrc/composite_bwd.cu, joined by a
``torch.autograd.Function``; anything else raises. ``slab_transmittance``
routes the same way between ``slab_transmittance_plain`` and
csrc/slab_tmit.cu. There is no fallback: on the card the kernel launches
or the call raises. The plain versions (autograd through the compositor's)
are the oracles the kernels are held to.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from gsplat_tpu_torch.ops.composite_ref import (CompositeOut,
                                                composite_tiles_plain,
                                                slab_transmittance_plain)
from gsplat_tpu_torch.ops.kernels import build

_P = ctypes.c_void_p
_TABLES = [_P, ctypes.c_longlong, _P, _P]      # entries, n_rows, start, count
_ARGTYPES = {
    "composite_fwd": (_TABLES + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
                      + [_P, ctypes.c_int] + [_P] * 4),
    "composite_bwd": (_TABLES + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
                      + [_P] * 4 + [ctypes.c_int] + [_P] * 2),
    "slab_tmit": (_TABLES + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                  + [_P] * 2),
}
_CULL_RECTS_ARGTYPES = (_TABLES + [ctypes.c_int] * 4 + [ctypes.c_float]
                        + [ctypes.c_int] + [_P] * 2)


def _lib(name: str):
    return _bound(name, build.sources())


@functools.lru_cache(maxsize=None)
def _bound(name: str, csrc: Path):
    lib = build.load(name, csrc)
    fn = getattr(lib, f"gsplat_{name}")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    getattr(lib, f"gsplat_{name}_max_pixels").restype = ctypes.c_int
    if hasattr(lib, "gsplat_composite_cull_rects"):
        lib.gsplat_composite_cull_rects.argtypes = _CULL_RECTS_ARGTYPES
        lib.gsplat_composite_cull_rects.restype = ctypes.c_int
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
                       alpha_min: float, alpha_max: float, t_eps: float,
                       t_init: Optional[torch.Tensor] = None,
                       tile_id_base: int = 0) -> CompositeOut:
    """Launch the CUDA compositor on the current stream. entries (M,16) f32,
    tile_start/tile_count (T,) i32 (ranges aligned to ``chunk``), t_init
    (T,P) f32 or None (= ones), all on one CUDA device; tile 0 of the launch
    is tile ``tile_id_base`` of the full grid. Not differentiable by itself:
    ``composite_tiles`` is."""
    T = n_tiles_x * n_tiles_y
    P = tile_h * tile_w
    dev = entries.device
    fn = _check("composite_fwd", entries, (("tile_start", tile_start),
                                           ("tile_count", tile_count)), T, P,
                () if t_init is None else
                (("t_init", t_init, (T, P), torch.float32),))
    if t_init is not None:
        t_init = t_init.detach().contiguous()
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
            alpha_min, alpha_max, t_eps,
            None if t_init is None else t_init.data_ptr(), tile_id_base,
            accum.data_ptr(), t_final.data_ptr(), n_contrib.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"composite_fwd launch failed: cudaError_t {err}")
    composite_fwd_cuda.launches += 1
    return CompositeOut(accum=accum, t_final=t_final, n_contrib=n_contrib)


composite_fwd_cuda.launches = 0   # kernel launches since the last reset


def cull_rects_cuda(entries: torch.Tensor, tile_start: torch.Tensor,
                    tile_count: torch.Tensor, *, n_tiles_x: int,
                    n_tiles_y: int, tile_h: int, tile_w: int,
                    alpha_min: float, tile_id_base: int = 0) -> torch.Tensor:
    """(M, 5) int32: the cull rectangle x0, x1, y0, y1 and the warp mask the
    compositor's kernels stage for every entry row in a tile's range, -2 on
    rows no tile owns; ``cull_rects_plain`` is its plain version. For the
    tests and the smoke run: no render calls it, and it counts no launch."""
    T = n_tiles_x * n_tiles_y
    _check("composite_fwd", entries, (("tile_start", tile_start),
                                      ("tile_count", tile_count)), T,
           tile_h * tile_w)
    dev = entries.device
    entries = entries.detach().contiguous()
    tile_start = tile_start.contiguous()
    tile_count = tile_count.contiguous()
    rects = torch.full((entries.shape[0], 5), -2, dtype=torch.int32,
                       device=dev)
    with torch.cuda.device(dev):
        err = _lib("composite_fwd")[0].gsplat_composite_cull_rects(
            entries.data_ptr(), entries.shape[0], tile_start.data_ptr(),
            tile_count.data_ptr(), T, n_tiles_x, tile_h, tile_w, alpha_min,
            tile_id_base, rects.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"cull_rects launch failed: cudaError_t {err}")
    return rects


def composite_bwd_cuda(entries: torch.Tensor, tile_start: torch.Tensor,
                       tile_count: torch.Tensor, t_final: torch.Tensor,
                       n_contrib: torch.Tensor,
                       g_accum: Optional[torch.Tensor],
                       g_t: Optional[torch.Tensor], *, n_tiles_x: int,
                       n_tiles_y: int, tile_h: int, tile_w: int,
                       alpha_min: float, alpha_max: float,
                       tile_id_base: int = 0) -> torch.Tensor:
    """Launch the CUDA compositor backward on the current stream: d_entries
    (M,16) from the forward's t_final (T,P) and n_contrib (T,P) and the
    cotangents g_accum (T,4,P) and g_t (T,P); a None cotangent is zeros.
    Columns 10-15, and rows no pixel reaches, are 0. A forward that took
    ``t_init`` needs none here: its n_contrib and t_final carry the cut."""
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
            alpha_max, *(a.data_ptr() for a in args[3:]), tile_id_base,
            d_entries.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"composite_bwd launch failed: cudaError_t {err}")
    composite_bwd_cuda.launches += 1
    return d_entries


composite_bwd_cuda.launches = 0   # kernel launches since the last reset


def slab_transmittance_cuda(entries: torch.Tensor, tile_start: torch.Tensor,
                            tile_count: torch.Tensor, *, n_tiles_x: int,
                            n_tiles_y: int, tile_h: int, tile_w: int,
                            chunk: int, alpha_min: float,
                            alpha_max: float) -> torch.Tensor:
    """Launch the CUDA slab transmittance on the current stream: (T,P) f32,
    the product of (1 − α) over each tile's whole list, 1 on an empty
    tile. Inputs as ``composite_fwd_cuda``'s. No gradient."""
    T = n_tiles_x * n_tiles_y
    P = tile_h * tile_w
    dev = entries.device
    fn = _check("slab_tmit", entries, (("tile_start", tile_start),
                                       ("tile_count", tile_count)), T, P)
    entries = entries.detach().contiguous()
    tile_start = tile_start.contiguous()
    tile_count = tile_count.contiguous()
    t_out = torch.empty((T, P), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = fn(
            entries.data_ptr(), entries.shape[0], tile_start.data_ptr(),
            tile_count.data_ptr(), T, n_tiles_x, tile_h, tile_w, chunk,
            alpha_min, alpha_max, t_out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"slab_tmit launch failed: cudaError_t {err}")
    slab_transmittance_cuda.launches += 1
    return t_out


slab_transmittance_cuda.launches = 0   # kernel launches since the last reset


class _CompositeCuda(torch.autograd.Function):
    """The CUDA forward, with the CUDA backward as its gradient. ``t_init``
    is a constant of the forward; the backward does not need it."""

    @staticmethod
    def forward(ctx, entries, tile_start, tile_count, t_init, geo):
        out = composite_fwd_cuda(entries, tile_start, tile_count,
                                 t_init=t_init, **geo)
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
        return d, None, None, None, None


def composite_tiles(entries: torch.Tensor, tile_start: torch.Tensor,
                    tile_count: torch.Tensor, *, n_tiles_x: int,
                    n_tiles_y: int, tile_h: int, tile_w: int, chunk: int,
                    alpha_min: float, alpha_max: float, t_eps: float,
                    t_init: Optional[torch.Tensor] = None,
                    tile_id_base: int = 0) -> CompositeOut:
    """Composite the chunk-aligned entry list, on the device it lies on.
    ``t_init`` (T,P), the transmittance arriving from nearer depth slabs,
    scales the early-out test only and carries no gradient;
    ``tile_id_base`` is the full-grid id of tile 0 (tile bands)."""
    kw = dict(n_tiles_x=n_tiles_x, n_tiles_y=n_tiles_y, tile_h=tile_h,
              tile_w=tile_w, chunk=chunk, alpha_min=alpha_min,
              alpha_max=alpha_max, t_eps=t_eps, tile_id_base=tile_id_base)
    if entries.device.type == "cpu":
        return composite_tiles_plain(entries, tile_start, tile_count,
                                     t_init=t_init, **kw)
    if entries.device.type == "cuda":
        return CompositeOut(*_CompositeCuda.apply(entries, tile_start,
                                                  tile_count, t_init, kw))
    raise ValueError(f"no compositor for device {entries.device}")


def slab_transmittance(entries: torch.Tensor, tile_start: torch.Tensor,
                       tile_count: torch.Tensor, *, n_tiles_x: int,
                       n_tiles_y: int, tile_h: int, tile_w: int, chunk: int,
                       alpha_min: float, alpha_max: float) -> torch.Tensor:
    """(T,P) cut-free transmittance of each tile's whole entry list, on the
    device the entries lie on. No gradient."""
    kw = dict(n_tiles_x=n_tiles_x, n_tiles_y=n_tiles_y, tile_h=tile_h,
              tile_w=tile_w, chunk=chunk, alpha_min=alpha_min,
              alpha_max=alpha_max)
    if entries.device.type == "cpu":
        return slab_transmittance_plain(entries, tile_start, tile_count, **kw)
    if entries.device.type == "cuda":
        return slab_transmittance_cuda(entries, tile_start, tile_count, **kw)
    raise ValueError(f"no slab transmittance for device {entries.device}")
