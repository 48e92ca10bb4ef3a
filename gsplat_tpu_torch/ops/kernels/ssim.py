"""The fused SSIM's dispatch and its CUDA kernels' wrappers.

``ssim_map_fused`` routes by where the images lie: CPU tensors go to the
plain PyTorch ``ssim_map`` (ops/ssim.py) under autograd; CUDA tensors to
the hand-written kernels csrc/ssim_fwd.cu (the map) and csrc/ssim_bwd.cu
(d img1, two launches), joined by a ``torch.autograd.Function``; anything
else raises. ``img2`` is a constant on both routes, as in the training loss.
Autograd through the plain version is the oracle both kernels are held to.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from gsplat_tpu_torch.ops.kernels import build
from gsplat_tpu_torch.ops.ssim import C1, C2, _gaussian_window, ssim_map

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    "gsplat_ssim_fwd": [_P, _P, _P, _I, _I, _I, _P, _F, _F, _P],
    "gsplat_ssim_bwd_tmaps": [_P, _P, _P, _P, _I, _I, _I, _P, _F, _F, _P],
    "gsplat_ssim_bwd_combine": [_P, _P, _P, _P, _I, _I, _I, _P, _P],
}
# the 11-tap window the kernels take, as float32 in host memory
_WINDOW = np.asarray(_gaussian_window(11, 1.5), np.float32)


@functools.lru_cache(maxsize=None)
def _fn(lib_name: str, fn_name: str):
    fn = getattr(build.load(lib_name), fn_name)
    fn.argtypes = _ARGTYPES[fn_name]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, *imgs: torch.Tensor):
    """Raise on what the kernels do not take; return contiguous images."""
    dev = imgs[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    for x in imgs:
        if x.dtype != torch.float32 or x.dim() != 3 or x.device != dev \
                or x.shape != imgs[0].shape:
            raise ValueError(f"{name} takes (C,H,W) float32 images of one "
                             f"shape on {dev}, got {tuple(x.shape)} "
                             f"{x.dtype} {x.device}")
    return [x.detach().contiguous() for x in imgs]


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _raise_on(err: int, name: str):
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def ssim_fwd_cuda(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """The SSIM map (C,H,W) of two (C,H,W) float32 CUDA images (window 11,
    σ 1.5, C1 0.01², C2 0.03²)."""
    x, y = _check("ssim_fwd_cuda", img1, img2)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _raise_on(_fn("ssim_fwd", "gsplat_ssim_fwd")(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), *x.shape,
            _WINDOW.ctypes.data, C1, C2, _stream()), "ssim_fwd")
    ssim_fwd_cuda.launches += 1
    return out


ssim_fwd_cuda.launches = 0   # kernel launches since the last reset


def ssim_bwd_cuda(img1: torch.Tensor, img2: torch.Tensor,
                  g: torch.Tensor) -> torch.Tensor:
    """d img1 (C,H,W) of the SSIM map under the cotangent g (C,H,W), img2
    constant. Two launches, each counted."""
    x, y, g = _check("ssim_bwd_cuda", img1, img2, g)
    tmaps = torch.empty((3,) + tuple(x.shape), dtype=torch.float32,
                        device=x.device)
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _raise_on(_fn("ssim_bwd", "gsplat_ssim_bwd_tmaps")(
            x.data_ptr(), y.data_ptr(), g.data_ptr(), tmaps.data_ptr(),
            *x.shape, _WINDOW.ctypes.data, C1, C2, _stream()),
            "ssim_bwd (t maps)")
        ssim_bwd_cuda.launches += 1
        _raise_on(_fn("ssim_bwd", "gsplat_ssim_bwd_combine")(
            x.data_ptr(), y.data_ptr(), tmaps.data_ptr(), dx.data_ptr(),
            *x.shape, _WINDOW.ctypes.data, _stream()), "ssim_bwd (combine)")
        ssim_bwd_cuda.launches += 1
    return dx


ssim_bwd_cuda.launches = 0   # kernel launches since the last reset


class _SSIMMapCuda(torch.autograd.Function):
    """The CUDA SSIM map, with the CUDA backward as its gradient (img1
    only)."""

    @staticmethod
    def forward(ctx, img1, img2):
        ctx.save_for_backward(img1, img2)
        return ssim_fwd_cuda(img1, img2)

    @staticmethod
    def backward(ctx, g):
        img1, img2 = ctx.saved_tensors
        return ssim_bwd_cuda(img1, img2, g), None


def ssim_map_fused(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-pixel SSIM map of (C,H,W) images with img2 a constant, on the
    device the images lie on."""
    img2 = img2.detach()
    if img1.device.type == "cpu":
        return ssim_map(img1, img2)
    if img1.device.type == "cuda":
        return _SSIMMapCuda.apply(img1, img2)
    raise ValueError(f"no SSIM for device {img1.device}")
