"""The fused SSIM's dispatch and its CUDA kernels' wrappers.

``ssim_map_fused`` routes by where the images lie: CPU tensors go to the
plain PyTorch ``ssim_map`` (ops/ssim.py) under autograd; CUDA tensors to
the hand-written kernels csrc/ssim_fwd.cu (the map and, when img1 wants a
gradient, the three partial maps of its backward) and csrc/ssim_bwd.cu (d
img1 from the cotangent and the partial maps, one launch), joined by a
``torch.autograd.Function``; anything else raises. ``img2`` is a constant
on both routes, as in the training loss. Autograd through the plain version
is the oracle both kernels are held to; ``ssim_partials_plain`` and
``ssim_bwd_plain`` are the kernels' own arithmetic in plain PyTorch, a
second oracle for the tests.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from gsplat_tpu_torch.ops.kernels import build
from gsplat_tpu_torch.ops.ssim import (C1, C2, _blur, _gaussian_window,
                                       ssim_map)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    "gsplat_ssim_fwd": [_P, _P, _P, _P, _I, _I, _I, _P, _F, _F, _P],
    "gsplat_ssim_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
}
# the 11-tap window the kernels take, as float32 in host memory
_WINDOW = np.asarray(_gaussian_window(11, 1.5), np.float32)


@functools.lru_cache(maxsize=None)
def _bind(csrc: Path):
    """(forward, backward) C functions of the SSIM kernels built from
    ``csrc``, with their argument types."""
    out = []
    for lib_name, fn_name in (("ssim_fwd", "gsplat_ssim_fwd"),
                              ("ssim_bwd", "gsplat_ssim_bwd")):
        fn = getattr(build.load(lib_name, csrc), fn_name)
        fn.argtypes = _ARGTYPES[fn_name]
        fn.restype = ctypes.c_int
        out.append(fn)
    return tuple(out)


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


def ssim_fwd_cuda(img1: torch.Tensor, img2: torch.Tensor, *,
                  partials: bool = False):
    """The SSIM map (C,H,W) of two (C,H,W) float32 CUDA images (window 11,
    σ 1.5, C1 0.01², C2 0.03²); with ``partials`` the pair (map, p), p the
    (3,C,H,W) partial maps of ``ssim_partials_plain``, from the same
    launch."""
    x, y = _check("ssim_fwd_cuda", img1, img2)
    out = torch.empty_like(x)
    p = torch.empty((3,) + tuple(x.shape), dtype=torch.float32,
                    device=x.device) if partials else None
    with torch.cuda.device(x.device):
        _raise_on(_bind(build.sources())[0](
            x.data_ptr(), y.data_ptr(), out.data_ptr(),
            p.data_ptr() if partials else None, *x.shape,
            _WINDOW.ctypes.data, C1, C2, _stream()), "ssim_fwd")
    ssim_fwd_cuda.launches += 1
    return (out, p) if partials else out


ssim_fwd_cuda.launches = 0   # kernel launches since the last reset


def ssim_bwd_cuda(img1: torch.Tensor, img2: torch.Tensor, g: torch.Tensor,
                  p: torch.Tensor):
    """d img1 (C,H,W) of the SSIM map under the cotangent g (C,H,W), img2
    constant, from the forward's partial maps p (3,C,H,W). One launch."""
    x, y, g = _check("ssim_bwd_cuda", img1, img2, g)
    if p.dtype != torch.float32 or tuple(p.shape) != (3,) + tuple(x.shape) \
            or p.device != x.device:
        raise ValueError(f"p must be (3,{','.join(map(str, x.shape))}) "
                         f"float32 on {x.device}, got {tuple(p.shape)} "
                         f"{p.dtype} {p.device}")
    p = p.detach().contiguous()
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _raise_on(_bind(build.sources())[1](
            x.data_ptr(), y.data_ptr(), g.data_ptr(), p.data_ptr(),
            dx.data_ptr(), *x.shape, _WINDOW.ctypes.data, _stream()),
            "ssim_bwd")
    ssim_bwd_cuda.launches += 1
    return dx


ssim_bwd_cuda.launches = 0   # kernel launches since the last reset


def _fields_plain(img1: torch.Tensor, img2: torch.Tensor):
    """The five blurred fields (mu1, mu2, blur x², blur y², blur xy), as
    ``ssim_map`` forms them."""
    return (_blur(img1, 11, 1.5), _blur(img2, 11, 1.5),
            _blur(img1 * img1, 11, 1.5), _blur(img2 * img2, 11, 1.5),
            _blur(img1 * img2, 11, 1.5))


def ssim_partials_plain(img1: torch.Tensor,
                        img2: torch.Tensor) -> torch.Tensor:
    """p = (p_mu, p_x2, p_xy) (3,C,H,W): the cotangents of mu1, blur x² and
    blur xy under a unit cotangent of the SSIM map, with the variance
    clamp's mask [blur x² − mu1² > 0] (gsplat_tpu/ops/pallas/ssim_kernel.py
    :103-120 with g = 1), in the order of operations of csrc/ssim_fwd.cu. A
    cotangent g of the map gives the field cotangents g·p."""
    mu1, mu2, x2b, y2b, xyb = _fields_plain(img1, img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    v1 = x2b - mu1_sq
    zero = torch.zeros_like(v1)
    s1 = torch.where(v1 > 0, v1, zero)
    s2 = torch.where(y2b - mu2_sq > 0, y2b - mu2_sq, zero)
    a = 2 * mu1_mu2 + C1
    b = 2 * (xyb - mu1_mu2) + C2
    c = (mu1_sq + mu2_sq) + C1
    d = (s1 + s2) + C2
    cd = c * d
    smap = (a * b) / cd
    inv_cd = torch.reciprocal(cd)
    d_a, d_b = b * inv_cd, a * inv_cd
    d_c = -(smap * torch.reciprocal(c))
    d_dm = torch.where(v1 > 0, -(smap * torch.reciprocal(d)), zero)
    p_mu = 2 * (mu2 * (d_a - d_b) + mu1 * (d_c - d_dm))
    return torch.stack([p_mu, d_dm, 2 * d_b])


def ssim_bwd_plain(img1: torch.Tensor, img2: torch.Tensor, g: torch.Tensor,
                   p: torch.Tensor) -> torch.Tensor:
    """d img1 of the SSIM map under the cotangent g, img2 constant, from the
    partial maps p of ``ssim_partials_plain``: blur(g·p_mu) + 2·x·blur(g·p_x2)
    + y·blur(g·p_xy), in the order of operations of csrc/ssim_bwd.cu."""
    bl_mu, bl_x2, bl_xy = (_blur(g * p[k], 11, 1.5) for k in range(3))
    return bl_mu + (2 * img1) * bl_x2 + img2 * bl_xy


class _SSIMMapCuda(torch.autograd.Function):
    """The CUDA SSIM map, with the CUDA backward as its gradient (img1
    only). The forward writes the partial maps only when img1 wants a
    gradient."""

    @staticmethod
    def forward(ctx, img1, img2):
        if not ctx.needs_input_grad[0]:
            return ssim_fwd_cuda(img1, img2)
        out, p = ssim_fwd_cuda(img1, img2, partials=True)
        ctx.save_for_backward(img1, img2, p)
        return out

    @staticmethod
    def backward(ctx, g):
        img1, img2, p = ctx.saved_tensors
        return ssim_bwd_cuda(img1, img2, g, p), None


def ssim_map_fused(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-pixel SSIM map of (C,H,W) images with img2 a constant, on the
    device the images lie on."""
    img2 = img2.detach()
    if img1.device.type == "cpu":
        return ssim_map(img1, img2)
    if img1.device.type == "cuda":
        return _SSIMMapCuda.apply(img1, img2)
    raise ValueError(f"no SSIM for device {img1.device}")
