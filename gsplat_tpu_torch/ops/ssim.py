"""SSIM with the reference's windowing: an 11-tap Gaussian window, σ = 1.5,
C1 = 0.01², C2 = 0.03², zero ("same") padding, per channel, mean over all
pixels. Counterpart of gsplat_tpu/ops/ssim.py.

The blur is eleven shifted weighted adds per axis, vertical then
horizontal, as in the JAX package. It is not a ``conv2d``: on the card
cuDNN would run that in TF32, whose error makes blur(x²) − mu² go negative.
The plain form here is the CPU route, the differentiable oracle, and the
version the CUDA kernels (ops/kernels/ssim.py) are held to.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

C1 = 0.01 ** 2
C2 = 0.03 ** 2


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int = 11, sigma: float = 1.5) -> tuple:
    """1-D Gaussian window, normalised in float64, as float32 values."""
    xs = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2.0 * sigma ** 2))
    return tuple((g / g.sum()).astype(np.float32).tolist())


def _blur(x: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur with zero padding over the last two axes of
    x (..., H, W): the vertical pass, then the horizontal one."""
    w = _gaussian_window(window_size, sigma)
    pad = window_size // 2

    def blur_axis(v, axis):
        size = v.shape[axis]
        widths = [0, 0] * v.dim()          # F.pad order: last axis first
        widths[2 * (v.dim() - 1 - axis)] = pad
        widths[2 * (v.dim() - 1 - axis) + 1] = pad
        vp = torch.nn.functional.pad(v, widths)
        acc = None
        for i in range(window_size):
            term = w[i] * vp.narrow(axis, i, size)
            acc = term if acc is None else acc + term
        return acc

    return blur_axis(blur_axis(x, x.dim() - 2), x.dim() - 1)


def _relu0(v: torch.Tensor) -> torch.Tensor:
    """max(v, 0) whose gradient is 0 where v == 0 exactly, as the kernel's
    variance mask [v > 0] is (torch.clamp would pass 1 there)."""
    return torch.where(v > 0, v, torch.zeros_like(v))


def ssim_map(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
             sigma: float = 1.5, c1: float = C1,
             c2: float = C2) -> torch.Tensor:
    """Per-pixel SSIM map of (..., C, H, W) images in [0, 1]. Variances are
    clamped at 0 so float cancellation cannot flip the denominator."""
    mu1 = _blur(img1, window_size, sigma)
    mu2 = _blur(img2, window_size, sigma)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _relu0(_blur(img1 * img1, window_size, sigma) - mu1_sq)
    sigma2_sq = _relu0(_blur(img2 * img2, window_size, sigma) - mu2_sq)
    sigma12 = _blur(img1 * img2, window_size, sigma) - mu1_mu2
    return ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM."""
    return ssim_map(img1, img2, window_size).mean()


def fast_ssim(img1: torch.Tensor, img2: torch.Tensor,
              window_size: int = 11) -> torch.Tensor:
    """Training-loss SSIM of (C, H, W) images: ``img2`` is a constant (no
    gradient flows to it). CPU tensors take the plain form, CUDA tensors
    the fused kernels (ops/kernels/ssim.py), which take 11 taps only."""
    if window_size != 11:
        raise ValueError(f"fast_ssim takes window_size 11 only (the fused "
                         f"kernels' taps), got {window_size}")
    from gsplat_tpu_torch.ops.kernels.ssim import ssim_map_fused
    return ssim_map_fused(img1, img2).mean()
