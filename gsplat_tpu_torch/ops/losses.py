"""Training losses and image metrics. Counterpart of
gsplat_tpu/ops/losses.py."""
from __future__ import annotations

import torch

from gsplat_tpu_torch.ops.ssim import fast_ssim, ssim  # noqa: F401 re-export


def l1_loss(network_output: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return (network_output - gt).abs().mean()


def l2_loss(network_output: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return ((network_output - gt) ** 2).mean()


def mse(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image MSE over flattened pixels, (B, 1)."""
    return ((img1 - img2) ** 2).reshape(img1.shape[0], -1).mean(
        dim=1, keepdim=True)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """20·log10(1/√mse) per image."""
    return 20 * torch.log10(1.0 / torch.sqrt(mse(img1, img2)))
