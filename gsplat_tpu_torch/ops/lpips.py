"""LPIPS perceptual metric (VGG16 taps, LPIPS linear calibration).
Counterpart of gsplat_tpu/ops/lpips.py.

The weights come only from a local file: ``GSPLAT_LPIPS_WEIGHTS`` names an
npz with the 13 VGG16-features conv kernels and biases (torchvision
layout, keys ``conv{i}_w`` / ``conv{i}_b``) and the five LPIPS linear
weights (keys ``lin{j}``), the file the JAX package reads. Without it
``lpips_vgg`` raises ``FileNotFoundError`` and the metrics CLI reports NaN.

The convolutions are ``torch.nn.functional.conv2d`` in full float32 (JAX
runs them at ``Precision.HIGHEST`` outside any Pallas kernel). On the card
cuDNN would take TF32 by default, which moves a VGG distance in its third
digit, so ``lpips_vgg``'s function turns TF32 off itself.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from gsplat_tpu_torch.utils.general import full_f32_matmul, resolve_device

# VGG16 feature config: conv channels per block (torchvision "D" config);
# the taps are the outputs of relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
_VGG_CFG = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def random_weights(rng: np.random.Generator) -> dict:
    """Random weights in the npz layout ``lpips_vgg`` reads: He-scaled
    convs, small biases, non-negative linear weights (the recipe of the
    JAX package's LPIPS test). The same arithmetic at the same shapes as
    the published weights, for runs that have none."""
    out = {}
    c_in, i = 3, 0
    for c_out, reps in _VGG_CFG:
        for _ in range(reps):
            w = rng.standard_normal((c_out, c_in, 3, 3)).astype(np.float32)
            w *= np.sqrt(2.0 / (c_in * 9))
            out[f"conv{i}_w"] = w
            out[f"conv{i}_b"] = \
                0.1 * rng.standard_normal(c_out).astype(np.float32)
            c_in, i = c_out, i + 1
    for j, (c, _) in enumerate(_VGG_CFG):
        out[f"lin{j}"] = \
            np.abs(rng.standard_normal(c).astype(np.float32)) * 0.05
    return out


def _load_weights(device: torch.device):
    path = os.environ.get("GSPLAT_LPIPS_WEIGHTS", "")
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            "LPIPS weights not found; set GSPLAT_LPIPS_WEIGHTS to the "
            "converted .npz (see tools/convert_lpips_weights.py)")
    with np.load(path) as data:
        n_convs = sum(reps for _, reps in _VGG_CFG)
        convs = [tuple(torch.tensor(data[f"conv{i}_{k}"], device=device)
                       for k in ("w", "b")) for i in range(n_convs)]
        lins = [torch.tensor(data[f"lin{j}"], device=device)
                for j in range(len(_VGG_CFG))]
    return convs, lins


def _vgg_taps(x: torch.Tensor, convs) -> list:
    """x: (B,3,H,W), already input-normalized → the 5 tap activations."""
    taps = []
    i = 0
    h = x
    for b, (_, reps) in enumerate(_VGG_CFG):
        for _ in range(reps):
            w, bias = convs[i]
            h = F.relu(F.conv2d(h, w, bias, padding=1))
            i += 1
        taps.append(h)
        if b < len(_VGG_CFG) - 1:
            h = F.max_pool2d(h, 2, 2)
    return taps


def lpips_vgg(*, device="cuda"):
    """fn(img1, img2) -> scalar LPIPS tensor, for (B,3,H,W) images in [0,1]
    on ``device``, with the weights of ``GSPLAT_LPIPS_WEIGHTS`` loaded
    there."""
    dev = resolve_device(device)
    convs, lins = _load_weights(dev)
    shift = torch.tensor(_SHIFT, device=dev)[None, :, None, None]
    scale = torch.tensor(_SCALE, device=dev)[None, :, None, None]

    def fn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        full_f32_matmul()
        # the z-score goes on the [0,1] image directly, with no [0,1] →
        # [-1,1] mapping first: the quirk of the LPIPS package the
        # published 3DGS numbers were computed with (see the JAX module)
        fx = _vgg_taps((x - shift) / scale, convs)
        fy = _vgg_taps((y - shift) / scale, convs)
        total = torch.zeros((), device=dev)
        for tx, ty, lin in zip(fx, fy, lins):
            nx = tx / (torch.linalg.norm(tx, dim=1, keepdim=True) + 1e-10)
            ny = ty / (torch.linalg.norm(ty, dim=1, keepdim=True) + 1e-10)
            d = (nx - ny) ** 2
            total = total + torch.sum(d * lin[None, :, None, None],
                                      dim=1).mean()
        return total

    return fn
