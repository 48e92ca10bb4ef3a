"""The yardstick's operation and byte counts and the card's peaks, worked
out from the inputs' shapes and from what the reference's walk of the same
views finds (pairs, contributions), never from the system's counters.

Peaks: the NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit:
67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM3.

Per kernel, as ``PERF.md`` counts them: each input byte read once and each
output byte written once; operations only for contributing (pair, pixel)
evaluations, so the work is the same whatever implements the kernel.

- compositor forward: 40 B per pair (the 10 float32 columns it reads) +
  8 B of tile table per tile + 24 B per image pixel (colour, inverse
  depth, transmittance and contributor count out); 21 operations per
  contribution (about 20 float32 operations and one exp).
- compositor backward: 40 B per pair up to its tile's last contributor +
  64 B per pair of row gradient out + 8 B per tile + 28 B per image pixel
  (4 cotangents in, transmittance and count in); 60 operations per
  contribution.
- the SSIM pair of a step (forward with partial maps, backward): 28 B and
  387 operations per image element (channel x pixel).
- preprocess forward and backward: 1,350 operations per splat (projection
  48, rotation and covariance 90, EWA Jacobian and 2-D covariance 110,
  conic, radius and binning box 40, SH degree 3 basis and colour 160,
  activations 10: 450 forward, about twice that backward).
- Adam: 15 operations per parameter (the gradient mask, 3 for the first
  moment, 4 for the second, 7 for the update and the step).
"""
from __future__ import annotations

from typing import NamedTuple

F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

OPS_FWD_CONTRIB = 21
OPS_BWD_CONTRIB = 60
OPS_SSIM_PAIR = 387
BYTES_SSIM_PAIR = 28
OPS_PREPROCESS = 1350
OPS_PREPROCESS_FWD = 450
OPS_ADAM = 15
PARAMS_PER_SPLAT = 59


class FrameCount(NamedTuple):
    """What one view needs, from the reference's walk: (tile, splat)
    pairs, pairs up to each tile's last contributor, contributing (pair,
    pixel) evaluations, tiles, image pixels."""
    pairs: int
    bwd_rows: int
    contributing: int
    tiles: int
    pixels: int


def bound_s(n_bytes: float, ops: float) -> float:
    """The least time the card could take."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def composite_fwd(f: FrameCount):
    """(bytes, operations) of the compositor forward of one view."""
    return (40 * f.pairs + 8 * f.tiles + 24 * f.pixels,
            OPS_FWD_CONTRIB * f.contributing)


def composite_bwd(f: FrameCount):
    return (40 * f.bwd_rows + 64 * f.pairs + 8 * f.tiles + 28 * f.pixels,
            OPS_BWD_CONTRIB * f.contributing)


def ssim_pair(f: FrameCount):
    return BYTES_SSIM_PAIR * 3 * f.pixels, OPS_SSIM_PAIR * 3 * f.pixels


def train_view_ops(f: FrameCount, n_splats: int) -> float:
    """Float32 operations of one view's share of a training step:
    preprocess, compositor forward and backward, the SSIM pair."""
    return (OPS_PREPROCESS * n_splats + composite_fwd(f)[1]
            + composite_bwd(f)[1] + ssim_pair(f)[1])


def render_view_ops(f: FrameCount, n_splats: int) -> float:
    """Float32 operations of one viewer frame: preprocess forward of every
    splat and the compositor forward."""
    return OPS_PREPROCESS_FWD * n_splats + composite_fwd(f)[1]


def adam_ops(n_splats: int) -> float:
    return OPS_ADAM * PARAMS_PER_SPLAT * n_splats
