"""The blocked (M,16) prefix sum's dispatch and its CUDA kernel's wrapper.
Counterpart of gsplat_tpu/ops/pallas/scan.py ``blocked_cumsum_16``.

``blocked_cumsum_16`` routes by where the rows lie: a CPU tensor goes to the
plain PyTorch version ``blocked_cumsum_16_plain``; a CUDA tensor to the
hand-written kernel csrc/scan.cu; anything else raises. There is no
fallback: on the card the kernel launches or the call raises. The plain
version is the oracle the kernel is held to. The result carries no
gradient: its one caller is itself a backward (ops/rasterize.py
``_blocked_prefix``, for the sharded ring gather).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from gsplat_tpu_torch.ops.kernels import build

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("scan").gsplat_scan
    fn.argtypes = [_P, ctypes.c_longlong, ctypes.c_int, _P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, L: int):
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 16:
        raise ValueError(f"x must be (M,16) float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if L <= 0 or x.shape[0] % L:
        raise ValueError(f"{x.shape[0]} rows are no whole number of blocks "
                         f"of L = {L}")


def blocked_cumsum_16_plain(x: torch.Tensor, L: int = 4096
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M,16) f32, M % L == 0. Returns (intra (M,16): inclusive prefix
    sums down the rows, restarting every L rows; block_tot (M/L,16): each
    block's column totals, which are intra's last rows)."""
    _check(x, L)
    M = x.shape[0]
    intra = torch.cumsum(x.detach().reshape(M // L, L, 16), dim=1)
    return intra.reshape(M, 16), intra[:, L - 1, :]


def blocked_cumsum_16_cuda(x: torch.Tensor, L: int = 4096
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``blocked_cumsum_16_plain`` by the CUDA kernel, launched on the
    current stream: one thread block per L-block, a fixed order of
    additions (two launches on one input give the same bits)."""
    if x.device.type != "cuda":
        raise ValueError(f"blocked_cumsum_16_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    _check(x, L)
    x = x.detach().contiguous()
    M = x.shape[0]
    intra = torch.empty_like(x)
    block_tot = torch.empty((M // L, 16), dtype=torch.float32,
                            device=x.device)
    if M == 0:
        return intra, block_tot
    fn = _fn()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), M, L, intra.data_ptr(), block_tot.data_ptr(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"scan launch failed: cudaError_t {err}")
    blocked_cumsum_16_cuda.launches += 1
    return intra, block_tot


blocked_cumsum_16_cuda.launches = 0   # kernel launches since the last reset


def blocked_cumsum_16(x: torch.Tensor, L: int = 4096
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(intra, block_tot) of the blocked prefix sum, on the device the rows
    lie on."""
    if x.device.type == "cpu":
        return blocked_cumsum_16_plain(x, L)
    if x.device.type == "cuda":
        return blocked_cumsum_16_cuda(x, L)
    raise ValueError(f"no blocked prefix sum for device {x.device}")
