"""Exact k-nearest-neighbour distances from a chunked distance matrix.
Counterpart of gsplat_tpu/ops/knn.py: the mean squared distance from each
point to its k nearest neighbours (self excluded), the initial splat scale
of ``create_from_pcd``.

Each block of rows forms its squared distances to every point as
‖x‖² + ‖y‖² − 2 x·y (a full-float32 matrix product), masks the diagonal,
and keeps the k smallest with ``topk``. O(N²) work, init only.
"""
from __future__ import annotations

import torch

from gsplat_tpu_torch.utils.general import full_f32_matmul


def mean_sq_dist_to_knn(points: torch.Tensor, k: int = 3,
                        block: int = 1024) -> torch.Tensor:
    """(N,3) float32 points → (N,) mean of the k smallest squared distances
    to the other points. A cloud of k points or fewer uses what it has."""
    full_f32_matmul()
    n = points.shape[0]
    sq = (points * points).sum(-1)                            # (N,)
    kk = k if n > k else max(min(k, n - 1), 1)
    out = []
    for i in range(0, n, block):
        rows = points[i:i + block]
        d2 = (sq[i:i + block, None] + sq[None, :]
              - 2.0 * (rows @ points.T)).clamp(min=0.0)
        idx = torch.arange(rows.shape[0], device=points.device)
        d2[idx, idx + i] = torch.inf                          # not itself
        out.append(torch.topk(d2, kk, dim=1, largest=False).values.mean(-1))
    return torch.cat(out)


def mean_sq_dist_to_3nn(points: torch.Tensor) -> torch.Tensor:
    """The reference's simple-knn ``distCUDA2`` semantics."""
    return mean_sq_dist_to_knn(points, k=3)
