"""Failure snapshot dumps: the ``--debug`` contract of the reference
rasterizer (on a failure, write a snapshot of the step's inputs for offline
replay). Counterpart of gsplat_tpu/utils/debug.py.

The failure the loop catches is a non-finite loss. With
``PipelineConfig.debug`` set, the loop calls :func:`dump_snapshot` with the
state the failing step started from, its camera and its images. The npz keys
are the JAX package's for the same state and camera (``state.gaussians.xyz``,
``state.adam.mu['xyz']``, ..., ``cam.world_view``, ..., ``gt``,
``alpha_mask``, ``invdepth_gt``, ``depth_mask``, ``iteration``, ``reason``),
so one replay tool reads a snapshot of either package.
"""
from __future__ import annotations

import numpy as np
import torch

from gsplat_tpu_torch.core.camera import FIELDS as CAM_FIELDS
from gsplat_tpu_torch.train.checkpoint import state_items


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def dump_snapshot(path: str, state, cam, cam_arrays, iteration: int,
                  reason: str) -> str:
    """Write the full step input set to ``path`` (.npz). Returns the path.

    state: trainer.TrainState; cam: CameraView; cam_arrays: (gt,
    alpha_mask, invdepth_gt, depth_mask) tensors or host arrays.
    """
    payload = {"iteration": np.asarray(iteration), "reason": np.asarray(reason)}
    payload.update(("state" + name, a) for name, a in state_items(state))
    for k in CAM_FIELDS:
        v = getattr(cam, k)
        payload["cam." + k] = (np.asarray(v, np.int32) if k == "exposure_idx"
                               else _np(v))
    gt, amask, inv_gt, dmask = cam_arrays
    payload.update(gt=_np(gt), alpha_mask=_np(amask), invdepth_gt=_np(inv_gt),
                   depth_mask=_np(dmask))
    np.savez_compressed(path, **payload)
    return path
