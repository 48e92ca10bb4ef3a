"""The fused per-gaussian preprocess: its CUDA kernels' wrappers and the
``torch.autograd.Function`` that joins them.

csrc/preprocess_fwd.cu takes the raw trainable fields (log scale,
unnormalised quaternion, logit opacity, SH coefficients) of every gaussian
to the (N+1, 16) packed entry rows and the (N,) depth, radius, rx, ry and
t_cut that binning reads, in one launch; csrc/preprocess_bwd.cu takes d
packed back to the raw fields' gradients (and the screen-space tap's), in
one launch, recomputing the forward's intermediates. ops/preprocess.py
``preprocess_packed`` routes a call here or to the plain path
(``preprocess_packed_plain``: GaussianParams.get_*, ``preprocess``,
``pack_entries``), which is the oracle both kernels are held to.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from gsplat_tpu_torch.core.camera import CameraView
from gsplat_tpu_torch.ops.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SETTINGS = [_I] * 5 + [_F, _I, _F, _F]
_ARGTYPES = {
    # 7 fields, the tap, 5 camera tensors, settings, 6 outputs, the stream
    "preprocess_fwd": [_P] * 8 + [_P] * 5 + _SETTINGS + [_P] * 6 + [_P],
    # 7 fields, 5 camera tensors, settings, d packed, 7 outputs, the stream
    "preprocess_bwd": [_P] * 7 + [_P] * 5 + _SETTINGS + [_P] + [_P] * 7
    + [_P],
}
MAX_COEFFS = 16     # SH degree 3: the most the kernels take


class Settings(NamedTuple):
    """The call's scalars, the same for every gaussian."""
    width: int
    height: int
    active_sh_degree: int
    scaling_modifier: float
    antialiasing: bool
    dilation: float
    alpha_min: float


@functools.lru_cache(maxsize=None)
def _bound(name: str, csrc: Path):
    fn = getattr(build.load(name, csrc), f"gsplat_{name}")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, fields, cam: CameraView):
    """Raise on what the kernels do not take; return the fields and the
    camera's tensors contiguous and detached."""
    xyz, scaling, rotation, opacity, f_dc, f_rest, active = fields
    dev = xyz.device
    if dev.type != "cuda":
        raise ValueError(f"{name}_cuda needs CUDA tensors, got {dev}")
    n = xyz.shape[0]
    want = dict(xyz=(n, 3), scaling=(n, 3), rotation=(n, 4), opacity=(n,),
                f_dc=(n, 3))
    for k, x in zip(("xyz", "scaling", "rotation", "opacity", "f_dc"),
                    fields[:5]):
        if x.dtype != torch.float32 or tuple(x.shape) != want[k] \
                or x.device != dev:
            raise ValueError(f"{k} must be {want[k]} float32 on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} {x.device}")
    if f_rest.dtype != torch.float32 or f_rest.dim() != 3 \
            or f_rest.shape[0] != n or f_rest.shape[2] != 3 \
            or f_rest.shape[1] + 1 > MAX_COEFFS or f_rest.device != dev:
        raise ValueError(f"f_rest must be ({n}, K-1, 3) float32 on {dev} "
                         f"with K <= {MAX_COEFFS}, got "
                         f"{tuple(f_rest.shape)} {f_rest.dtype}")
    if active.dtype != torch.bool or tuple(active.shape) != (n,) \
            or active.device != dev:
        raise ValueError(f"active must be ({n},) bool on {dev}, got "
                         f"{tuple(active.shape)} {active.dtype}")
    cam_t = (cam.world_view, cam.full_proj, cam.camera_center, cam.tanfovx,
             cam.tanfovy)
    for x, shape in zip(cam_t, ((4, 4), (4, 4), (3,), (), ())):
        if x.dtype != torch.float32 or tuple(x.shape) != shape \
                or x.device != dev:
            raise ValueError(f"the camera's tensors must be float32 on {dev}")
    return ([x.detach().contiguous() for x in fields],
            [x.detach().contiguous() for x in cam_t])


def _settings_args(n: int, n_coeffs: int, s: Settings):
    return (n, n_coeffs, int(s.active_sh_degree), int(s.width),
            int(s.height), float(s.scaling_modifier), int(s.antialiasing),
            float(s.dilation), float(s.alpha_min))


def _raise_on(err: int, name: str):
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def preprocess_fwd_cuda(fields, tap: Optional[torch.Tensor],
                        cam: CameraView, s: Settings):
    """One launch: ``fields`` = (xyz, scaling, rotation, opacity, f_dc,
    f_rest, active) of N gaussians, raw, on one CUDA device; ``tap`` (N, 2)
    or None. Returns packed (N+1, 16), depth, radius, rx, ry, t_cut (N,).
    Not differentiable by itself: ``preprocess_packed_cuda`` is."""
    fields, cam_t = _check("preprocess_fwd", fields, cam)
    n, dev = fields[0].shape[0], fields[0].device
    if tap is not None:
        if tap.dtype != torch.float32 or tuple(tap.shape) != (n, 2) \
                or tap.device != dev:
            raise ValueError(f"tap must be ({n}, 2) float32 on {dev}, got "
                             f"{tuple(tap.shape)} {tap.dtype}")
        tap = tap.detach().contiguous()
    packed = torch.empty((n + 1, 16), dtype=torch.float32, device=dev)
    cols = [torch.empty((n,), dtype=torch.float32, device=dev)
            for _ in range(5)]
    with torch.cuda.device(dev):
        _raise_on(_bound("preprocess_fwd", build.sources())(
            *(x.data_ptr() for x in fields),
            None if tap is None else tap.data_ptr(),
            *(x.data_ptr() for x in cam_t),
            *_settings_args(n, fields[5].shape[1] + 1, s),
            packed.data_ptr(), *(c.data_ptr() for c in cols),
            torch.cuda.current_stream(dev).cuda_stream), "preprocess_fwd")
    preprocess_fwd_cuda.launches += 1
    return (packed, *cols)


preprocess_fwd_cuda.launches = 0   # kernel launches since the last reset


def preprocess_bwd_cuda(fields, cam: CameraView, s: Settings,
                        d_packed: torch.Tensor, with_tap: bool):
    """One launch: the gradients (d xyz, d scaling, d rotation, d opacity,
    d f_dc, d f_rest, d tap or None) of the raw fields under the cotangent
    ``d_packed`` (N+1, 16) of the packed rows."""
    fields, cam_t = _check("preprocess_bwd", fields, cam)
    n, dev = fields[0].shape[0], fields[0].device
    if d_packed.dtype != torch.float32 or tuple(d_packed.shape) != (n + 1, 16) \
            or d_packed.device != dev:
        raise ValueError(f"d_packed must be ({n + 1}, 16) float32 on {dev}, "
                         f"got {tuple(d_packed.shape)} {d_packed.dtype}")
    d_packed = d_packed.contiguous()
    grads = [torch.empty_like(x) for x in fields[:6]]
    d_tap = torch.empty((n, 2), dtype=torch.float32, device=dev) \
        if with_tap else None
    with torch.cuda.device(dev):
        _raise_on(_bound("preprocess_bwd", build.sources())(
            *(x.data_ptr() for x in fields),
            *(x.data_ptr() for x in cam_t),
            *_settings_args(n, fields[5].shape[1] + 1, s),
            d_packed.data_ptr(), *(g.data_ptr() for g in grads),
            None if d_tap is None else d_tap.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "preprocess_bwd")
    preprocess_bwd_cuda.launches += 1
    return (*grads, d_tap)


preprocess_bwd_cuda.launches = 0   # kernel launches since the last reset


class _PreprocessPacked(torch.autograd.Function):
    """The fused forward, with the fused backward as its gradient. Only the
    packed rows are differentiable; the forward saves its inputs alone."""

    @staticmethod
    def forward(ctx, xyz, scaling, rotation, opacity, f_dc, f_rest, tap,
                active, cam, s):
        fields = (xyz, scaling, rotation, opacity, f_dc, f_rest, active)
        out = preprocess_fwd_cuda(fields, tap, cam, s)
        ctx.save_for_backward(*fields)
        ctx.cam, ctx.s, ctx.with_tap = cam, s, tap is not None
        ctx.mark_non_differentiable(*out[1:])
        return out

    @staticmethod
    def backward(ctx, d_packed, *_):
        grads = preprocess_bwd_cuda(ctx.saved_tensors, ctx.cam, ctx.s,
                                    d_packed, ctx.with_tap)
        return (*grads, None, None, None)


def preprocess_packed_cuda(fields, tap: Optional[torch.Tensor],
                           cam: CameraView, s: Settings):
    """Differentiable (packed, depth, radius, rx, ry, t_cut) of the raw
    ``fields`` (xyz, scaling, rotation, opacity, f_dc, f_rest, active) and
    the tap, through the two kernels."""
    xyz, scaling, rotation, opacity, f_dc, f_rest, active = fields
    return _PreprocessPacked.apply(xyz, scaling, rotation, opacity, f_dc,
                                   f_rest, tap, active, cam, s)
