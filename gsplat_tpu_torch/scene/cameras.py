"""Host-side cameras: image/mask/depth loading and the device CameraView.
Counterpart of gsplat_tpu/scene/cameras.py. Images decode and resize
through the native threaded loader (gsplat_tpu_torch/native: libjpeg /
libpng and an area filter) when it builds, the whole camera set in one
``decode_batch`` per target resolution; PIL, imported where an image is
read, is the fallback, and ``GSPLAT_NATIVE_LOADER=0`` forces it."""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from gsplat_tpu_torch.core.camera import CameraView
from gsplat_tpu_torch.core.transforms import fov2focal
from gsplat_tpu_torch.scene.dataset_readers import CameraInfo

WARNED_ABOUT_RESOLUTION = [False]


@dataclass
class Camera:
    """One view. Arrays are numpy: image (3,H,W) f32 in [0,1]."""
    uid: int
    colmap_id: int
    R: np.ndarray
    T: np.ndarray
    FoVx: float
    FoVy: float
    image: np.ndarray                    # (3,H,W)
    alpha_mask: np.ndarray               # (1,H,W)
    invdepthmap: Optional[np.ndarray]    # (1,H,W) or None
    depth_mask: Optional[np.ndarray]     # (1,H,W) or None
    depth_reliable: bool
    image_name: str
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0
    trans: np.ndarray = field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0
    exposure_idx: int = -1

    def view(self, device="cuda") -> CameraView:
        return CameraView.create(self.R, self.T, self.FoVx, self.FoVy,
                                 self.znear, self.zfar, self.trans, self.scale,
                                 exposure_idx=self.exposure_idx, device=device)

    @property
    def image_width(self):
        return self.width

    @property
    def image_height(self):
        return self.height


def _resolution_policy(resolution_arg: int, resolution_scale: float,
                       orig_w: int, orig_h: int):
    """(W, H) target: divisor flags {1,2,4,8}, target width for other
    positive values, auto-downscale of images wider than 1600 px at -1."""
    if resolution_arg in [1, 2, 4, 8]:
        scale = resolution_scale * resolution_arg
        return round(orig_w / scale), round(orig_h / scale)
    if resolution_arg == -1:
        if orig_w > 1600:
            if not WARNED_ABOUT_RESOLUTION[0]:
                print("[ INFO ] Encountered quite large input images "
                      "(>1.6K pixels width), rescaling to 1.6K.\n"
                      " If this is not desired, please explicitly specify "
                      "'--resolution/-r' as 1")
                WARNED_ABOUT_RESOLUTION[0] = True
            global_down = orig_w / 1600
        else:
            global_down = 1
    else:
        global_down = orig_w / resolution_arg
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def load_cam(resolution_arg: int, cam_info: CameraInfo, resolution_scale=1.0,
             train_test_exp=False, is_test_dataset=False,
             predecoded=None) -> Camera:
    """Resolution policy + image/depth decode. ``predecoded``: the image's
    (4,H,W) RGBA buffer and alpha flag from the native batch decoder."""
    from PIL import Image

    from gsplat_tpu_torch import native

    size = native.image_size(cam_info.image_path) if native.available() \
        else None
    decoded = None
    if size is None:
        with Image.open(cam_info.image_path) as pil:
            resolution = _resolution_policy(resolution_arg, resolution_scale,
                                            *pil.size)
    else:
        resolution = _resolution_policy(resolution_arg, resolution_scale,
                                        *size)
        decoded = predecoded if predecoded is not None \
            else native.decode_image(cam_info.image_path, *resolution)

    if decoded is not None:
        chw, has_alpha = decoded                    # (4,H,W) RGBA
        resized = chw.transpose(1, 2, 0)
        if not has_alpha:
            resized = resized[:, :, :3]
    else:
        with Image.open(cam_info.image_path) as pil:
            arr = np.asarray(pil).astype(np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[:, :, None].repeat(3, axis=2)
        img = Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8))
        resized = np.asarray(img.resize(resolution)).astype(np.float32) \
            / 255.0
        if resized.ndim == 2:
            resized = resized[:, :, None].repeat(3, axis=2)
    rgb = resized[:, :, :3]
    if resized.shape[2] == 4:
        alpha = resized[:, :, 3:4]
        if cam_info.bg is not None:
            # Blender RGBA: composite over the background
            rgb = rgb * alpha + cam_info.bg[None, None, :] * (1 - alpha)
            alpha = np.ones_like(alpha)
    else:
        alpha = np.ones_like(rgb[:, :, :1])

    W, H = resolution
    if train_test_exp and cam_info.is_test:
        alpha = alpha.copy()
        if is_test_dataset:
            alpha[:, :W // 2] = 0
        else:
            alpha[:, W // 2:] = 0

    invdepth = None
    depth_mask = None
    depth_reliable = False
    if cam_info.depth_path:
        with Image.open(cam_info.depth_path) as dimg:
            raw = np.asarray(dimg).astype(np.float32)
        # synthetic /512, 16-bit real captures /2^16 with depth_params
        inv = raw / (512.0 if cam_info.depth_params is None
                     and raw.max() < 60000 else float(2 ** 16))
        inv = np.asarray(Image.fromarray(inv).resize(
            resolution, Image.Resampling.NEAREST)).copy()
        inv[inv < 0] = 0
        depth_mask = np.ones((1, H, W), np.float32)
        depth_reliable = True
        dp = cam_info.depth_params
        if dp is not None:
            if dp["scale"] < 0.2 * dp["med_scale"] or \
                    dp["scale"] > 5 * dp["med_scale"]:
                depth_reliable = False
                depth_mask *= 0
            if dp["scale"] > 0:
                inv = inv * dp["scale"] + dp["offset"]
        if inv.ndim != 2:
            inv = inv[..., 0]
        invdepth = inv[None]

    return Camera(
        uid=cam_info.uid, colmap_id=cam_info.uid, R=cam_info.R, T=cam_info.T,
        FoVx=cam_info.FovX, FoVy=cam_info.FovY,
        image=np.clip(rgb, 0, 1).transpose(2, 0, 1),
        alpha_mask=alpha.transpose(2, 0, 1),
        invdepthmap=invdepth, depth_mask=depth_mask,
        depth_reliable=depth_reliable, image_name=cam_info.image_name,
        width=W, height=H)


def camera_list_from_infos(cam_infos: List[CameraInfo], resolution_scale,
                           resolution_arg, is_test_dataset,
                           train_test_exp=False) -> List[Camera]:
    """The cameras of ``cam_infos``. With the native loader built, the whole
    set decodes through one threaded ``decode_batch`` per target
    resolution; an image it cannot read decodes by itself."""
    from gsplat_tpu_torch import native

    predecoded = {}
    if native.available():
        groups = {}
        for i, c in enumerate(cam_infos):
            size = native.image_size(c.image_path)
            if size is None:
                continue
            res = _resolution_policy(resolution_arg, resolution_scale, *size)
            groups.setdefault(res, []).append(i)
        for (w, h), idxs in groups.items():
            out = native.decode_batch(
                [cam_infos[i].image_path for i in idxs], w, h)
            if out is not None:
                bufs, flags = out
                for j, i in enumerate(idxs):
                    predecoded[i] = (bufs[j], bool(flags[j]))
    return [load_cam(resolution_arg, c, resolution_scale, train_test_exp,
                     is_test_dataset, predecoded=predecoded.get(i))
            for i, c in enumerate(cam_infos)]


def camera_to_json(idx: int, camera) -> dict:
    """Camera record of the viewers' ``cameras.json``."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = camera.R.transpose()
    Rt[:3, 3] = camera.T
    Rt[3, 3] = 1.0
    W2C = np.linalg.inv(Rt)
    return {
        "id": idx,
        "img_name": camera.image_name,
        "width": camera.width,
        "height": camera.height,
        "position": W2C[:3, 3].tolist(),
        "rotation": [x.tolist() for x in W2C[:3, :3]],
        "fy": fov2focal(camera.FovY if hasattr(camera, "FovY")
                        else camera.FoVy, camera.height),
        "fx": fov2focal(camera.FovX if hasattr(camera, "FovX")
                        else camera.FoVx, camera.width),
    }


class MiniCam:
    """Viewer-protocol camera; the matrices come in the reference's
    transposed (row-vector) convention."""

    def __init__(self, width, height, fovy, fovx, znear, zfar,
                 world_view_transform: np.ndarray,
                 full_proj_transform: np.ndarray):
        self.image_width = width
        self.image_height = height
        self.FoVy = fovy
        self.FoVx = fovx
        self.znear = znear
        self.zfar = zfar
        self.world_view_transform = world_view_transform
        self.full_proj_transform = full_proj_transform

    def view(self, device="cuda") -> CameraView:
        w2v = np.asarray(self.world_view_transform, np.float32).T
        return CameraView.from_numpy(dict(
            world_view=w2v,
            full_proj=np.asarray(self.full_proj_transform, np.float32).T,
            camera_center=np.linalg.inv(w2v)[:3, 3],
            tanfovx=math.tan(self.FoVx * 0.5),
            tanfovy=math.tan(self.FoVy * 0.5)), device=device)
