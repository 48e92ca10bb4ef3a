"""Scene readers: COLMAP layouts and Blender (NeRF-synthetic) transforms.
Counterpart of gsplat_tpu/scene/dataset_readers.py; PIL is imported only
where an image header must be read."""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

from gsplat_tpu_torch.core.transforms import focal2fov, fov2focal, world_to_view
from gsplat_tpu_torch.scene import colmap as colmap_lib
from gsplat_tpu_torch.scene import ply as ply_lib


@dataclass
class CameraInfo:
    uid: int
    R: np.ndarray              # (3,3) cam→world rotation (COLMAP R^T)
    T: np.ndarray              # (3,) world→cam translation
    FovY: float
    FovX: float
    image_path: str
    image_name: str
    width: int
    height: int
    depth_path: str = ""
    depth_params: Optional[dict] = None
    is_test: bool = False
    # Blender only: composite RGBA over this background at load time
    bg: Optional[np.ndarray] = None


@dataclass
class SceneInfo:
    point_cloud: Optional[tuple]       # (xyz (N,3) f32, rgb (N,3) f32 [0,1])
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: dict           # {"translate": (3,), "radius": float}
    ply_path: str
    is_nerf_synthetic: bool = False


def get_nerfpp_norm(cam_infos: List[CameraInfo]) -> dict:
    """Camera-bounding radius ×1.1."""
    centers = np.stack([np.linalg.inv(world_to_view(c.R, c.T))[:3, 3]
                        for c in cam_infos])
    avg = centers.mean(axis=0)
    radius = float(np.linalg.norm(centers - avg, axis=1).max()) * 1.1
    return {"translate": -avg, "radius": radius}


def read_colmap_cameras(cameras, images, images_folder, depths_folder,
                        depths_params, test_cam_names_list) -> List[CameraInfo]:
    infos = []
    for key in sorted(images.keys(), key=lambda k: images[k].name):
        extr = images[key]
        intr = cameras[extr.camera_id]
        height, width = intr.height, intr.width
        R = np.transpose(colmap_lib.qvec2rotmat(extr.qvec))
        T = np.array(extr.tvec)
        if intr.model == "SIMPLE_PINHOLE":
            focal_x = focal_y = intr.params[0]
        elif intr.model == "PINHOLE":
            focal_x, focal_y = intr.params[0], intr.params[1]
        else:
            raise ValueError(
                "Colmap camera model not handled: only undistorted datasets "
                "(PINHOLE or SIMPLE_PINHOLE cameras) supported!")
        n_remove = len(extr.name.split(".")[-1]) + 1
        image_name = extr.name[:-n_remove]
        depth_params = (depths_params.get(image_name)
                        if depths_params is not None else None)
        depth_path = (os.path.join(depths_folder, f"{image_name}.png")
                      if depths_folder else "")
        infos.append(CameraInfo(
            uid=intr.id, R=R, T=T, FovY=focal2fov(focal_y, height),
            FovX=focal2fov(focal_x, width),
            image_path=os.path.join(images_folder, extr.name),
            image_name=image_name, width=width, height=height,
            depth_path=depth_path, depth_params=depth_params,
            is_test=image_name in test_cam_names_list))
    return infos


def read_colmap_scene(path: str, images: str = "images", depths: str = "",
                      eval: bool = False, train_test_exp: bool = False,
                      llffhold: int = 8) -> SceneInfo:
    sparse0 = os.path.join(path, "sparse", "0")
    if not os.path.isdir(sparse0):
        sparse0 = os.path.join(path, "sparse")
    cameras, images_meta, points = colmap_lib.read_model(sparse0)

    depth_params = None
    depths_params_file = os.path.join(sparse0, "depth_params.json")
    if depths and os.path.exists(depths_params_file):
        with open(depths_params_file) as f:
            depth_params = json.load(f)
        all_scales = np.array([depth_params[k]["scale"] for k in depth_params])
        med_scale = (np.median(all_scales[all_scales > 0])
                     if (all_scales > 0).sum() else 0)
        for k in depth_params:
            depth_params[k]["med_scale"] = med_scale

    if eval:
        if "360" in path:
            llffhold = 8
        if llffhold:
            names = sorted(img.name for img in images_meta.values())
            test_names = [name for i, name in enumerate(names)
                          if i % llffhold == 0]
        else:
            with open(os.path.join(sparse0, "test.txt")) as f:
                test_names = [ln.strip() for ln in f if ln.strip()]
        test_names = [n[:-len(n.split(".")[-1]) - 1] if "." in n else n
                      for n in test_names]
    else:
        test_names = []

    cam_infos = read_colmap_cameras(
        cameras, images_meta, os.path.join(path, images or "images"),
        os.path.join(path, depths) if depths else "", depth_params, test_names)
    train_cams = [c for c in cam_infos if train_test_exp or not c.is_test]
    test_cams = [c for c in cam_infos if c.is_test]

    ply_path = os.path.join(sparse0, "points3D.ply")
    if not os.path.exists(ply_path):
        if points is None:
            raise FileNotFoundError(f"no points3D in {sparse0}")
        xyz, rgb, _ = points
        ply_lib.save_point_ply(ply_path, xyz, rgb)
    return SceneInfo(point_cloud=ply_lib.load_point_ply(ply_path),
                     train_cameras=train_cams, test_cameras=test_cams,
                     nerf_normalization=get_nerfpp_norm(train_cams),
                     ply_path=ply_path, is_nerf_synthetic=False)


def read_blender_cameras(path, transformsfile, depths_folder, white_background,
                         is_test, extension=".png") -> List[CameraInfo]:
    from PIL import Image
    infos = []
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    for idx, frame in enumerate(contents["frames"]):
        cam_name = os.path.join(path, frame["file_path"] + extension)
        c2w = np.array(frame["transform_matrix"])
        # OpenGL/Blender camera axes (Y up, Z back) → COLMAP (Y down, Z fwd)
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        with Image.open(cam_name) as image:
            width, height = image.size
        image_name = Path(cam_name).stem
        infos.append(CameraInfo(
            uid=idx, R=np.transpose(w2c[:3, :3]), T=w2c[:3, 3],
            FovY=focal2fov(fov2focal(fovx, width), height), FovX=fovx,
            image_path=cam_name, image_name=image_name, width=width,
            height=height,
            depth_path=(os.path.join(depths_folder, f"{image_name}.png")
                        if depths_folder else ""),
            depth_params=None, is_test=is_test,
            bg=np.array([1.0, 1.0, 1.0]) if white_background
            else np.array([0.0, 0.0, 0.0])))
    return infos


def read_nerf_synthetic_scene(path: str, white_background: bool = False,
                              depths: str = "", eval: bool = False,
                              extension: str = ".png") -> SceneInfo:
    depths_folder = os.path.join(path, depths) if depths else ""
    train_cams = read_blender_cameras(path, "transforms_train.json",
                                      depths_folder, white_background, False,
                                      extension)
    test_cams = read_blender_cameras(path, "transforms_test.json",
                                     depths_folder, white_background, True,
                                     extension) if eval or os.path.exists(
        os.path.join(path, "transforms_test.json")) else []
    if not eval:
        train_cams = train_cams + test_cams
        test_cams = []

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        print(f"Generating random point cloud ({num_pts})...")
        rng = np.random.default_rng(0)
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        rgb = rng.random((num_pts, 3))
        ply_lib.save_point_ply(ply_path, xyz, (rgb * 255).astype(np.uint8))
    return SceneInfo(point_cloud=ply_lib.load_point_ply(ply_path),
                     train_cameras=train_cams, test_cameras=test_cams,
                     nerf_normalization=get_nerfpp_norm(train_cams),
                     ply_path=ply_path, is_nerf_synthetic=True)
