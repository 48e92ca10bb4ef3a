"""Scene assembly: detect the dataset layout, build camera lists, initialise
the Gaussians from the point cloud or load a trained model, save the model.
Counterpart of gsplat_tpu/scene/__init__.py.

A new model directory gets ``input.ply`` (the scene's point cloud, copied
byte for byte) and ``cameras.json`` (test cameras first, then train, in the
readers' order); ``save`` writes ``point_cloud/iteration_N/point_cloud.ply``
and, with exposures, ``exposure.json``, in the formats either package reads.
The cameras are shuffled with Python's ``random`` where the JAX package
shuffles them, so that one seed gives both packages one camera order.
"""
from __future__ import annotations

import json
import os
import random
import shutil
from typing import Dict, List, Optional

import numpy as np

from gsplat_tpu_torch.models import gaussian_model as gm
from gsplat_tpu_torch.scene import dataset_readers, ply as ply_lib
from gsplat_tpu_torch.scene.cameras import (Camera, camera_list_from_infos,
                                            camera_to_json)
from gsplat_tpu_torch.utils.general import resolve_device


def searchForMaxIteration(folder: str) -> int:
    return max(int(fname.split("_")[-1]) for fname in os.listdir(folder))


class Scene:
    gaussians: gm.GaussianParams

    def __init__(self, args, gaussians_sh_degree: int, load_iteration=None,
                 shuffle=True, resolution_scales=(1.0,), capacity: int = 0,
                 *, device="cuda"):
        """args: ModelConfig-like (source_path, model_path, images, depths,
        white_background, eval, train_test_exp, resolution). Without
        ``load_iteration`` the Gaussians come from the point cloud, in
        ``max(capacity, points)`` slots."""
        dev = resolve_device(device)
        self.model_path = args.model_path
        self.loaded_iter = None
        if load_iteration:
            self.loaded_iter = load_iteration
            if load_iteration == -1:
                self.loaded_iter = searchForMaxIteration(
                    os.path.join(self.model_path, "point_cloud"))
            print(f"Loading trained model at iteration {self.loaded_iter}")

        if os.path.exists(os.path.join(args.source_path, "sparse")):
            scene_info = dataset_readers.read_colmap_scene(
                args.source_path, args.images, args.depths, args.eval,
                args.train_test_exp)
        elif os.path.exists(os.path.join(args.source_path,
                                         "transforms_train.json")):
            print("Found transforms_train.json file, assuming Blender data set!")
            scene_info = dataset_readers.read_nerf_synthetic_scene(
                args.source_path, args.white_background, args.depths, args.eval)
        else:
            raise ValueError("Could not recognize scene type!")

        if not self.loaded_iter and self.model_path:
            os.makedirs(self.model_path, exist_ok=True)
            shutil.copyfile(scene_info.ply_path,
                            os.path.join(self.model_path, "input.ply"))
            cam_json = [camera_to_json(idx, cam) for idx, cam in enumerate(
                scene_info.test_cameras + scene_info.train_cameras)]
            with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
                json.dump(cam_json, f)

        if shuffle:
            random.shuffle(scene_info.train_cameras)
            random.shuffle(scene_info.test_cameras)
        self.cameras_extent = scene_info.nerf_normalization["radius"]

        self.train_cameras: Dict[float, List[Camera]] = {}
        self.test_cameras: Dict[float, List[Camera]] = {}
        for scale in resolution_scales:
            print("Loading Training Cameras")
            self.train_cameras[scale] = camera_list_from_infos(
                scene_info.train_cameras, scale, args.resolution, False,
                args.train_test_exp)
            print("Loading Test Cameras")
            self.test_cameras[scale] = camera_list_from_infos(
                scene_info.test_cameras, scale, args.resolution, True,
                args.train_test_exp)

        # exposure index per train image
        self.exposure_mapping = {
            cam.image_name: i
            for i, cam in enumerate(self.train_cameras[resolution_scales[0]])}
        for scale in resolution_scales:
            for cam in self.train_cameras[scale]:
                cam.exposure_idx = self.exposure_mapping.get(cam.image_name, -1)

        if self.loaded_iter:
            data = ply_lib.load_gaussian_ply(os.path.join(
                self.model_path, "point_cloud",
                f"iteration_{self.loaded_iter}", "point_cloud.ply"))
            self.gaussians = gm.from_numpy(
                data, device=dev, capacity=max(capacity, data["xyz"].shape[0]))
        else:
            xyz, rgb = scene_info.point_cloud
            print(f"Number of points at initialisation : {xyz.shape[0]}")
            self.gaussians = gm.create_from_pcd(
                xyz, rgb, gaussians_sh_degree,
                capacity=max(capacity, xyz.shape[0]), device=dev)
        self.is_nerf_synthetic = scene_info.is_nerf_synthetic

    def save(self, iteration: int, exposures: Optional[np.ndarray] = None):
        """The live Gaussians, compacted, to the iteration's PLY; with
        ``exposures`` (n_images, 3, 4) also ``exposure.json``."""
        g = gm.compact(self.gaussians)
        n = g.num_active()
        arrays = {k: getattr(g, k)[:n].cpu().numpy() for k in (
            "xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")}
        ply_lib.save_gaussian_ply(
            os.path.join(self.model_path, f"point_cloud/iteration_{iteration}",
                         "point_cloud.ply"), **arrays)
        if exposures is not None:
            exposure_dict = {name: np.asarray(exposures[idx]).tolist()
                             for name, idx in self.exposure_mapping.items()}
            with open(os.path.join(self.model_path, "exposure.json"), "w") as f:
                json.dump(exposure_dict, f, indent=2)

    def getTrainCameras(self, scale=1.0) -> List[Camera]:
        return self.train_cameras[scale]

    def getTestCameras(self, scale=1.0) -> List[Camera]:
        return self.test_cameras[scale]
