"""Scene assembly: detect the dataset layout, build camera lists, load the
trained Gaussians. Counterpart of gsplat_tpu/scene/__init__.py, with the
load-iteration path only: initialising from the point cloud belongs to
training."""
from __future__ import annotations

import os
import random
from typing import Dict, List

from gsplat_tpu_torch.models import gaussian_model as gm
from gsplat_tpu_torch.scene import dataset_readers, ply as ply_lib
from gsplat_tpu_torch.scene.cameras import Camera, camera_list_from_infos
from gsplat_tpu_torch.utils.general import resolve_device


def searchForMaxIteration(folder: str) -> int:
    return max(int(fname.split("_")[-1]) for fname in os.listdir(folder))


class Scene:
    gaussians: gm.GaussianParams

    def __init__(self, args, gaussians_sh_degree: int, load_iteration=None,
                 shuffle=True, resolution_scales=(1.0,), capacity: int = 0,
                 *, device="cuda"):
        """args: ModelConfig-like (source_path, model_path, images, depths,
        white_background, eval, train_test_exp, resolution)."""
        dev = resolve_device(device)
        if not load_iteration:
            raise NotImplementedError("training slice")
        self.model_path = args.model_path
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

        data = ply_lib.load_gaussian_ply(os.path.join(
            self.model_path, "point_cloud", f"iteration_{self.loaded_iter}",
            "point_cloud.ply"))
        self.gaussians = gm.from_numpy(
            data, device=dev, capacity=max(capacity, data["xyz"].shape[0]))
        self.is_nerf_synthetic = scene_info.is_nerf_synthetic

    def getTrainCameras(self, scale=1.0) -> List[Camera]:
        return self.train_cameras[scale]

    def getTestCameras(self, scale=1.0) -> List[Camera]:
        return self.test_cameras[scale]
