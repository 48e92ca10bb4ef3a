"""The port's ``Scene`` built from a point cloud, and ``Scene.save``, against
the JAX package's on the scene of tests/test_cli.py (written with the
port's COLMAP writers), with the same ``random.seed`` before each:
``input.ply`` byte for byte, ``cameras.json`` and the camera order equal,
the initial gaussians equal to JAX's ``create_from_pcd`` within the kNN
test's tolerance (rtol 1e-5 / atol 1e-5, test_torch_train.py), and the PLY
and ``exposure.json`` that ``save`` writes read back equal by both
packages."""
import json
import random

import numpy as np
import torch

from gsplat_tpu import config as jcfg
from gsplat_tpu.scene import Scene as JaxScene
from gsplat_tpu.scene import ply as jply
from gsplat_tpu_torch import config as tcfg
from gsplat_tpu_torch.models import gaussian_model as tgm
from gsplat_tpu_torch.scene import Scene
from gsplat_tpu_torch.scene import ply as tply

from torch_parity import PARAM_FIELDS, make_colmap_scene, t2n

PLY_FIELDS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


def _scenes(tmp_path, **kw):
    src = make_colmap_scene(str(tmp_path / "scene"))
    random.seed(3)
    js = JaxScene(jcfg.ModelConfig(source_path=src, sh_degree=1, eval=True,
                                   model_path=str(tmp_path / "jax"), **kw), 1)
    random.seed(3)
    ts = Scene(tcfg.ModelConfig(source_path=src, sh_degree=1, eval=True,
                                model_path=str(tmp_path / "port"), **kw), 1,
               capacity=200, device="cpu")
    return js, ts


def test_scene_init_from_point_cloud_matches_jax(tmp_path):
    js, ts = _scenes(tmp_path)
    assert ts.loaded_iter is None
    for name in ("input.ply", "cameras.json"):
        with open(tmp_path / "jax" / name, "rb") as a, \
                open(tmp_path / "port" / name, "rb") as b:
            assert a.read() == b.read(), name
    cams = json.loads((tmp_path / "port" / "cameras.json").read_text())
    assert [c["id"] for c in cams] == list(range(6))
    # test cameras first, in the readers' order (llffhold 8: image 0)
    assert cams[0]["img_name"] == "im_000"
    for split in ("getTrainCameras", "getTestCameras"):
        assert [c.image_name for c in getattr(ts, split)()] == \
            [c.image_name for c in getattr(js, split)()]
    assert ts.cameras_extent == js.cameras_extent
    assert ts.exposure_mapping == js.exposure_mapping
    assert [c.exposure_idx for c in ts.getTrainCameras()] == \
        [c.exposure_idx for c in js.getTrainCameras()]

    g = ts.gaussians
    assert g.capacity == 200 and g.num_active() == 120
    assert g.active_sh_degree == 0 and g.max_sh_degree == 1
    jg = js.gaussians
    np.testing.assert_array_equal(t2n(g.active)[:120], np.asarray(jg.active))
    for k in PARAM_FIELDS[:-2]:
        np.testing.assert_allclose(t2n(getattr(g, k))[:120],
                                   np.asarray(getattr(jg, k)), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_scene_save_reads_back_in_both_packages(tmp_path, rng):
    """``save`` compacts the live rows to the front (in slot order) and
    writes them; both packages' PLY readers and load-iteration Scenes read
    them back, and ``exposure.json`` maps every train image to its affine."""
    _, ts = _scenes(tmp_path, train_test_exp=True)
    g = ts.gaussians
    live = np.zeros(g.capacity, bool)
    live[rng.choice(g.capacity, 90, replace=False)] = True
    arrays = {k: rng.standard_normal(tuple(getattr(g, k).shape)).astype(
        np.float32) for k in PLY_FIELDS}
    ts.gaussians = tgm.from_numpy(dict(arrays, active=live), device="cpu")
    exposures = rng.standard_normal(
        (len(ts.getTrainCameras()), 3, 4)).astype(np.float32)
    ts.save(9, exposures=exposures)

    path = tmp_path / "port" / "point_cloud" / "iteration_9" / \
        "point_cloud.ply"
    want = {k: v[live] for k, v in arrays.items()}
    for data in (tply.load_gaussian_ply(str(path)),
                 jply.load_gaussian_ply(str(path))):
        for k in PLY_FIELDS:
            np.testing.assert_array_equal(np.asarray(data[k]), want[k],
                                          err_msg=k)
    cfg = dict(source_path=str(tmp_path / "scene"), sh_degree=1,
               model_path=str(tmp_path / "port"))
    back = Scene(tcfg.ModelConfig(**cfg), 1, load_iteration=-1,
                 device="cpu").gaussians
    jback = JaxScene(jcfg.ModelConfig(**cfg), 1, load_iteration=9).gaussians
    for k in PLY_FIELDS:
        np.testing.assert_array_equal(t2n(getattr(back, k)), want[k])
        np.testing.assert_array_equal(np.asarray(getattr(jback, k)), want[k])
    assert back.active_sh_degree == 1 == int(jback.active_sh_degree)

    exp = json.loads((tmp_path / "port" / "exposure.json").read_text())
    assert set(exp) == set(ts.exposure_mapping)
    for name, idx in ts.exposure_mapping.items():
        np.testing.assert_array_equal(np.asarray(exp[name], np.float32),
                                      exposures[idx])
    assert torch.equal(ts.gaussians.active, torch.tensor(live))
