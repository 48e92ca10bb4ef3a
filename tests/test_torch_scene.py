"""The port's render CLI on a tiny COLMAP scene written with the JAX
package's COLMAP and PLY writers: its PNGs must equal JAX ``render`` of the
same cameras, quantised as the CLI quantises, within 1 LSB."""
import os
import sys

import numpy as np

import jax
import jax.numpy as jnp

from gsplat_tpu.config import RasterizerConfig as JaxRasterizerConfig
from gsplat_tpu.core.camera import CameraView as JaxCameraView
from gsplat_tpu.models import gaussian_model as jgm
from gsplat_tpu.ops.rasterize import render as jax_render
from gsplat_tpu.scene import colmap as colmap_lib
from gsplat_tpu.scene import dataset_readers as jreaders
from gsplat_tpu.scene import ply as jply
from gsplat_tpu_torch.cli import render as render_cli

W, H, N_CAMS, N_GAUSS, ITER = 64, 48, 3, 400, 7


def _write_scene(root, rng):
    """COLMAP model + images under root/scene, a trained-model dir with a
    random-parameter point cloud under root/model."""
    from PIL import Image
    src = os.path.join(root, "scene")
    images = os.path.join(src, "images")
    os.makedirs(images)
    cams = {1: colmap_lib.ColmapCamera(
        1, "PINHOLE", W, H, np.array([60.0, 60.0, W / 2, H / 2]))}
    imgs = {}
    for i in range(N_CAMS):
        a = 2 * np.pi * i / N_CAMS
        pos = np.array([3 * np.sin(a), 0.2 * i, -3 * np.cos(a)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R_wc = np.stack([right, np.cross(fwd, right), fwd], axis=0)
        name = f"im_{i:03d}.png"
        imgs[i + 1] = colmap_lib.ColmapImage(
            i + 1, colmap_lib.rotmat2qvec(R_wc), -R_wc @ pos, 1, name)
        Image.fromarray(rng.integers(0, 255, (H, W, 3)).astype(np.uint8)) \
            .save(os.path.join(images, name))
    pts = (np.arange(50, dtype=np.int64), rng.standard_normal((50, 3)) * 0.5,
           rng.integers(0, 255, (50, 3)).astype(np.uint8), np.zeros(50))
    colmap_lib.write_model(cams, imgs, pts, os.path.join(src, "sparse", "0"))

    model = os.path.join(root, "model")
    K = 16                                       # SH degree 3
    params = dict(
        xyz=(rng.standard_normal((N_GAUSS, 3)) * 0.6).astype(np.float32),
        f_dc=rng.standard_normal((N_GAUSS, 3)).astype(np.float32),
        f_rest=(0.1 * rng.standard_normal((N_GAUSS, K - 1, 3))).astype(
            np.float32),
        opacity=rng.uniform(-1, 3, N_GAUSS).astype(np.float32),
        scaling=rng.uniform(-4.5, -2.5, (N_GAUSS, 3)).astype(np.float32),
        rotation=rng.standard_normal((N_GAUSS, 4)).astype(np.float32))
    jply.save_gaussian_ply(
        os.path.join(model, "point_cloud", f"iteration_{ITER}",
                     "point_cloud.ply"),
        *(params[k] for k in ("xyz", "f_dc", "f_rest", "opacity", "scaling",
                              "rotation")))
    return src, model, params


@jax.jit
def _jax_image(g, cam):
    return jax_render(g, cam, W, H, jnp.zeros(3),
                      JaxRasterizerConfig(use_pallas=False)).image


def _quantise(img_chw):
    return (np.clip(img_chw, 0, 1).transpose(1, 2, 0) * 255 + 0.5).astype(
        np.uint8)


def test_render_cli_matches_jax_render(tmp_path, rng, monkeypatch):
    from PIL import Image
    monkeypatch.setattr(sys, "stdout", sys.stdout)   # the CLI swaps stdout
    src, model, params = _write_scene(str(tmp_path), rng)
    render_cli.main(["-s", src, "-m", model, "--device", "cpu", "--quiet"])

    g = jgm.GaussianParams(
        active=jnp.ones(N_GAUSS, bool), active_sh_degree=jnp.asarray(3),
        **{k: jnp.asarray(v) for k, v in params.items()})
    infos = jreaders.read_colmap_scene(src).train_cameras
    out_dir = os.path.join(model, "train", f"ours_{ITER}")
    assert sorted(os.listdir(os.path.join(out_dir, "renders"))) == \
        [f"{i:05d}.png" for i in range(N_CAMS)]
    n_lit = 0
    for idx, info in enumerate(infos):
        cam = JaxCameraView.create(info.R, info.T, info.FovX, info.FovY)
        want = _quantise(np.asarray(_jax_image(g, cam)))
        got = np.asarray(Image.open(os.path.join(out_dir, "renders",
                                                 f"{idx:05d}.png")))
        assert got.shape == (H, W, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, idx
        n_lit += int((want > 0).any(axis=-1).sum())
        gt = np.asarray(Image.open(os.path.join(out_dir, "gt",
                                                f"{idx:05d}.png")))
        ref = np.asarray(Image.open(info.image_path))
        np.testing.assert_array_equal(gt, ref)
    assert n_lit > W * H // 4          # the views actually see the splats
