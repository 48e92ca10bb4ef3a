"""The port's render CLI on a tiny COLMAP scene written with the JAX
package's COLMAP and PLY writers: its PNGs must equal JAX ``render`` of the
same cameras, quantised as the CLI quantises, within 1 LSB; the same CLI
with a ``cfg_args.json`` that JAX wrote. The port's COLMAP writers: their
round trip, and models that each package writes and the other reads."""
import os
import sys

import numpy as np
import pytest

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
from gsplat_tpu_torch.scene import colmap as tcolmap

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


def _colmap_model(rng, mod, with_points=True):
    """A small COLMAP model as ``mod``'s dataclasses: two cameras, two
    images (the second without 2D points unless ``with_points``), three
    points."""
    cams = {1: mod.ColmapCamera(1, "PINHOLE", 64, 48,
                                np.array([60.0, 61.0, 32.0, 24.0])),
            2: mod.ColmapCamera(2, "SIMPLE_RADIAL", 80, 60,
                                np.array([70.0, 40.0, 30.0, 0.01]))}
    imgs = {}
    for iid, cid, n_pts in ((5, 1, 2), (9, 2, 3 if with_points else 0)):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        imgs[iid] = mod.ColmapImage(
            iid, q, rng.standard_normal(3), cid, f"img{iid}.png",
            xys=rng.uniform(0, 50, (n_pts, 2)),
            point3D_ids=rng.integers(-1, 3, n_pts).astype(np.int64))
    pts = (np.array([0, 1, 2], np.int64), rng.standard_normal((3, 3)),
           rng.integers(0, 255, (3, 3)).astype(np.uint8),
           np.array([0.5, 0.25, 1.5]))
    return cams, imgs, pts


def _assert_same_model(got, cams, imgs, pts):
    cams2, imgs2, pts2 = got
    assert sorted(cams2) == sorted(cams) and sorted(imgs2) == sorted(imgs)
    for k, c in cams.items():
        assert (cams2[k].model, cams2[k].width, cams2[k].height) == \
            (c.model, c.width, c.height)
        np.testing.assert_array_equal(cams2[k].params, c.params)
    for k, im in imgs.items():
        assert (imgs2[k].camera_id, imgs2[k].name) == (im.camera_id, im.name)
        for f in ("qvec", "tvec", "xys", "point3D_ids"):
            np.testing.assert_array_equal(
                np.asarray(getattr(imgs2[k], f)).reshape(
                    np.shape(getattr(im, f))), getattr(im, f), err_msg=f)
    for a, b in zip(pts2, pts[1:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("binary", [True, False], ids=["bin", "txt"])
def test_colmap_writer_reader_roundtrip(tmp_path, rng, binary):
    """The port's write_model -> read_model round trip (the port of
    tests/test_scene.py's), with read_points3d_full and rotmat2qvec."""
    cams, imgs, pts = _colmap_model(rng, tcolmap, with_points=False)
    d = str(tmp_path / "sparse")
    tcolmap.write_model(cams, imgs, pts, d, binary=binary)
    _assert_same_model(tcolmap.read_model(d), cams, imgs, pts)
    full = tcolmap.read_points3d_full(os.path.join(d, "points3D.bin"),
                                      os.path.join(d, "points3D.txt"))
    for a, b in zip(full, pts):
        np.testing.assert_array_equal(a, b)
    for im in imgs.values():
        R = tcolmap.qvec2rotmat(im.qvec)
        q = tcolmap.rotmat2qvec(R)
        np.testing.assert_allclose(q, im.qvec * np.sign(im.qvec[0]),
                                   atol=1e-12)
        np.testing.assert_array_equal(q, colmap_lib.rotmat2qvec(R))


@pytest.mark.parametrize("binary", [True, False], ids=["bin", "txt"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_colmap_models_cross_read(tmp_path, rng, writer, binary):
    """A model the port writes, JAX's read_model reads, and the other way
    round. (JAX's text reader drops empty lines, so in text every image has
    2D points: an image without any writes an empty line.)"""
    wmod, rmod = ((tcolmap, colmap_lib) if writer == "port"
                  else (colmap_lib, tcolmap))
    cams, imgs, pts = _colmap_model(rng, wmod, with_points=not binary
                                    or writer == "jax")
    d = str(tmp_path / "sparse")
    wmod.write_model(cams, imgs, pts, d, binary=binary)
    _assert_same_model(rmod.read_model(d), cams, imgs, pts)
    full = rmod.read_points3d_full(os.path.join(d, "points3D.bin"),
                                   os.path.join(d, "points3D.txt"))
    for a, b in zip(full, pts):
        np.testing.assert_array_equal(a, b)


def test_render_cli_reads_a_jax_cfg_args_on_the_cpu(tmp_path, rng,
                                                    monkeypatch):
    """A model directory whose cfg_args.json JAX's save_cfg wrote (so
    ``data_device`` is "tpu"): the port's CLI loads it and, asked for the
    CPU, renders there the images it renders without the file."""
    from PIL import Image
    from gsplat_tpu import config as jcfg
    from gsplat_tpu_torch import config as tcfg
    monkeypatch.setattr(sys, "stdout", sys.stdout)   # the CLI swaps stdout
    src, model, _ = _write_scene(str(tmp_path), rng)
    argv = ["-s", src, "-m", model, "--device", "cpu", "--quiet",
            "--skip_test"]
    out_dir = os.path.join(model, "train", f"ours_{ITER}", "renders")
    render_cli.main(argv)
    want = [np.asarray(Image.open(os.path.join(out_dir, f)))
            for f in sorted(os.listdir(out_dir))]
    jcfg.save_cfg(model, {"model": jcfg.ModelConfig(source_path=src,
                                                    model_path=model),
                          "pipeline": jcfg.PipelineConfig(),
                          "rasterizer": jcfg.RasterizerConfig()})
    assert tcfg.load_cfg(model)["model"].data_device == "tpu"
    for f in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, f))
    render_cli.main(argv)
    got = [np.asarray(Image.open(os.path.join(out_dir, f)))
           for f in sorted(os.listdir(out_dir))]
    assert len(got) == N_CAMS
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
