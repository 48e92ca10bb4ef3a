"""Port parity of the scene-side host tools: the native image loader
(gsplat_tpu_torch/native) and the depth-scale CLI
(gsplat_tpu_torch/cli/make_depth_scale.py).

- The loader's decode equals PIL's within 1e-6 at the source size and
  PIL's BOX filter within 1.1 LSB when it downscales
  (tests/test_scene.py:283); ``load_cam`` with and without it
  (``GSPLAT_NATIVE_LOADER=0``) within a mean of 0.01 (:325);
  ``camera_list_from_infos`` decodes the set in one ``decode_batch`` call
  per target resolution (:355). ``decode_image`` / ``decode_batch`` equal
  the JAX package's loader on the same files bit for bit. A library that
  does not load is built again; a build that fails is reported once and
  the cameras decode with PIL. A test skips where the JAX package's
  skips: when its loader does not build.
- The depth-scale CLI on a synthetic scene whose monocular inverse depth is
  2 x COLMAP's + 0.1 finds a scale near 0.5 (tests/test_scene.py:225), and
  writes what tools/make_depth_scale.py writes on the same scene within
  1e-6.
"""
import json
import os
import sys
from unittest import mock

import numpy as np
import pytest

from gsplat_tpu import native as jnative
from gsplat_tpu.scene import colmap as colmap_lib
from gsplat_tpu_torch import native
from gsplat_tpu_torch.scene import cameras as cam_lib
from gsplat_tpu_torch.scene.dataset_readers import CameraInfo

from torch_parity import REPO


def _need_loader():
    if not jnative.available():
        pytest.skip("native loader unavailable (no toolchain)")
    assert native.available(), native.build_error


@pytest.fixture
def pil_only(monkeypatch):
    """The PIL path, as ``GSPLAT_NATIVE_LOADER=0`` selects it."""
    def use():
        monkeypatch.setenv("GSPLAT_NATIVE_LOADER", "0")
    return use


def _images(tmp_path, rng):
    from PIL import Image
    arr = rng.integers(0, 255, (64, 96, 3)).astype(np.uint8)
    paths = dict(png=str(tmp_path / "t.png"), jpg=str(tmp_path / "t.jpg"),
                 rgba=str(tmp_path / "a.png"))
    Image.fromarray(arr).save(paths["png"])
    Image.fromarray(arr).save(paths["jpg"], quality=92)
    Image.fromarray(rng.integers(0, 255, (64, 96, 4)).astype(np.uint8)).save(
        paths["rgba"])
    return paths


def test_native_loader_matches_pil(tmp_path, rng):
    from PIL import Image
    _need_loader()
    p = _images(tmp_path, rng)
    assert native.image_size(p["png"]) == (96, 64)
    for path in (p["png"], p["jpg"]):
        img, has_alpha = native.decode_image(path, 96, 64)
        ref = np.asarray(Image.open(path), np.float32) / 255.0
        np.testing.assert_allclose(img[:3].transpose(1, 2, 0), ref,
                                   atol=1e-6)
        assert not has_alpha
    img, has_alpha = native.decode_image(p["rgba"], 96, 64)
    assert has_alpha
    np.testing.assert_allclose(
        img.transpose(1, 2, 0),
        np.asarray(Image.open(p["rgba"]), np.float32) / 255.0, atol=1e-6)
    # the area downscale against PIL's BOX, within its 8-bit quantisation
    small, _ = native.decode_image(p["png"], 48, 32)
    ref = np.asarray(Image.open(p["png"]).resize((48, 32), Image.BOX),
                     np.float32) / 255.0
    np.testing.assert_allclose(small[:3].transpose(1, 2, 0), ref,
                               atol=1.1 / 255.0)
    batch, flags = native.decode_batch([p["png"], p["rgba"], p["jpg"]],
                                       48, 32, 3)
    assert batch.shape == (3, 4, 32, 48)
    assert list(flags) == [False, True, False]
    assert native.image_size(str(tmp_path / "missing.png")) is None
    assert native.decode_batch([p["png"], str(tmp_path / "x.png")],
                               48, 32) is None


def test_native_decode_equals_jax_loader(tmp_path, rng):
    _need_loader()
    p = _images(tmp_path, rng)
    for path in p.values():
        assert native.image_size(path) == jnative.image_size(path)
        for size in ((96, 64), (48, 32), (37, 29)):
            got, alpha = native.decode_image(path, *size)
            want, jalpha = jnative.decode_image(path, *size)
            np.testing.assert_array_equal(got, want)
            assert alpha == jalpha
    paths = list(p.values())
    got, flags = native.decode_batch(paths, 40, 30, 2)
    want, jflags = jnative.decode_batch(paths, 40, 30, 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(flags, jflags)


@pytest.fixture
def fresh_loader(tmp_path, monkeypatch):
    """The loader module as before its first use, building into tmp_path."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "build_error", None)
    return native


def test_native_loader_rebuilds_a_library_that_does_not_load(fresh_loader):
    if not jnative.available():
        pytest.skip("native loader unavailable (no toolchain)")
    path = fresh_loader.library_path()
    path.parent.mkdir(parents=True)
    path.write_bytes(b"not a shared library")   # as if built elsewhere
    assert fresh_loader.available()
    assert fresh_loader.build_error is None
    assert path.stat().st_size > 1000


def test_native_loader_build_failure_falls_back_to_pil(fresh_loader, tmp_path,
                                                      monkeypatch, capsys):
    """A failed build is reported once, and the cameras decode with PIL."""
    from PIL import Image
    monkeypatch.setattr(fresh_loader, "LIBS", ["-lno_such_library_here"])
    assert not fresh_loader.available()
    assert "no_such_library_here" in fresh_loader.build_error
    assert "build failed" in capsys.readouterr().out
    assert not fresh_loader.available()
    assert capsys.readouterr().out == ""          # printed once
    arr = np.random.default_rng(0).integers(0, 255, (32, 48, 3)).astype(
        np.uint8)
    p = str(tmp_path / "i.png")
    Image.fromarray(arr).save(p)
    cam = cam_lib.camera_list_from_infos([_info(p, 0, 48, 32)], 1.0, 1,
                                         False)[0]
    np.testing.assert_array_equal(
        cam.image, (arr.astype(np.float32) / 255.0).transpose(2, 0, 1))


def _info(path, uid, w, h):
    return CameraInfo(uid=uid, R=np.eye(3), T=np.zeros(3), FovY=0.8,
                      FovX=0.9, image_path=path, image_name=f"im{uid}",
                      width=w, height=h)


def test_load_cam_native_matches_pil(tmp_path, pil_only):
    from PIL import Image
    _need_loader()
    # a smooth image: the area filter and PIL's default bicubic agree
    # closely on natural content (noise is their worst case)
    yy, xx = np.mgrid[0:100, 0:200]
    smooth = np.stack([xx * 255 / 200, yy * 255 / 100,
                       (xx + yy) * 255 / 300], -1).astype(np.uint8)
    p = str(tmp_path / "img.png")
    Image.fromarray(smooth).save(p)
    ci = _info(p, 0, 200, 100)
    cam_native = cam_lib.load_cam(2, ci)
    pil_only()
    cam_pil = cam_lib.load_cam(2, ci)
    assert cam_native.image.shape == cam_pil.image.shape == (3, 50, 100)
    assert np.abs(cam_native.image - cam_pil.image).mean() < 0.01


def test_camera_list_uses_batch_decode(tmp_path, pil_only):
    from PIL import Image
    _need_loader()
    infos = []
    for i in range(4):
        yy, xx = np.mgrid[0:64, 0:96]
        img = np.stack([(xx * (i + 1)) % 256, yy * 2 % 256,
                        (xx + yy + 40 * i) % 256], -1).astype(np.uint8)
        p = str(tmp_path / f"im{i}.png")
        Image.fromarray(img).save(p)
        infos.append(_info(p, i, 96, 64))

    calls = []
    orig_batch = native.decode_batch

    def counting_batch(paths, w, h, n_threads=0):
        calls.append(list(paths))
        return orig_batch(paths, w, h, n_threads)

    with mock.patch.object(native, "decode_batch", counting_batch), \
            mock.patch.object(native, "decode_image",
                              side_effect=AssertionError("per image")):
        cams = cam_lib.camera_list_from_infos(infos, 1.0, 2, False)
    assert len(calls) == 1 and len(calls[0]) == 4, \
        f"expected one 4-image batch call, got {calls}"
    pil_only()
    cams_pil = cam_lib.camera_list_from_infos(infos, 1.0, 2, False)
    for a, b in zip(cams, cams_pil):
        assert a.image.shape == b.image.shape == (3, 32, 48)
        assert np.abs(a.image - b.image).mean() < 0.01


def _depth_scene(tmp_path, rng):
    """tests/test_scene.py:225's scene: an identity camera, its points'
    keypoints, and a 16-bit inverse-depth PNG of 2 x COLMAP's + 0.1, filled
    by nearest neighbour."""
    from PIL import Image
    from scipy.interpolate import griddata
    W, H = 64, 48
    fx = fy = 60.0
    n_pts = 60
    xyz = np.stack([rng.uniform(-1, 1, n_pts), rng.uniform(-0.8, 0.8, n_pts),
                    rng.uniform(2.0, 8.0, n_pts)], axis=1)
    x_pix = fx * xyz[:, 0] / xyz[:, 2] + W / 2
    y_pix = fy * xyz[:, 1] / xyz[:, 2] + H / 2
    keep = (x_pix >= 0) & (x_pix < W) & (y_pix >= 0) & (y_pix < H)
    xyz = xyz[keep]
    xys = np.stack([x_pix[keep], y_pix[keep]], axis=1)
    n = len(xyz)
    cams = {1: colmap_lib.ColmapCamera(1, "PINHOLE", W, H,
                                       np.array([fx, fy, W / 2, H / 2]))}
    imgs = {1: colmap_lib.ColmapImage(
        1, np.array([1.0, 0, 0, 0]), np.zeros(3), 1, "v.png",
        xys=xys, point3D_ids=np.arange(n, dtype=np.int64))}
    pts = (np.arange(n, dtype=np.int64), xyz,
           np.zeros((n, 3), np.uint8), np.zeros(n))
    base = tmp_path / "scene"
    colmap_lib.write_model(cams, imgs, pts, str(base / "sparse" / "0"),
                           binary=True)
    grid_y, grid_x = np.mgrid[0:H, 0:W]
    dense = griddata(xys, 2.0 / xyz[:, 2] + 0.1, (grid_x, grid_y),
                     method="nearest")
    png16 = np.clip(dense * (2 ** 16), 0, 2 ** 16 - 1).astype(np.uint16)
    depths = tmp_path / "depths"
    depths.mkdir()
    Image.fromarray(png16).save(depths / "v.png")
    return str(base), str(depths)


def test_make_depth_scale_matches_jax_tool(tmp_path, rng):
    from gsplat_tpu_torch.cli import make_depth_scale
    sys.path.insert(0, REPO)
    from tools import make_depth_scale as jtool

    base, depths = _depth_scene(tmp_path, rng)
    out = os.path.join(base, "sparse", "0", "depth_params.json")
    jtool.main(["--base_dir", base, "--depths_dir", depths])
    with open(out) as f:
        want = json.load(f)
    os.remove(out)
    make_depth_scale.main(["--base_dir", base, "--depths_dir", depths])
    with open(out) as f:
        got = json.load(f)
    assert set(got) == set(want) == {"v"}
    # nearest fill and bilinear sampling add noise; the scale still lands
    # near 0.5 (mono = 2 x colmap + 0.1)
    assert abs(got["v"]["scale"] - 0.5) < 0.15
    for k in ("scale", "offset"):
        np.testing.assert_allclose(got["v"][k], want["v"][k], rtol=0,
                                   atol=1e-6)
