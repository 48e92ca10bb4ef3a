"""Port parity: core transforms, SH, CameraView and the schedules against
the JAX package, rtol 1e-5 / atol 1e-6; the covariance unpacked by
``cov6_to_mat`` against scipy's rotations and as a symmetric PSD matrix
(tests/test_core.py:75-105)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsplat_tpu.core import sh as jsh
from gsplat_tpu.core import transforms as jtf
from gsplat_tpu.core.camera import CameraView as JaxCameraView
from gsplat_tpu_torch.core import sh as tsh
from gsplat_tpu_torch.core import transforms as ttf
from gsplat_tpu_torch.core.camera import CameraView

from torch_parity import CAM_FIELDS, t2n, to_numpy

TOL = dict(rtol=1e-5, atol=1e-6)


def test_transforms_match_jax(rng):
    q = rng.standard_normal((64, 4)).astype(np.float32)
    s = rng.uniform(0.01, 2.0, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        t2n(ttf.quat_to_rotmat(torch.tensor(q))),
        np.asarray(jtf.quat_to_rotmat(jnp.asarray(q))), **TOL)
    for mod in (1.0, 0.7):
        np.testing.assert_allclose(
            t2n(ttf.covariance_from_scaling_rotation(
                torch.tensor(s), mod, torch.tensor(q))),
            np.asarray(jtf.covariance_from_scaling_rotation(
                jnp.asarray(s), mod, jnp.asarray(q))), **TOL)
    x = rng.uniform(0.01, 0.99, 32).astype(np.float32)
    np.testing.assert_allclose(t2n(ttf.inverse_sigmoid(torch.tensor(x))),
                               np.asarray(jtf.inverse_sigmoid(jnp.asarray(x))),
                               **TOL)
    R = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    T = rng.standard_normal(3)
    trans = rng.standard_normal(3)
    np.testing.assert_array_equal(ttf.world_to_view(R, T, trans, 1.3),
                                  jtf.world_to_view(R, T, trans, 1.3))
    np.testing.assert_array_equal(ttf.projection_matrix(0.01, 100.0, 0.9, 0.7),
                                  jtf.projection_matrix(0.01, 100.0, 0.9, 0.7))
    assert ttf.fov2focal(0.9, 640) == jtf.fov2focal(0.9, 640)
    assert ttf.focal2fov(500.0, 640) == jtf.focal2fov(500.0, 640)


def test_core_helpers_match_jax(rng):
    from gsplat_tpu.core import schedules as jsched
    from gsplat_tpu_torch.core import schedules as tsched
    q = rng.standard_normal((40, 4)).astype(np.float32)
    s = rng.uniform(0.01, 2.0, (40, 3)).astype(np.float32)
    np.testing.assert_allclose(
        t2n(ttf.build_scaling_rotation(torch.tensor(s), torch.tensor(q))),
        np.asarray(jtf.build_scaling_rotation(jnp.asarray(s),
                                              jnp.asarray(q))), **TOL)
    c6 = rng.standard_normal((7, 5, 6)).astype(np.float32)
    np.testing.assert_array_equal(t2n(ttf.cov6_to_mat(torch.tensor(c6))),
                                  np.asarray(jtf.cov6_to_mat(
                                      jnp.asarray(c6))))
    for kw in (dict(lr_init=1e-2, lr_final=1e-4, max_steps=1000),
               dict(lr_init=1e-2, lr_final=1e-4, lr_delay_steps=100,
                    lr_delay_mult=0.01, max_steps=1000),
               dict(lr_init=0.0, lr_final=0.0, max_steps=10)):
        fn, jfn = tsched.make_expon_lr_fn(**kw), jsched.make_expon_lr_fn(**kw)
        for step in (-1, 0, 1, 50, 100, 500, 999, 1000, 2000):
            np.testing.assert_allclose(fn(step), float(jfn(step)), **TOL)


def _cov_mats(rng, n):
    s = np.exp(rng.standard_normal((n, 3)).astype(np.float32) * 0.3)
    q = rng.standard_normal((n, 4)).astype(np.float32)   # (w,x,y,z)
    C = t2n(ttf.cov6_to_mat(ttf.covariance_from_scaling_rotation(
        torch.tensor(s), 1.0, torch.tensor(q))))
    return s, q, C


def test_covariance_matches_scipy_oracle(rng):
    from scipy.spatial.transform import Rotation
    s, q, C = _cov_mats(rng, 24)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    R = Rotation.from_quat(qn[:, [1, 2, 3, 0]]).as_matrix()  # xyzw order
    want = np.einsum("nij,nj,nkj->nik", R, s.astype(np.float64) ** 2, R)
    np.testing.assert_allclose(C, want, rtol=1e-4, atol=1e-6)


def test_covariance_psd_and_symmetric(rng):
    s, _, C = _cov_mats(rng, 32)
    np.testing.assert_allclose(C, np.swapaxes(C, -1, -2), atol=1e-6)
    assert (np.linalg.eigvalsh(C) > -1e-5).all()
    # det(Σ) == (∏ s_i)^2: the rotation keeps the determinant
    np.testing.assert_allclose(np.linalg.det(C), (s.prod(-1)) ** 2,
                               rtol=2e-2)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_sh_matches_jax(rng, deg):
    d = rng.standard_normal((50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    K = (deg + 1) ** 2
    coeffs = rng.standard_normal((50, 3, K)).astype(np.float32)
    np.testing.assert_allclose(t2n(tsh.sh_basis(deg, torch.tensor(d))),
                               np.asarray(jsh.sh_basis(deg, jnp.asarray(d))),
                               **TOL)
    np.testing.assert_allclose(
        t2n(tsh.eval_sh(deg, torch.tensor(coeffs), torch.tensor(d))),
        np.asarray(jsh.eval_sh(deg, jnp.asarray(coeffs), jnp.asarray(d))),
        **TOL)
    rgb = rng.uniform(0, 1, (10, 3)).astype(np.float32)
    np.testing.assert_allclose(t2n(tsh.rgb2sh(torch.tensor(rgb))),
                               np.asarray(jsh.rgb2sh(jnp.asarray(rgb))), **TOL)
    np.testing.assert_allclose(t2n(tsh.sh2rgb(torch.tensor(rgb))),
                               np.asarray(jsh.sh2rgb(jnp.asarray(rgb))), **TOL)


def test_camera_view_create_matches_jax(rng):
    R = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    T = rng.standard_normal(3)
    kw = dict(znear=0.05, zfar=50.0, trans=np.array([0.1, -0.2, 0.3]),
              scale=1.5, exposure_idx=3)
    cj = JaxCameraView.create(R, T, 0.8, 0.6, **kw)
    ct = CameraView.create(R, T, 0.8, 0.6, device="cpu", **kw)
    want = to_numpy(cj, CAM_FIELDS)
    for k in CAM_FIELDS:
        got = getattr(ct, k)
        got = got if isinstance(got, int) else t2n(got)
        np.testing.assert_allclose(got, want[k], err_msg=k, **TOL)


def test_cfg_args_json_loads_in_both_packages(tmp_path):
    """``cfg_args.json`` across the packages: one that JAX's save_cfg wrote
    loads in the port (groups and fields it does not keep are skipped), and
    one that the port's save_cfg wrote, in the same format, loads in JAX.
    ``data_device`` keeps each package's own default ("tpu" in JAX, "cuda"
    in the port) and no code of either reads it, so a model moves between
    them unchanged."""
    import dataclasses
    import json
    from gsplat_tpu import config as jcfg
    from gsplat_tpu_torch import config as tcfg

    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jcfg.save_cfg(str(jdir), {
        "model": jcfg.ModelConfig(sh_degree=2, model_path=str(jdir)),
        "pipeline": jcfg.PipelineConfig(antialiasing=True),
        "optimization": jcfg.OptimizationConfig(iterations=7),
        "rasterizer": jcfg.RasterizerConfig(tile_h=16, chunk=32)})
    got = tcfg.load_cfg(str(jdir))
    assert got["model"].data_device == "tpu" and got["model"].sh_degree == 2
    assert got["pipeline"].antialiasing and got["optimization"].iterations == 7
    assert (got["rasterizer"].tile_h, got["rasterizer"].chunk) == (16, 32)

    cfgs = {"model": tcfg.ModelConfig(sh_degree=1, model_path=str(tdir)),
            "pipeline": tcfg.PipelineConfig(),
            "optimization": tcfg.OptimizationConfig(lambda_dssim=0.3),
            "rasterizer": tcfg.RasterizerConfig(tile_w=64)}
    assert cfgs["model"].data_device == "cuda"
    tcfg.save_cfg(str(tdir), cfgs)
    assert (tdir / "cfg_args.json").read_text() == json.dumps(
        {k: dataclasses.asdict(v) for k, v in cfgs.items()}, indent=2)
    back = jcfg.load_cfg(str(tdir))
    assert back["model"].data_device == "cuda" and back["model"].sh_degree == 1
    assert back["optimization"].lambda_dssim == 0.3
    assert back["rasterizer"].tile_w == 64
    for k, v in cfgs.items():
        mine = dataclasses.asdict(v)
        theirs = dataclasses.asdict(back[k])
        assert {f: theirs[f] for f in mine} == mine, k
