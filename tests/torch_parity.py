"""Shared helpers of the port's parity tests: the same numpy-seeded inputs
go through the JAX reference and through gsplat_tpu_torch on the CPU."""
import dataclasses

import jax.numpy as jnp
import numpy as np

from gsplat_tpu.config import RasterizerConfig as JaxRasterizerConfig
from gsplat_tpu.core.camera import CameraView as JaxCameraView
from gsplat_tpu.models import gaussian_model as jgm
from gsplat_tpu_torch.config import RasterizerConfig
from gsplat_tpu_torch.core.camera import CameraView
from gsplat_tpu_torch.models import gaussian_model as tgm

PARAM_FIELDS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity",
                "active", "active_sh_degree")
CAM_FIELDS = ("world_view", "full_proj", "camera_center", "tanfovx",
              "tanfovy", "exposure_idx")

# (tile_h, tile_w, chunk, W, H): the JAX suite's small tiles, and the
# default 32×32 tiles / chunk 64 on a small image
SMALL = (8, 128, 16, 256, 24)
DEFAULT_TILES = (32, 32, 64, 96, 64)


def make_scene(rng, n=300, cap=None, sh_degree=1):
    """Random gaussians in front of a simple camera, as JAX objects (the
    recipe of tests/test_rasterize.py:make_scene)."""
    cap = cap or n
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    colors = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    g = jgm.create_from_pcd(pts, colors, sh_degree, capacity=cap)
    g = dataclasses.replace(
        g,
        rotation=g.rotation.at[:n].set(
            rng.standard_normal((n, 4)).astype(np.float32)),
        scaling=g.scaling.at[:n].add(
            rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)),
        opacity=g.opacity.at[:n].set(
            rng.uniform(-1.0, 3.0, n).astype(np.float32)),
        f_rest=g.f_rest.at[:n].set(
            0.1 * rng.standard_normal(g.f_rest.shape[1:]).astype(np.float32)),
        active_sh_degree=jnp.asarray(sh_degree, jnp.int32))
    cam = JaxCameraView.create(R=np.eye(3), T=np.zeros(3), fovx=0.9, fovy=0.7)
    return g, cam


def to_numpy(obj, fields):
    return {k: np.asarray(getattr(obj, k)) for k in fields}


def port_scene(g, cam):
    """The same JAX scene and camera as gsplat_tpu_torch objects on the CPU."""
    return (tgm.from_numpy(to_numpy(g, PARAM_FIELDS), device="cpu"),
            CameraView.from_numpy(to_numpy(cam, CAM_FIELDS), device="cpu"))


def configs(tile_h, tile_w, chunk, **kw):
    """(JAX config on its XLA oracle route, port config), same knobs."""
    base = dict(tile_h=tile_h, tile_w=tile_w, chunk=chunk,
                pairs_per_gaussian=24.0, **kw)
    return (JaxRasterizerConfig(use_pallas=False, **base),
            RasterizerConfig(**base))


def t2n(x):
    return x.detach().cpu().numpy()


STATS_FIELDS = ("xyz_gradient_accum", "denom", "max_radii2d")


def state_to_numpy(state):
    """A JAX TrainState as the numpy arrays gsplat_tpu_torch's
    ``trainer.state_from_numpy`` takes."""
    def adam(a):
        return dict(mu={k: np.asarray(v) for k, v in a.mu.items()},
                    nu={k: np.asarray(v) for k, v in a.nu.items()},
                    count=int(a.count))
    return dict(gaussians=to_numpy(state.gaussians, PARAM_FIELDS),
                adam=adam(state.adam), exposure=np.asarray(state.exposure),
                exp_adam=adam(state.exp_adam),
                stats=to_numpy(state.stats, STATS_FIELDS),
                step=int(state.step))
