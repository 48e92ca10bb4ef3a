"""The port's CUDA kernel on the card: held to its plain PyTorch version on
the same inputs (accum and t_final within rtol 2e-4 / atol 2e-5, n_contrib
equal on ≥ 99.9% of pixels), and the render on the card held to the same
render on the CPU. These tests need an NVIDIA GPU and skip elsewhere. The
file imports no JAX (the parity tests against JAX run on the CPU), so it
also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.config import RasterizerConfig
from gsplat_tpu_torch.core.camera import CameraView
from gsplat_tpu_torch.models import gaussian_model as gm
from gsplat_tpu_torch.ops import rasterize
from gsplat_tpu_torch.ops.composite_ref import composite_tiles_plain
from gsplat_tpu_torch.ops.kernels import composite as tcomp

pytestmark = pytest.mark.cuda

IMG_TOL = dict(rtol=2e-4, atol=2e-5)
# (tile_h, tile_w, chunk, W, H)
SHAPES = [(8, 128, 16, 256, 24), (32, 32, 64, 96, 64)]
IDS = ["8x128", "32x32"]


@pytest.fixture
def cuda_device():
    """A CUDA device, or skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel test)")
    return torch.device("cuda")


def _scene(device, n=400, seed=0):
    """Random gaussians in front of the camera, made with numpy."""
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((n, 3)).astype(np.float32)
    xyz[:, 2] += 5.0
    arrays = dict(
        xyz=xyz,
        f_dc=rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32),
        f_rest=(0.1 * rng.standard_normal((n, 3, 3))).astype(np.float32),
        scaling=rng.uniform(-2.5, -1.5, (n, 3)).astype(np.float32),
        rotation=rng.standard_normal((n, 4)).astype(np.float32),
        opacity=rng.uniform(-1.0, 3.0, n).astype(np.float32))
    return (gm.from_numpy(arrays, device=device),
            CameraView.create(np.eye(3), np.zeros(3), 0.9, 0.7,
                              device=device))


def _cfg(th, tw, chunk):
    return RasterizerConfig(tile_h=th, tile_w=tw, chunk=chunk,
                            pairs_per_gaussian=24.0)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_kernel_matches_plain_on_card(shape, cuda_device):
    th, tw, chunk, W, H = shape
    g, cam = _scene(cuda_device)
    cfg = _cfg(th, tw, chunk)
    with torch.no_grad():
        e = rasterize.build_entries(g, cam, W, H, cfg)
    assert int(e.binning.overflow) == 0
    geo = dict(n_tiles_x=e.n_tiles_x, n_tiles_y=e.n_tiles_y, tile_h=th,
               tile_w=tw, chunk=chunk, alpha_min=cfg.alpha_min,
               alpha_max=cfg.alpha_max, t_eps=cfg.transmittance_eps)
    args = (e.entries, e.binning.tile_start, e.binning.tile_count)
    plain = composite_tiles_plain(*args, **geo)
    before = tcomp.composite_fwd_cuda.launches
    kern = tcomp.composite_fwd_cuda(*args, **geo)
    torch.cuda.synchronize()
    assert tcomp.composite_fwd_cuda.launches == before + 1
    for k in ("accum", "t_final"):
        torch.testing.assert_close(getattr(kern, k), getattr(plain, k),
                                   **IMG_TOL)
    assert float((kern.n_contrib == plain.n_contrib).float().mean()) >= 0.999
    assert float((plain.n_contrib > 0).float().mean()) > 0.2


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_render_on_card_matches_cpu(shape, cuda_device):
    th, tw, chunk, W, H = shape
    cfg = _cfg(th, tw, chunk)
    outs = []
    for dev in ("cpu", cuda_device):
        g, cam = _scene(dev)
        with torch.no_grad():
            outs.append(rasterize.render(g, cam, W, H,
                                         torch.full((3,), 0.3, device=dev),
                                         cfg, clamp=False))
    cpu, gpu = outs
    torch.testing.assert_close(gpu.image.cpu(), cpu.image, **IMG_TOL)
    torch.testing.assert_close(gpu.invdepth.cpu(), cpu.invdepth, **IMG_TOL)


def test_kernel_refuses_grad(cuda_device):
    """Forward-only on the card: no silent fallback to the plain version."""
    g, cam = _scene(cuda_device)
    g = dataclasses.replace(g, xyz=g.xyz.clone().requires_grad_())
    with pytest.raises(RuntimeError, match="forward-only"):
        rasterize.render(g, cam, 96, 64, torch.zeros(3, device=cuda_device),
                         _cfg(32, 32, 64))
