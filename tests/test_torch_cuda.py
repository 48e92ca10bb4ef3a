"""The port's CUDA kernels on the card, each held to its plain PyTorch
version on the same inputs:
- the compositor forward: accum and t_final within rtol 2e-4 / atol 2e-5,
  n_contrib equal on ≥ 99.9% of pixels;
- the compositor backward against autograd through the plain compositor,
  and the SSIM backward against autograd through the plain SSIM: rtol 5e-3
  / atol 1e-6 and rtol 2e-4 / atol 1e-6 (the JAX suite's gates);
- the SSIM map: rtol 1e-5 / atol 1e-6.
The render and one training step on the card are held to the same on the
CPU; there the entry gather's gradient adds with atomics in an order that
varies from run to run, which the gradient gate covers. These tests need
an NVIDIA GPU and skip elsewhere. The file imports
no JAX (the parity tests against JAX run on the CPU), so it also runs
where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
import numpy as np
import pytest
import torch

from gsplat_tpu_torch.config import OptimizationConfig, RasterizerConfig
from gsplat_tpu_torch.core.camera import CameraView
from gsplat_tpu_torch.models import gaussian_model as gm
from gsplat_tpu_torch.ops import rasterize
from gsplat_tpu_torch.ops import ssim as tssim
from gsplat_tpu_torch.ops.composite_ref import composite_tiles_plain
from gsplat_tpu_torch.ops.kernels import composite as tcomp
from gsplat_tpu_torch.ops.kernels import ssim as kssim
from gsplat_tpu_torch.train import trainer

pytestmark = pytest.mark.cuda

IMG_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-3, atol=1e-6)
SSIM_GRAD_TOL = dict(rtol=2e-4, atol=1e-6)
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


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_backward_kernel_matches_autograd_through_plain(shape, cuda_device):
    th, tw, chunk, W, H = shape
    g, cam = _scene(cuda_device)
    cfg = _cfg(th, tw, chunk)
    with torch.no_grad():
        e = rasterize.build_entries(g, cam, W, H, cfg)
    geo = dict(n_tiles_x=e.n_tiles_x, n_tiles_y=e.n_tiles_y, tile_h=th,
               tile_w=tw, alpha_min=cfg.alpha_min, alpha_max=cfg.alpha_max)
    tabs = (e.binning.tile_start, e.binning.tile_count)
    T, P = e.n_tiles_x * e.n_tiles_y, th * tw
    rng = np.random.default_rng(1)
    ga = torch.tensor(rng.standard_normal((T, 4, P)), dtype=torch.float32,
                      device=cuda_device)
    gt = torch.tensor(rng.standard_normal((T, P)), dtype=torch.float32,
                      device=cuda_device)
    entries = e.entries.detach().requires_grad_()
    plain = composite_tiles_plain(entries, *tabs, chunk=chunk,
                                  t_eps=cfg.transmittance_eps, **geo)
    ((plain.accum * ga).sum() + (plain.t_final * gt).sum()).backward()
    fwd = tcomp.composite_fwd_cuda(e.entries, *tabs, chunk=chunk,
                                   t_eps=cfg.transmittance_eps, **geo)
    before = tcomp.composite_bwd_cuda.launches
    d = tcomp.composite_bwd_cuda(e.entries, *tabs, fwd.t_final,
                                 fwd.n_contrib, ga, gt, **geo)
    torch.cuda.synchronize()
    assert tcomp.composite_bwd_cuda.launches == before + 1
    torch.testing.assert_close(d[:, :10], entries.grad[:, :10], **GRAD_TOL)
    assert float(d[:, 10:].abs().max()) == 0.0
    assert float(d[:, :10].abs().max()) > 0.0
    # a None cotangent is zeros
    d_acc = tcomp.composite_bwd_cuda(e.entries, *tabs, fwd.t_final,
                                     fwd.n_contrib, ga, None, **geo)
    d_zero = tcomp.composite_bwd_cuda(e.entries, *tabs, fwd.t_final,
                                      fwd.n_contrib, ga, torch.zeros_like(gt),
                                      **geo)
    torch.testing.assert_close(d_acc, d_zero, rtol=0, atol=0)


def test_render_on_card_backpropagates_through_kernel(cuda_device):
    """The render on the card is differentiable through the backward kernel
    (its launch count moves), with the CPU route's gradients."""
    cfg = _cfg(32, 32, 64)
    grads = []
    for dev in ("cpu", cuda_device):
        g, cam = _scene(dev)
        params = {k: getattr(g, k).clone().requires_grad_()
                  for k in gm.TRAINABLE_FIELDS}
        before = tcomp.composite_bwd_cuda.launches
        out = rasterize.render(gm.with_trainables(g, params), cam, 96, 64,
                               torch.full((3,), 0.25, device=dev), cfg,
                               clamp=False)
        (out.image.mean() + 0.1 * out.invdepth.mean()).backward()
        assert tcomp.composite_bwd_cuda.launches == before + (dev != "cpu")
        grads.append({k: v.grad.cpu() for k, v in params.items()})
    for k in gm.TRAINABLE_FIELDS:
        torch.testing.assert_close(grads[1][k], grads[0][k], **GRAD_TOL)
    assert float(grads[1]["xyz"].abs().max()) > 0


def _images(device, shape=(3, 100, 130), seed=2):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    a[:, 10:40, 20:60] = 0.0               # constant: the variance clamp
    w = rng.uniform(0, 1, shape).astype(np.float32)
    return [torch.tensor(x, device=device) for x in (a, b, w)]


def test_ssim_kernels_match_plain(cuda_device):
    a, b, w = _images(cuda_device)
    before = (kssim.ssim_fwd_cuda.launches, kssim.ssim_bwd_cuda.launches)
    torch.testing.assert_close(kssim.ssim_fwd_cuda(a, b), tssim.ssim_map(a, b),
                               rtol=1e-5, atol=1e-6)
    # the mean's cotangent, and a non-uniform one at 1e-2 of unit size:
    # d img1 sums terms that cancel, whose float32 rounding is ~1e-7 of
    # their size in autograd as in the kernel, and at unit size that alone
    # exceeds the gate's atol (float32 autograd is as far from float64)
    for cot in (torch.full_like(a, 1.0 / a.numel()), 1e-2 * w):
        x = a.clone().requires_grad_()
        (tssim.ssim_map(x, b) * cot).sum().backward()
        torch.testing.assert_close(kssim.ssim_bwd_cuda(a, b, cot), x.grad,
                                   **SSIM_GRAD_TOL)
    torch.cuda.synchronize()
    assert (kssim.ssim_fwd_cuda.launches, kssim.ssim_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 4)
    # through autograd: fast_ssim on the card runs both kernels
    x = a.clone().requires_grad_()
    v = tssim.fast_ssim(x, b)
    v.backward()
    y = a.clone().requires_grad_()
    tssim.ssim(y, b).backward()
    torch.testing.assert_close(v.detach(), tssim.ssim(a, b), rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(x.grad, y.grad, **SSIM_GRAD_TOL)


def test_train_step_on_card_matches_cpu(cuda_device):
    """One train_step from the same state on the card and on the CPU: the
    loss, Adam's first moments (0.1 × the gradient) within the gradient
    gate, and the parameters (±lr, so 2·lr where a gradient is within the
    gate's atol of 0)."""
    W, H = 96, 64
    rcfg = _cfg(32, 32, 64)
    opt = OptimizationConfig(iterations=100, position_lr_max_steps=100)
    rng = np.random.default_rng(3)
    gt = rng.uniform(0.2, 0.8, (3, H, W)).astype(np.float32)
    out = []
    for dev in ("cpu", cuda_device):
        g, cam = _scene(dev)
        state = trainer.init_state(g, 1)
        ones = torch.ones((1, H, W), device=dev)
        zeros = torch.zeros((1, H, W), device=dev)
        out.append(trainer.train_step(
            state, cam, torch.tensor(gt, device=dev), ones, zeros, zeros,
            torch.zeros(3, device=dev), image_width=W, image_height=H,
            opt=opt, rcfg=rcfg, spatial_lr_scale=1.0, antialiasing=False,
            use_sparse_adam=False, train_test_exp=False, use_depth=False))
    (cpu, cpu_aux), (gpu, gpu_aux) = out
    torch.testing.assert_close(gpu_aux.loss.cpu(), cpu_aux.loss, rtol=1e-5,
                               atol=0)
    lrs = trainer._lr_dict(opt, 1, 1.0)
    for k in gm.TRAINABLE_FIELDS:
        g_cpu = cpu.adam.mu[k] / 0.1
        torch.testing.assert_close(gpu.adam.mu[k].cpu(), cpu.adam.mu[k],
                                   rtol=5e-3, atol=1e-7)
        flip = torch.where(g_cpu.abs() < GRAD_TOL["atol"], 2 * lrs[k], 0.0)
        p_cpu = getattr(cpu.gaussians, k)
        err = (getattr(gpu.gaussians, k).cpu() - p_cpu).abs()
        assert bool((err <= 1e-6 * p_cpu.abs() + 1e-7 + flip).all()), k
