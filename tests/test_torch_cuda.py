"""The port's CUDA kernels on the card, each held to its plain PyTorch
version on the same inputs:
- the compositor forward: accum and t_final within rtol 2e-4 / atol 2e-5,
  n_contrib equal on ≥ 99.9% of pixels;
- the compositor backward against autograd through the plain compositor,
  and the SSIM backward against autograd through the plain SSIM: rtol 5e-3
  / atol 1e-6 and rtol 2e-4 / atol 1e-6 (the JAX suite's gates);
- the SSIM map: rtol 1e-5 / atol 1e-6;
- the slab transmittance: rtol 1e-5 / atol 1e-6 against its plain version
  and against the compositor kernel's cut-free t_final;
- the compositor with ``t_init`` and ``tile_id_base`` and its backward from
  such a forward, at the compositor's gates; the depth-slab and tile-band
  renders on the card against the same on the CPU;
- the blocked prefix sum: against a float64 cumsum no more than twice as far
  as ``torch.cumsum`` in f32 is, exact on integers, the same bits on a
  second launch; the sharded renders on the card against the same on the
  CPU at the gradient gate.
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
from gsplat_tpu_torch.ops.composite_ref import (composite_tiles_plain,
                                                slab_transmittance_plain)
from gsplat_tpu_torch.ops.kernels import composite as tcomp
from gsplat_tpu_torch.ops.kernels import scan as kscan
from gsplat_tpu_torch.ops.kernels import ssim as kssim
from gsplat_tpu_torch.parallel import prim_shard, sharded, tile_shard
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


def _frame_tables(shape, device):
    th, tw, chunk, W, H = shape
    g, cam = _scene(device)
    cfg = _cfg(th, tw, chunk)
    with torch.no_grad():
        e = rasterize.build_entries(g, cam, W, H, cfg)
    assert int(e.binning.overflow) == 0
    geo = dict(n_tiles_x=e.n_tiles_x, n_tiles_y=e.n_tiles_y, tile_h=th,
               tile_w=tw, alpha_min=cfg.alpha_min, alpha_max=cfg.alpha_max)
    fwd_kw = dict(chunk=chunk, t_eps=cfg.transmittance_eps)
    return (e.entries, e.binning.tile_start, e.binning.tile_count), geo, \
        fwd_kw


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_slab_transmittance_kernel_matches_plain(shape, cuda_device):
    args, geo, fwd_kw = _frame_tables(shape, cuda_device)
    kw = dict(geo, chunk=fwd_kw["chunk"])
    before = tcomp.slab_transmittance_cuda.launches
    got = tcomp.slab_transmittance_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert tcomp.slab_transmittance_cuda.launches == before + 1
    torch.testing.assert_close(got, slab_transmittance_plain(*args, **kw),
                               rtol=1e-5, atol=1e-6)
    # the same products in the same order as the compositor's, cut-free
    cutfree = tcomp.composite_fwd_cuda(*args, **kw, t_eps=0.0).t_final
    torch.testing.assert_close(got, cutfree, rtol=0, atol=0)
    assert float(got.min()) < 1e-3 and float(got.max()) <= 1.0
    # an empty tile gives 1; the dispatch launches the kernel for CUDA
    tc = args[2].clone()
    tc[0] = 0
    out = tcomp.slab_transmittance(args[0], args[1], tc, **kw)
    assert tcomp.slab_transmittance_cuda.launches == before + 2
    assert bool((out[0] == 1.0).all())


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_kernels_with_t_init_and_tile_id_base_match_plain(shape,
                                                          cuda_device):
    """The slab and band forms: a forward whose cut a random t_init moved
    earlier, on the lower tile rows with their tile_id_base, and the
    backward from that forward's outputs under non-zero cotangents of accum
    and of t_final."""
    (entries, ts, tc), geo, fwd_kw = _frame_tables(shape, cuda_device)
    base = geo["n_tiles_x"] * (geo["n_tiles_y"] // 2)
    ts, tc = ts[base:].contiguous(), tc[base:].contiguous()
    geo = dict(geo, n_tiles_y=geo["n_tiles_y"] - geo["n_tiles_y"] // 2,
               tile_id_base=base)
    T, P = ts.shape[0], geo["tile_h"] * geo["tile_w"]
    rng = np.random.default_rng(4)
    t_init, ga, gt = (torch.tensor(v, dtype=torch.float32,
                                   device=cuda_device)
                      for v in (rng.uniform(1e-5, 0.3, (T, P)),
                                rng.standard_normal((T, 4, P)),
                                rng.standard_normal((T, P))))
    x = entries.detach().requires_grad_()
    plain = composite_tiles_plain(x, ts, tc, **geo, **fwd_kw, t_init=t_init)
    ((plain.accum * ga).sum() + (plain.t_final * gt).sum()).backward()
    kern = tcomp.composite_fwd_cuda(entries, ts, tc, **geo, **fwd_kw,
                                    t_init=t_init)
    uncut = tcomp.composite_fwd_cuda(entries, ts, tc, **geo, **fwd_kw)
    for k in ("accum", "t_final"):
        torch.testing.assert_close(getattr(kern, k), getattr(plain, k),
                                   **IMG_TOL)
    assert float((kern.n_contrib == plain.n_contrib).float().mean()) >= 0.999
    assert bool((kern.n_contrib <= uncut.n_contrib).all())
    assert float((kern.n_contrib < uncut.n_contrib).float().mean()) > 0.01
    d = tcomp.composite_bwd_cuda(entries, ts, tc, kern.t_final,
                                 kern.n_contrib, ga, gt, **geo)
    torch.cuda.synchronize()
    torch.testing.assert_close(d[:, :10], x.grad[:, :10], **GRAD_TOL)
    assert float(d[:, :10].abs().max()) > 0.0
    # t_init of ones is the kernel without one, bit for bit
    ones = tcomp.composite_fwd_cuda(entries, ts, tc, **geo, **fwd_kw,
                                    t_init=torch.ones_like(t_init))
    for k in ("accum", "t_final", "n_contrib"):
        assert torch.equal(getattr(ones, k), getattr(uncut, k)), k


def test_slab_and_band_renders_on_card_match_cpu(cuda_device):
    """render_prim_sharded and render_tile_sharded on the card launch their
    kernels once per slab or band, forward and backward, and give the CPU
    route's images and gradients."""
    W, H = 96, 128
    cfg = _cfg(32, 32, 64)
    renders = {
        "slab": lambda p, c, bg: prim_shard.render_prim_sharded(
            p, c, W, H, bg, cfg, n_slabs=4, m_cap=400 * 12)[:2],
        "band": lambda p, c, bg: tile_shard.render_tile_sharded(
            p, c, W, H, bg, cfg, n_bands=2)[:2]}
    want_launches = {"slab": (4, 4, 4), "band": (2, 2, 0)}
    for name, render in renders.items():
        outs = []
        for dev in ("cpu", cuda_device):
            g, cam = _scene(dev)
            params = {k: getattr(g, k).clone().requires_grad_()
                      for k in gm.TRAINABLE_FIELDS}
            before = (tcomp.composite_fwd_cuda.launches,
                      tcomp.composite_bwd_cuda.launches,
                      tcomp.slab_transmittance_cuda.launches)
            img, inv = render(gm.with_trainables(g, params), cam,
                              torch.full((3,), 0.25, device=dev))
            (img.mean() + 0.1 * inv.mean()).backward()
            after = (tcomp.composite_fwd_cuda.launches,
                     tcomp.composite_bwd_cuda.launches,
                     tcomp.slab_transmittance_cuda.launches)
            moved = tuple(a - b for a, b in zip(after, before))
            assert moved == (want_launches[name] if dev != "cpu"
                             else (0, 0, 0)), (name, moved)
            outs.append((img.detach().cpu(), inv.detach().cpu(),
                         {k: v.grad.cpu() for k, v in params.items()}))
        (img_c, inv_c, g_c), (img_g, inv_g, g_g) = outs
        torch.testing.assert_close(img_g, img_c, **IMG_TOL)
        torch.testing.assert_close(inv_g, inv_c, **IMG_TOL)
        for k in gm.TRAINABLE_FIELDS:
            torch.testing.assert_close(g_g[k], g_c[k], **GRAD_TOL)
        assert float(g_g["xyz"].abs().max()) > 0


@pytest.mark.parametrize("M,L", [(512, 64), (3000, 1000), (16384, 4096)])
def test_scan_kernel_matches_plain(M, L, cuda_device):
    """L = 1000 ends in a ragged tile of the kernel's 256-row walk."""
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((M, 16)).astype(np.float32),
                     device=cuda_device)
    before = kscan.blocked_cumsum_16_cuda.launches
    intra, tot = kscan.blocked_cumsum_16(x, L)       # CUDA: the kernel
    torch.cuda.synchronize()
    assert kscan.blocked_cumsum_16_cuda.launches == before + 1
    plain, plain_tot = kscan.blocked_cumsum_16_plain(x, L)
    ref = torch.cumsum(x.double().reshape(M // L, L, 16), dim=1).reshape(M,
                                                                         16)
    err = float((intra.double() - ref).abs().max())
    plain_err = float((plain.double() - ref).abs().max())
    assert err <= 2 * plain_err + 1e-6, (err, plain_err)
    assert torch.equal(tot, intra[L - 1::L])
    # sums of 4096 N(0,1) rows reach about 200: torch.cumsum itself is
    # some 5e-4 from float64 there
    torch.testing.assert_close(tot, plain_tot, rtol=1e-5, atol=1e-3)
    again, tot2 = kscan.blocked_cumsum_16_cuda(x, L)
    assert torch.equal(again, intra) and torch.equal(tot2, tot)
    # integers: every partial sum below 2^24, so any order is exact
    xi = torch.tensor(rng.integers(0, 2048, (M, 16)).astype(np.float32),
                      device=cuda_device)
    ki, kt = kscan.blocked_cumsum_16_cuda(xi, L)
    pi, pt = kscan.blocked_cumsum_16_plain(xi, L)
    assert torch.equal(ki, pi) and torch.equal(kt, pt)


def test_sharded_renders_on_card_match_cpu(cuda_device):
    """make_sharded_render on the card launches the compositor once per
    shard forward and backward, the scan once per shard's backward for the
    ring and slab transients and never for the replicated one, and gives
    the CPU route's images and gradients."""
    W, H = 96, 256
    cfg = _cfg(32, 32, 64)
    kernels = (tcomp.composite_fwd_cuda, tcomp.composite_bwd_cuda,
               kscan.blocked_cumsum_16_cuda)
    want_launches = {"replicated": (4, 4, 0), "ring": (4, 4, 4),
                     "slab": (4, 4, 4)}
    for transient, want in want_launches.items():
        fn = sharded.make_sharded_render(4, image_width=W, image_height=H,
                                         cfg=cfg, transient=transient)
        outs = []
        for dev in ("cpu", cuda_device):
            g, cam = _scene(dev)
            params = {k: getattr(g, k).clone().requires_grad_()
                      for k in gm.TRAINABLE_FIELDS}
            before = [k.launches for k in kernels]
            out = fn(gm.with_trainables(g, params), cam,
                     torch.full((3,), 0.25, device=dev))
            assert int(out.overflow) == 0
            (out.image.mean() + 0.1 * out.invdepth.mean()).backward()
            moved = tuple(k.launches - b for k, b in zip(kernels, before))
            assert moved == (want if dev != "cpu" else (0, 0, 0)), \
                (transient, moved)
            outs.append((out.image.detach().cpu(), out.invdepth.detach().cpu(),
                         {k: v.grad.cpu() for k, v in params.items()}))
        (img_c, inv_c, g_c), (img_g, inv_g, g_g) = outs
        torch.testing.assert_close(img_g, img_c, **IMG_TOL)
        torch.testing.assert_close(inv_g, inv_c, **IMG_TOL)
        for k in gm.TRAINABLE_FIELDS:
            torch.testing.assert_close(g_g[k], g_c[k], **GRAD_TOL)
        assert float(g_g["xyz"].abs().max()) > 0


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
