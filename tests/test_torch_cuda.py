"""The port's CUDA kernels on the card, each held to its plain PyTorch
version on the same inputs:
- the compositor forward: accum and t_final within rtol 2e-4 / atol 2e-5,
  n_contrib equal on ≥ 99.9% of pixels;
- the compositor backward against autograd through the plain compositor,
  and the SSIM backward against autograd through the plain SSIM: rtol 5e-3
  / atol 1e-6 and rtol 2e-4 / atol 1e-6 (the JAX suite's gates);
- the SSIM map: rtol 1e-5 / atol 1e-6, the same bits with and without the
  partial maps its launch can write, which are held to
  ``ssim_partials_plain`` at that gate; the backward (one launch from the
  partial maps) also against ``ssim_bwd_plain``, on ragged tiles too;
  ``ssim`` of a batch on the card through the kernels against ``ssim`` on
  the CPU; LPIPS on the card against the CPU's (rtol 1e-4);
- the slab transmittance: rtol 1e-5 / atol 1e-6 against its plain version,
  and the compositor kernel's cut-free t_final bit for bit, on a rendered
  frame and on the rows that try the cull rectangle (both kernels cull);
- the compositor with ``t_init`` and ``tile_id_base`` and its backward from
  such a forward, at the compositor's gates; the depth-slab and tile-band
  renders on the card against the same on the CPU;
- both compositor kernels on rows that try the cull rectangle (tiny,
  tile-filling, long thin, nearly degenerate, non-finite, at the opacity
  floor and above the clamp), on 32x32 and 16x16 tiles, a tile width that
  is no power of two and a chunk that is none, with ``t_init`` and
  ``tile_id_base``: n_contrib equal everywhere, the rectangle and warp
  mask the kernels stage (``cull_rects_cuda``) equal to the plain formula's
  row for row, nothing culled where alpha_min <= 0; the backward gives the
  same bits twice;
- the fused preprocess (csrc/preprocess_fwd.cu, preprocess_bwd.cu) against
  the plain path on the card: the packed rows, depth and t_cut within rtol
  1e-5 / atol 1e-6, radius / rx / ry equal, every raw field's gradient and
  the tap's at the gradient gate, over SH degrees 0-3 with the active degree
  below the maximum, antialiasing on and off, a scaling modifier, dead rows
  and the edge rows of tests/torch_preprocess_cases.py; the backward the
  same bits twice; ``render`` launching each kernel once a call, and the
  plain path with ``override_color``;
- the entry gather's pair (csrc/gather_entries_fwd.cu,
  csrc/gather_entries_bwd.cu) against the plain ``index_select`` chain at
  1297x840 and 200,000 splats, with and without row culling: the forward
  bit for bit, the backward bit for bit the chain's ``index_add_``s on the
  CPU (both add a row's slots in slot order) and the same bits twice, row
  N 0; ``render`` launching each once a call, also under torch's
  deterministic algorithms; a train step on the pair against the same on
  the plain chain, Adam's moments within the gradient gate;
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
                                                cull_rects_plain,
                                                slab_transmittance_plain)
from gsplat_tpu_torch.ops import binning as tbin
from gsplat_tpu_torch.ops import preprocess as tpre
from gsplat_tpu_torch.ops.kernels import composite as tcomp
from gsplat_tpu_torch.ops.kernels import gather as kgather
from gsplat_tpu_torch.ops.kernels import preprocess as kpre
from gsplat_tpu_torch.ops.kernels import scan as kscan
from gsplat_tpu_torch.ops.kernels import ssim as kssim
from gsplat_tpu_torch.parallel import prim_shard, sharded, tile_shard
from gsplat_tpu_torch.train import trainer

from torch_cull_cases import CFG as CULL_CFG
from torch_cull_cases import KINDS, frame
from torch_gather_cases import bits
from torch_preprocess_cases import CASE_IDS, CASES
from torch_preprocess_cases import H as PRE_H
from torch_preprocess_cases import W as PRE_W
from torch_preprocess_cases import same, scene, with_leaves

pytestmark = pytest.mark.cuda

IMG_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-3, atol=1e-6)
SSIM_GRAD_TOL = dict(rtol=2e-4, atol=1e-6)
SLAB_TOL = dict(rtol=1e-5, atol=1e-6)
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


PRE_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("deg,active_deg,aa", CASES, ids=CASE_IDS)
def test_preprocess_kernels_match_plain_on_card(deg, active_deg, aa,
                                                cuda_device):
    """The fused pair (``preprocess_packed`` on the card) against the plain
    path on the same card: the forward's packed rows and binning columns,
    and autograd's gradients of every raw field and the tap under one
    random cotangent of the packed rows (culled and dead rows included)."""
    g, cam = scene(deg=deg, active_deg=active_deg, device=cuda_device)
    kw = dict(scaling_modifier=0.7 if aa else 1.0, antialiasing=aa,
              dilation=0.3, alpha_min=1.0 / 255.0)
    ct = torch.tensor(np.random.default_rng(9).standard_normal(
        (g.capacity + 1, 16)), dtype=torch.float32, device=cuda_device)
    outs = []
    for fused in (False, True):
        gg, leaves = with_leaves(g)
        tap = torch.zeros((g.capacity, 2), device=cuda_device,
                          requires_grad=True)
        before = (kpre.preprocess_fwd_cuda.launches,
                  kpre.preprocess_bwd_cuda.launches)
        run = tpre.preprocess_packed if fused else tpre.preprocess_packed_plain
        pre, packed = run(gg, cam, PRE_W, PRE_H, mean2d_tap=tap, **kw)
        (packed * ct).sum().backward()
        torch.cuda.synchronize()
        assert (kpre.preprocess_fwd_cuda.launches,
                kpre.preprocess_bwd_cuda.launches) == \
            tuple(b + fused for b in before)
        outs.append((packed.detach(), pre,
                     {k: v.grad for k, v in leaves.items()}, tap.grad))
    (p0, r0, g0, t0), (p1, r1, g1, t1) = outs
    torch.testing.assert_close(p1, p0, equal_nan=True, **PRE_TOL)
    assert not p1[:, 10:].any() and not p1[-1].any()
    for k in ("depth", "t_cut"):
        torch.testing.assert_close(getattr(r1, k), getattr(r0, k).detach(),
                                   **PRE_TOL)
    for k in ("radius", "rx", "ry"):
        assert torch.equal(getattr(r1, k), getattr(r0, k).detach()), k
    for k in ("mean2d", "conic", "opacity", "color", "invdepth"):
        torch.testing.assert_close(getattr(r1, k), getattr(r0, k),
                                   equal_nan=True, **PRE_TOL)
    for k in gm.TRAINABLE_FIELDS:
        torch.testing.assert_close(g1[k], g0[k], equal_nan=True, **GRAD_TOL)
    torch.testing.assert_close(t1, t0, **GRAD_TOL)
    assert float(r0.radius[7:].gt(0).float().mean()) > 0.5


def test_preprocess_backward_kernel_gives_the_same_bits_twice(cuda_device):
    g, cam = scene(deg=3, device=cuda_device)
    fields = (g.xyz, g.scaling, g.rotation, g.opacity, g.f_dc, g.f_rest,
              g.active)
    s = kpre.Settings(PRE_W, PRE_H, 3, 1.0, True, 0.3, 1.0 / 255.0)
    d = torch.tensor(np.random.default_rng(2).standard_normal(
        (g.capacity + 1, 16)), dtype=torch.float32, device=cuda_device)
    a = kpre.preprocess_bwd_cuda(fields, cam, s, d, True)
    b = kpre.preprocess_bwd_cuda(fields, cam, s, d, True)
    for x, y in zip(a, b):
        same(x, y)


def test_render_on_card_launches_the_preprocess_kernels(cuda_device):
    """``render`` with a gradient: one forward launch, one backward launch
    in the backward; with ``override_color`` the plain path (its counter
    moves, the kernels' do not), at the CPU's image."""
    g, cam = _scene(cuda_device)
    cfg = _cfg(32, 32, 64)
    bg = torch.full((3,), 0.25, device=cuda_device)
    gg, leaves = with_leaves(g)
    f0, b0, p0 = (kpre.preprocess_fwd_cuda.launches,
                  kpre.preprocess_bwd_cuda.launches,
                  tpre.preprocess_packed.plain_cuda)
    out = rasterize.render(gg, cam, 96, 64, bg, cfg, clamp=False)
    assert kpre.preprocess_fwd_cuda.launches == f0 + 1
    out.image.mean().backward()
    assert kpre.preprocess_bwd_cuda.launches == b0 + 1
    assert tpre.preprocess_packed.plain_cuda == p0
    colors = torch.tensor(np.random.default_rng(4).uniform(
        0, 1, (g.capacity, 3)), dtype=torch.float32)
    with torch.no_grad():
        img = rasterize.render(g, cam, 96, 64, bg, cfg, clamp=False,
                               override_color=colors.to(cuda_device)).image
    assert (kpre.preprocess_fwd_cuda.launches,
            kpre.preprocess_bwd_cuda.launches) == (f0 + 1, b0 + 1)
    assert tpre.preprocess_packed.plain_cuda == p0 + 1
    gc, camc = _scene("cpu")
    with torch.no_grad():
        want = rasterize.render(gc, camc, 96, 64, bg.cpu(), cfg, clamp=False,
                                override_color=colors).image
    torch.testing.assert_close(img.cpu(), want, **IMG_TOL)


def _wide_scene(device, n, seed=5):
    """n gaussians at a trained scene's density in a 1297x840 frame, each a
    few tiles wide, made with numpy."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32) \
        * np.array([3.5, 2.4, 1.0], np.float32)
    xyz[:, 2] += 6.0
    arrays = dict(
        xyz=xyz, f_dc=rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32),
        f_rest=(0.1 * rng.standard_normal((n, 15, 3))).astype(np.float32),
        scaling=rng.uniform(-5.0, -3.5, (n, 3)).astype(np.float32),
        rotation=rng.standard_normal((n, 4)).astype(np.float32),
        opacity=rng.uniform(-1.0, 3.0, n).astype(np.float32))
    return (gm.from_numpy(arrays, device=device),
            CameraView.create(np.eye(3), np.zeros(3), 1.0, 0.7,
                              device=device))


@pytest.mark.parametrize("row_cull", [False, True], ids=["rect", "row_cull"])
def test_gather_pair_matches_the_plain_chain_at_full_width(row_cull,
                                                           cuda_device):
    """The entry gather's pair against the plain chain on the card, at
    1297x840 and 200,000 splats: the forward bit for bit (a copy), and
    ``build_entries``' entries too; the backward under a cotangent of the
    scale spread of a gradient bit for bit the chain's two ``index_add_``s
    on the CPU, which add each row's slots in slot order from 0 as the
    kernel does, the same bits on a second launch, and row N exactly 0."""
    W, H, n = 1297, 840, 200_000
    g, cam = _wide_scene(cuda_device, n)
    cfg = RasterizerConfig(row_cull=row_cull)
    with torch.no_grad():
        e = rasterize.build_entries(g, cam, W, H, cfg)
        pre, packed = tpre.preprocess_packed(g, cam, W, H)
        m_cap = -(-int(n * cfg.pairs_per_gaussian) // cfg.chunk) * cfg.chunk
        b = tbin.bin_gaussians(
            pre.mean2d, pre.depth, pre.radius, rx=pre.rx, ry=pre.ry,
            image_width=W, image_height=H, tile_h=cfg.tile_h,
            tile_w=cfg.tile_w, m_cap=m_cap, align=cfg.chunk, slot_tables=True,
            **rasterize.cull_kw(pre, cfg))
    assert torch.equal(b.gidx_sorted, e.binning.gidx_sorted)
    assert int(b.overflow) == 0
    live = b.gidx_sorted < n
    assert 0 < int(live.sum()) < live.numel() and int(b.num_pairs) > n
    want = kgather.gather_entries_plain(packed, b.perm, b.gidx_sorted)
    got = kgather.gather_entries_fwd_cuda(packed, b.perm, b.gidx_sorted)
    torch.cuda.synchronize()
    assert torch.equal(bits(got), bits(want))
    assert torch.equal(bits(e.entries), bits(want))
    rng = np.random.default_rng(7)
    m = b.gidx_sorted.numel()
    d = torch.tensor(rng.standard_normal((m, 16)).astype(np.float32)
                     * 10.0 ** rng.uniform(-3, 3, (m, 1)).astype(np.float32),
                     device=cuda_device)
    x = packed.cpu().requires_grad_()
    plain = torch.autograd.grad(kgather.gather_entries_plain(
        x, b.perm.cpu(), b.gidx_sorted.cpu()), x, d.cpu())[0]
    kern = kgather.gather_entries_bwd_cuda(d, b)
    again = kgather.gather_entries_bwd_cuda(d, b)
    torch.cuda.synchronize()
    assert torch.equal(bits(kern), bits(again))
    assert torch.equal(bits(kern[n]), bits(torch.zeros(16, device=cuda_device)))
    assert float(plain[n].abs().sum()) > 0        # the dead slots' rows
    assert torch.equal(bits(kern[:n].cpu()), bits(plain[:n]))


def test_render_on_card_launches_the_gather_pair(cuda_device):
    """``render`` with a gradient: one forward launch of the gather, one
    backward launch in the backward; with ``override_color`` (plain
    preprocess) the gather still launches; under torch's deterministic
    algorithms both launch too, and the backward gives the packed rows'
    gradient the same bits as without them."""
    g, cam = _scene(cuda_device)
    cfg = _cfg(32, 32, 64)
    bg = torch.full((3,), 0.25, device=cuda_device)
    f0, b0 = (kgather.gather_entries_fwd_cuda.launches,
              kgather.gather_entries_bwd_cuda.launches)
    grads = []
    for deterministic in (False, True):
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        try:
            gg, leaves = with_leaves(g)
            e = rasterize.build_entries(gg, cam, 96, 64, cfg)
            d = torch.tensor(np.random.default_rng(6).standard_normal(
                tuple(e.entries.shape)), dtype=torch.float32,
                device=cuda_device)
            grads.append(torch.autograd.grad(e.entries, leaves["xyz"], d)[0])
        finally:
            torch.use_deterministic_algorithms(False)
    assert torch.equal(bits(grads[0]), bits(grads[1]))
    assert float(grads[0].abs().max()) > 0
    assert (kgather.gather_entries_fwd_cuda.launches,
            kgather.gather_entries_bwd_cuda.launches) == (f0 + 2, b0 + 2)
    gg, leaves = with_leaves(g)
    out = rasterize.render(gg, cam, 96, 64, bg, cfg, clamp=False)
    assert kgather.gather_entries_fwd_cuda.launches == f0 + 3
    out.image.mean().backward()
    assert kgather.gather_entries_bwd_cuda.launches == b0 + 3
    assert float(leaves["xyz"].grad.abs().max()) > 0
    colors = torch.tensor(np.random.default_rng(4).uniform(
        0, 1, (g.capacity, 3)), dtype=torch.float32, device=cuda_device)
    with torch.no_grad():
        rasterize.render(g, cam, 96, 64, bg, cfg, override_color=colors)
    assert (kgather.gather_entries_fwd_cuda.launches,
            kgather.gather_entries_bwd_cuda.launches) == (f0 + 4, b0 + 3)


def test_train_step_on_the_gather_pair_matches_the_plain_chain(
        cuda_device, monkeypatch):
    """One train_step on the card from the same state with the gather pair
    and with the plain chain in its place: the loss to float32's last
    digits, Adam's first moments (0.1 x the gradient) within the gradient
    gate, whose reason here is the order of the plain chain's atomic
    adds."""
    W, H = 96, 64
    rcfg = _cfg(32, 32, 64)
    opt = OptimizationConfig(iterations=100, position_lr_max_steps=100)
    gt = torch.tensor(np.random.default_rng(3).uniform(
        0.2, 0.8, (3, H, W)).astype(np.float32), device=cuda_device)
    ones = torch.ones((1, H, W), device=cuda_device)
    zeros = torch.zeros((1, H, W), device=cuda_device)
    g, cam = _scene(cuda_device)
    out = []
    for route in ("pair", "plain"):
        if route == "plain":
            monkeypatch.setattr(
                rasterize, "gather_entries_cuda",
                lambda p, b: kgather.gather_entries_plain(p, b.perm,
                                                          b.gidx_sorted))
        before = kgather.gather_entries_bwd_cuda.launches
        out.append(trainer.train_step(
            trainer.init_state(g, 1), cam, gt, ones, zeros, zeros,
            torch.zeros(3, device=cuda_device), image_width=W,
            image_height=H, opt=opt, rcfg=rcfg, spatial_lr_scale=1.0,
            antialiasing=False, use_sparse_adam=False, train_test_exp=False,
            use_depth=False))
        assert kgather.gather_entries_bwd_cuda.launches \
            == before + (route == "pair")
    (pair, pair_aux), (plain, plain_aux) = out
    torch.testing.assert_close(pair_aux.loss, plain_aux.loss, rtol=1e-6,
                               atol=0)
    for k in gm.TRAINABLE_FIELDS:
        torch.testing.assert_close(pair.adam.mu[k], plain.adam.mu[k],
                                   rtol=5e-3, atol=1e-7)
    assert float(pair.adam.mu["xyz"].abs().max()) > 0


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


@pytest.mark.parametrize("shape", [(32, 32, 64), (16, 16, 16), (8, 24, 12)],
                         ids=["32x32", "16x16", "8x24-chunk12"])
@pytest.mark.parametrize("kind", KINDS)
def test_kernels_on_rows_that_try_the_cull_rectangle(kind, shape,
                                                     cuda_device):
    """The slab transmittance on a 2x2 frame of adversarial entries; then
    the lower tile row, with its tile_id_base and a random t_init: the
    compositor forward at the image gate, the backward at the gradient
    gate with its atol scaled by the column's
    largest gradient where that exceeds 1 (a column sums up to a tile's
    pixels, in another order than autograd), zero on rows autograd leaves
    at zero, and the same bits on a second launch. A row with a non-finite
    field contributes nowhere; autograd gives it a NaN gradient (0 x NaN),
    the kernel 0, so those rows are compared on the forward only."""
    (entries, ts, tc), geo = frame(kind, shape, seed=2, device=cuda_device)
    # the slab transmittance (no tile_id_base) on the whole 2x2 frame: its
    # plain version at its gate, the cut-free compositor's t_final bit for
    # bit, the same bits twice
    tmit = tcomp.slab_transmittance_cuda(entries, ts, tc, **geo)
    torch.testing.assert_close(
        tmit, slab_transmittance_plain(entries, ts, tc, **geo), **SLAB_TOL)
    assert torch.equal(tmit, tcomp.composite_fwd_cuda(
        entries, ts, tc, **geo, t_eps=0.0).t_final)
    assert torch.equal(tmit, tcomp.slab_transmittance_cuda(entries, ts, tc,
                                                           **geo))
    if kind in ("random", "tiny", "anisotropic", "clamped"):
        assert float(tmit.min()) < 1.0
    base = geo["n_tiles_x"]
    ts, tc = ts[base:].contiguous(), tc[base:].contiguous()
    geo = dict(geo, n_tiles_y=1, tile_id_base=base)
    fwd_kw = dict(t_eps=CULL_CFG.transmittance_eps)
    T, P = ts.shape[0], geo["tile_h"] * geo["tile_w"]
    rng = np.random.default_rng(6)
    t_init, ga, gt = (torch.tensor(v, dtype=torch.float32,
                                   device=cuda_device)
                      for v in (rng.uniform(0.05, 1.0, (T, P)),
                                rng.standard_normal((T, 4, P)),
                                rng.standard_normal((T, P))))
    # what the kernels stage is the plain rectangle, row for row
    rkw = {k: v for k, v in geo.items() if k not in ("chunk", "alpha_max")}
    assert torch.equal(tcomp.cull_rects_cuda(entries, ts, tc, **rkw),
                       cull_rects_plain(entries, ts, tc, **rkw))
    x = entries.detach().requires_grad_()
    plain = composite_tiles_plain(x, ts, tc, **geo, **fwd_kw, t_init=t_init)
    ((plain.accum * ga).sum() + (plain.t_final * gt).sum()).backward()
    kern = tcomp.composite_fwd_cuda(entries, ts, tc, **geo, **fwd_kw,
                                    t_init=t_init)
    for k in ("accum", "t_final"):
        torch.testing.assert_close(getattr(kern, k), getattr(plain, k),
                                   **IMG_TOL)
    assert torch.equal(kern.n_contrib, plain.n_contrib)
    # without t_init too (the other instantiation of the kernel)
    plain1 = composite_tiles_plain(entries, ts, tc, **geo, **fwd_kw)
    kern1 = tcomp.composite_fwd_cuda(entries, ts, tc, **geo, **fwd_kw)
    for k in ("accum", "t_final"):
        torch.testing.assert_close(getattr(kern1, k), getattr(plain1, k),
                                   **IMG_TOL)
    assert torch.equal(kern1.n_contrib, plain1.n_contrib)
    bgeo = {k: v for k, v in geo.items() if k != "chunk"}
    d = tcomp.composite_bwd_cuda(entries, ts, tc, kern.t_final,
                                 kern.n_contrib, ga, gt, **bgeo)
    again = tcomp.composite_bwd_cuda(entries, ts, tc, kern.t_final,
                                     kern.n_contrib, ga, gt, **bgeo)
    torch.cuda.synchronize()
    assert torch.equal(d, again)
    assert bool(torch.isfinite(d).all())
    finite = torch.isfinite(entries).all(dim=1)
    assert float(d[~finite].abs().sum()) == 0.0
    want, got = x.grad[finite][:, :10], d[finite][:, :10]
    atol = GRAD_TOL["atol"] * want.abs().amax(dim=0).clamp(min=1.0)
    bad = (got - want).abs() > atol + GRAD_TOL["rtol"] * want.abs()
    assert not bool(bad.any()), (
        int(bad.sum()), float((got - want).abs().max()),
        float(want.abs().max()))
    assert bool((got[(want == 0).all(dim=1)] == 0).all())
    if kind in ("random", "tiny", "anisotropic", "clamped"):
        assert float(got.abs().max()) > 0


@pytest.mark.parametrize("floor", [0.0, -1.0])
def test_kernels_cull_nothing_without_a_floor(floor, cuda_device):
    """alpha_min <= 0: every staged rectangle is the whole tile with all 8
    warps, rows of negative opacity under a negative floor included, so the
    alpha test alone decides."""
    (entries, ts, tc), geo = frame("opacity_edge", (32, 32, 64), seed=3,
                                   device=cuda_device)
    geo = dict(geo, alpha_min=floor)
    rkw = {k: v for k, v in geo.items() if k not in ("chunk", "alpha_max")}
    rects = tcomp.cull_rects_cuda(entries, ts, tc, **rkw)
    assert torch.equal(rects, cull_rects_plain(entries, ts, tc, **rkw))
    owned = rects[:, 0] != -2
    assert int(owned.sum()) == int(tc.sum())
    assert bool((rects[owned] == torch.tensor(
        [0, 31, 0, 31, 255], dtype=torch.int32, device=cuda_device)).all())


def test_slab_and_band_renders_on_card_match_cpu(cuda_device):
    """render_prim_sharded and render_tile_sharded on the card launch their
    kernels once per slab or band, forward and backward (the slab
    transmittance on all slabs but the farthest), and give the CPU route's
    images and gradients."""
    W, H = 96, 128
    cfg = _cfg(32, 32, 64)
    renders = {
        "slab": lambda p, c, bg: prim_shard.render_prim_sharded(
            p, c, W, H, bg, cfg, n_slabs=4, m_cap=400 * 12)[:2],
        "band": lambda p, c, bg: tile_shard.render_tile_sharded(
            p, c, W, H, bg, cfg, n_bands=2)[:2]}
    # pass 1 runs on every slab but the farthest
    want_launches = {"slab": (4, 4, 3), "band": (2, 2, 0)}
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


def _images(device, shape=(3, 100, 130), seed=2, patch=True):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    if patch:
        a[:, 10:40, 20:60] = 0.0           # constant: the variance clamp
    w = rng.uniform(0, 1, shape).astype(np.float32)
    return [torch.tensor(x, device=device) for x in (a, b, w)]


def test_ssim_kernels_match_plain(cuda_device):
    a, b, w = _images(cuda_device)
    before = (kssim.ssim_fwd_cuda.launches, kssim.ssim_bwd_cuda.launches)
    m = kssim.ssim_fwd_cuda(a, b)
    torch.testing.assert_close(m, tssim.ssim_map(a, b), rtol=1e-5, atol=1e-6)
    # the same launch writes the partial maps: the map keeps its bits
    m2, p = kssim.ssim_fwd_cuda(a, b, partials=True)
    assert torch.equal(m, m2)
    torch.testing.assert_close(p, kssim.ssim_partials_plain(a, b), rtol=1e-5,
                               atol=1e-6)
    # the mean's cotangent, and a non-uniform one at 1e-2 of unit size:
    # d img1 sums terms that cancel, whose float32 rounding is ~1e-7 of
    # their size in autograd as in the kernel, and at unit size that alone
    # exceeds the gate's atol (float32 autograd is as far from float64)
    for cot in (torch.full_like(a, 1.0 / a.numel()), 1e-2 * w):
        x = a.clone().requires_grad_()
        (tssim.ssim_map(x, b) * cot).sum().backward()
        got = kssim.ssim_bwd_cuda(a, b, cot, p)
        torch.testing.assert_close(got, x.grad, **SSIM_GRAD_TOL)
        torch.testing.assert_close(got, kssim.ssim_bwd_plain(a, b, cot, p),
                                   **SSIM_GRAD_TOL)
        assert torch.equal(got, kssim.ssim_bwd_cuda(a, b, cot, p))
    torch.cuda.synchronize()
    assert (kssim.ssim_fwd_cuda.launches, kssim.ssim_bwd_cuda.launches) == (
        before[0] + 2, before[1] + 4)
    # through autograd: fast_ssim on the card runs both kernels, one launch
    # each
    x = a.clone().requires_grad_()
    before = (kssim.ssim_fwd_cuda.launches, kssim.ssim_bwd_cuda.launches)
    v = tssim.fast_ssim(x, b)
    v.backward()
    assert (kssim.ssim_fwd_cuda.launches, kssim.ssim_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    y = a.clone().requires_grad_()
    tssim.ssim_map(y, b).mean().backward()      # the plain form
    torch.testing.assert_close(v.detach(), tssim.ssim_map(a, b).mean(),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(x.grad, y.grad, **SSIM_GRAD_TOL)
    with torch.no_grad():                       # no partial maps, same map
        torch.testing.assert_close(tssim.fast_ssim(a, b), v.detach(),
                                   rtol=0, atol=0)


def test_ssim_on_card_takes_the_kernel_and_matches_cpu(cuda_device):
    """``ssim`` of a (2,3,H,W) batch on the card: one forward launch (one
    backward under autograd), the leading axes flattened into the kernel's
    channels; the value within rtol 1e-5 / atol 1e-6 of ``ssim`` on the
    CPU, the img1 gradient within the SSIM gradient gate of the CPU's. A
    window other than 11, or an img2 that wants a gradient, raises."""
    a, b, _ = _images(cuda_device, shape=(2, 3, 70, 90), patch=False)
    before = (kssim.ssim_fwd_cuda.launches, kssim.ssim_bwd_cuda.launches)
    x = a.clone().requires_grad_()
    v = tssim.ssim(x, b)
    v.backward()
    torch.cuda.synchronize()
    assert (kssim.ssim_fwd_cuda.launches, kssim.ssim_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    xc = a.cpu().requires_grad_()
    vc = tssim.ssim(xc, b.cpu())
    vc.backward()
    torch.testing.assert_close(v.detach().cpu(), vc.detach(), rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(x.grad.cpu(), xc.grad, **SSIM_GRAD_TOL)
    with pytest.raises(ValueError, match="window_size 11"):
        tssim.ssim(a, b, window_size=7)
    with pytest.raises(ValueError, match="img2"):
        tssim.ssim(a, b.clone().requires_grad_())


def test_lpips_on_card_matches_cpu(cuda_device, tmp_path, monkeypatch):
    """LPIPS with random weights on the card (cuDNN's convolutions, TF32
    off) within rtol 1e-4 of the CPU's, on the same 2 x 3 x 96 x 128
    batch."""
    from gsplat_tpu_torch.ops import lpips
    rng = np.random.default_rng(4)
    path = tmp_path / "lpips_random.npz"
    np.savez(path, **lpips.random_weights(rng))
    monkeypatch.setenv("GSPLAT_LPIPS_WEIGHTS", str(path))
    x = rng.uniform(0, 1, (2, 3, 96, 128)).astype(np.float32)
    y = np.clip(x + 0.1 * rng.standard_normal(x.shape), 0, 1).astype(
        np.float32)
    got = lpips.lpips_vgg(device=cuda_device)(
        torch.tensor(x, device=cuda_device), torch.tensor(y,
                                                          device=cuda_device))
    want = lpips.lpips_vgg(device="cpu")(torch.tensor(x), torch.tensor(y))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=0)
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 33, 65), (3, 70, 200),
                                   (1, 150, 31), (2, 40, 64, "offset")])
def test_ssim_kernels_on_ragged_tiles(cuda_device, shape):
    """Images that are no whole number of 32x64 tiles, and smaller than
    the halo: the map, partial maps and gradient against the plain ones.
    Rows of a multiple of 4 floats on 16-byte aligned tensors take the
    16-byte staging, the others (and a tensor 4 bytes into its storage)
    the staging float by float."""
    a, b, w = _images(cuda_device, shape=shape[:3], patch=False)
    if len(shape) == 4:                  # the same values, 4 bytes along
        a, b, w = (torch.empty(x.numel() + 1, device=cuda_device)[1:]
                   .view_as(x).copy_(x) for x in (a, b, w))
        assert a.data_ptr() % 16 == 4
    m, p = kssim.ssim_fwd_cuda(a, b, partials=True)
    torch.testing.assert_close(m, tssim.ssim_map(a, b), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(p, kssim.ssim_partials_plain(a, b), rtol=1e-5,
                               atol=1e-6)
    x = a.clone().requires_grad_()
    (tssim.ssim_map(x, b) * 1e-2 * w).sum().backward()
    torch.testing.assert_close(kssim.ssim_bwd_cuda(a, b, 1e-2 * w, p),
                               x.grad, **SSIM_GRAD_TOL)


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


def test_dp_step_over_nccl_world_of_one_is_train_step(cuda_device,
                                                      monkeypatch):
    """A world of one NCCL rank, joined from an environment set here: the
    DP step (its two all-reduces on the card) gives ``train_step``'s state
    and aux bit for bit from the same state, both under torch's
    deterministic algorithms (the entry gather's gradient without
    atomics)."""
    import socket

    import torch.distributed as dist

    from gsplat_tpu_torch.parallel import dp, mesh
    from gsplat_tpu_torch.train.checkpoint import state_items
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     WORLD_SIZE="1", RANK="0", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    W, H = 96, 64
    kw = dict(image_width=W, image_height=H, opt=OptimizationConfig(),
              rcfg=_cfg(32, 32, 64), spatial_lr_scale=1.0)
    g, cam = _scene(cuda_device)
    gt = torch.tensor(np.random.default_rng(3).uniform(
        0.2, 0.8, (3, H, W)).astype(np.float32), device=cuda_device)
    ones = torch.ones((1, H, W), device=cuda_device)
    zeros = torch.zeros((1, H, W), device=cuda_device)
    inputs = (cam, gt, ones, zeros, zeros, torch.zeros(3, device=cuda_device))
    assert mesh.init_distributed()
    try:
        assert dist.get_backend() == "nccl"
        step = dp.make_dp_train_step(mesh.make_mesh(), **kw)
        state = trainer.init_state(g, 1)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            got = step(state, *inputs)
            want = trainer.train_step(
                state, *inputs, antialiasing=False, use_sparse_adam=False,
                train_test_exp=False, use_depth=False, **kw)
        finally:
            torch.use_deterministic_algorithms(False)
    finally:
        dist.destroy_process_group()
    for (n1, a), (n2, b) in zip(state_items(got[0]), state_items(want[0])):
        assert n1 == n2
        np.testing.assert_array_equal(a, b, err_msg=n1)
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)
