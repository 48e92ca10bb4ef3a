"""Drive the public render API end to end on a synthetic scene: one render
and its gradient. Counterpart of tools/drive_render.py, whose ``pallas``
/ ``xla`` argument becomes the device: on the card the CUDA kernels run,
and the render and its gradient are held against the plain versions on
the CPU; ``--device cpu`` runs the plain versions alone.

    python -m gsplat_tpu_torch.tools.drive_render [--device cpu]

2,000 gaussians N(0, 1) + (0, 0, 5) in front of an identity camera, SH 3,
256x128. Prints the image's stats, the visible count, the pairs and the
overflow (asserted 0), the row-cull A/B, and asserts that the ``xyz``
gradient of an L1 loss is finite and non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

W, H = 256, 128
N = 2000
IMG_TOL = dict(rtol=1e-4, atol=2e-4)       # the JAX tool's cross-impl gate
CULL_TOL = dict(rtol=1e-5, atol=2e-6)      # row culling regroups products


def scene(device):
    """(gaussians, camera) of the drive, drawn from seed 0."""
    from gsplat_tpu_torch.core.camera import CameraView
    from gsplat_tpu_torch.models import gaussian_model as gm

    rng = np.random.default_rng(0)
    pts = rng.standard_normal((N, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    colors = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    g = gm.create_from_pcd(pts, colors, max_sh_degree=3, capacity=2048,
                           device=device)
    cam = CameraView.create(R=np.eye(3), T=np.zeros(3), fovx=0.9, fovy=0.7,
                            device=device)
    return g, cam


def xyz_grad(g, cam, cfg):
    """The gradient of mean |image - 0.5| (unclamped) with respect to the
    means."""
    import torch

    from gsplat_tpu_torch.models import gaussian_model as gm
    from gsplat_tpu_torch.ops import rasterize

    t = {k: v.detach().requires_grad_() for k, v in gm.trainables(g).items()}
    out = rasterize.render(gm.with_trainables(g, t), cam, W, H,
                           torch.zeros(3, device=g.device), cfg, clamp=False)
    (out.image - 0.5).abs().mean().backward()
    return t["xyz"].grad


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = p.parse_args(argv)

    import torch

    from gsplat_tpu_torch.config import RasterizerConfig
    from gsplat_tpu_torch.ops import rasterize
    from gsplat_tpu_torch.utils.general import resolve_device

    dev = resolve_device(args.device)
    print("device:", dev, torch.cuda.get_device_name(dev)
          if dev.type == "cuda" else "cpu")
    g, cam = scene(dev)
    cfg = RasterizerConfig(pairs_per_gaussian=64.0)
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        out = rasterize.render(g, cam, W, H, bg, cfg)
    img = out.image.cpu().numpy()
    print(f"device={dev.type} image shape {img.shape} range "
          f"[{img.min():.4f},{img.max():.4f}] mean {img.mean():.4f}")
    visible = int((out.radii > 0).sum())
    print("visible gaussians:", visible, "pairs:", int(out.num_pairs),
          "overflow:", int(out.overflow))
    assert int(out.overflow) == 0, \
        "pair list truncated: the drive must not overflow"
    assert img.shape == (3, H, W) and img.max() > 0.05, "blank render!"

    # row culling on the same device: the dropped pairs lie below the
    # compositor's alpha floor, so the image agrees up to the regrouping
    # of the chunked transmittance products
    with torch.no_grad():
        out_nc = rasterize.render(
            g, cam, W, H, bg,
            dataclasses.replace(cfg, row_cull=not cfg.row_cull))
    np.testing.assert_allclose(img, out_nc.image.cpu().numpy(), **CULL_TOL)
    print(f"row_cull A/B agree (pairs {int(out.num_pairs)} vs "
          f"{int(out_nc.num_pairs)})")

    t0 = time.perf_counter()
    gx = xyz_grad(g, cam, cfg).cpu().numpy()
    print(f"grad xyz: max|g|={np.abs(gx).max():.6f} "
          f"nnz={np.count_nonzero(gx)} t={time.perf_counter() - t0:.1f}s")
    assert np.isfinite(gx).all() and np.abs(gx).max() > 0

    if dev.type == "cuda":
        # the kernels against the plain versions on the same inputs (the
        # card's gaussians copied over: the knn scales of create_from_pcd
        # round differently on the two devices)
        from gsplat_tpu_torch.models import gaussian_model as gm
        g_c = dataclasses.replace(g, **{k: getattr(g, k).cpu()
                                        for k in gm.TENSOR_FIELDS})
        cam_c = scene("cpu")[1]
        with torch.no_grad():
            ref = rasterize.render(g_c, cam_c, W, H, torch.zeros(3), cfg)
        np.testing.assert_allclose(img, ref.image.numpy(), **IMG_TOL)
        gx_c = xyz_grad(g_c, cam_c, cfg).numpy()
        denom = np.abs(gx_c).max()
        assert denom > 0 and np.abs(gx - gx_c).max() <= 0.01 * denom, \
            (f"kernel / plain grad mismatch: {np.abs(gx - gx_c).max():.3e} "
             f"vs {denom:.3e}")
        print("kernels vs plain: image within 1e-4, grads within 1%: OK")
    print("OK")
    return dict(image=img, visible=visible, overflow=int(out.overflow),
                grad_xyz=gx)


if __name__ == "__main__":
    main()
