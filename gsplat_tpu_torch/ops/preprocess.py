"""Per-Gaussian screen-space preprocessing in plain torch; autograd gives
the backward. Counterpart of gsplat_tpu/ops/preprocess.py.

Frustum cull → EWA perspective projection of the 3D covariance (Jacobian
with the 1.3·tan_fov clamp) → +0.3 px dilation → optional Mip-Splatting
antialiasing opacity correction → SH→RGB clamped at 0 → 3σ radius and the
tight per-axis binning extents. The tiny per-gaussian matrix products are
written as component arithmetic on (N,) columns, as in the JAX package, so
they stay exact f32 on every device and fuse into elementwise passes.

``preprocess_packed`` is what the render path calls: from the raw
trainable fields to the packed entry rows the compositor's gather reads.
On the card (no precomputed covariances or colours, SH degree at most 3)
it is one fused CUDA kernel each way (ops/kernels/preprocess.py); on the
CPU, or with precomputed inputs, it is ``preprocess_packed_plain``: the
activations, ``preprocess`` and ``pack_entries`` under autograd, the
version the kernels are held to.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gsplat_tpu_torch.core import sh as sh_lib
from gsplat_tpu_torch.core import transforms
from gsplat_tpu_torch.core.camera import CameraView
from gsplat_tpu_torch.models.gaussian_model import GaussianParams
from gsplat_tpu_torch.ops.kernels import preprocess as kpre


class Preprocessed(NamedTuple):
    mean2d: torch.Tensor      # (N, 2) pixel coords (pixel centers at integers)
    depth: torch.Tensor       # (N,) view-space z
    conic: torch.Tensor       # (N, 3) inverse 2D covariance (a, b, c)
    color: torch.Tensor       # (N, 3) RGB from SH (clamped at 0)
    opacity: torch.Tensor     # (N,) effective opacity (after AA correction)
    radius: torch.Tensor      # (N,) float pixel radius; 0 = culled
    invdepth: torch.Tensor    # (N,) 1/depth
    rx: torch.Tensor          # (N,) tight binning half-width; 0 = culled
    ry: torch.Tensor          # (N,)
    t_cut: torch.Tensor       # (N,) level-set threshold; 0 = culled


def ndc2pix(v, size):
    """((v+1)·S − 1)/2 — pixel centers at integers."""
    return ((v + 1.0) * size - 1.0) * 0.5


def preprocess(xyz: torch.Tensor,            # (N,3)
               scaling: torch.Tensor,         # (N,3) activated (exp'd)
               rotation: torch.Tensor,        # (N,4) activated (normalized)
               opacity: torch.Tensor,         # (N,) activated (sigmoid'd)
               features: torch.Tensor,        # (N,K,3) SH coeffs, DC first
               active_sh_degree: int,
               cam: CameraView,
               image_width: int, image_height: int,
               *,
               active_mask: Optional[torch.Tensor] = None,  # (N,) bool
               scaling_modifier: float = 1.0,
               antialiasing: bool = False,
               dilation: float = 0.3,
               alpha_min: float = 1.0 / 255.0,
               cov3d_precomp: Optional[torch.Tensor] = None,   # (N,6)
               colors_precomp: Optional[torch.Tensor] = None,  # (N,3)
               ) -> Preprocessed:
    """Project all Gaussians to screen space with the reference's numeric
    constants: z-near cull at 0.2, 1.3·tanfov clamp, 0.3 px dilation,
    λ = mid + sqrt(max(0.1, mid² − det)), radius = ceil(3√λ)."""
    W, H = image_width, image_height
    fx = W / (2.0 * cam.tanfovx)
    fy = H / (2.0 * cam.tanfovy)

    def apply44(Mat, v3):
        """rows of (x,y,z,1) @ Matᵀ for a constant 4x4: list of 4 (N,)."""
        x, y, z = v3[:, 0], v3[:, 1], v3[:, 2]
        return [Mat[i, 0] * x + Mat[i, 1] * y + Mat[i, 2] * z + Mat[i, 3]
                for i in range(4)]

    # --- projection ---
    ph = apply44(cam.full_proj, xyz)
    p_w = 1.0 / (ph[3] + 1e-7)
    pv = apply44(cam.world_view, xyz)
    depth = pv[2]
    mean2d = torch.stack([ndc2pix(ph[0] * p_w, W),
                          ndc2pix(ph[1] * p_w, H)], dim=-1)

    # --- EWA 2D covariance ---
    if cov3d_precomp is None:
        cov3d = transforms.covariance_from_scaling_rotation(
            scaling, scaling_modifier, rotation)
    else:
        cov3d = cov3d_precomp
    sxx, sxy, sxz = cov3d[:, 0], cov3d[:, 1], cov3d[:, 2]
    syy, syz, szz = cov3d[:, 3], cov3d[:, 4], cov3d[:, 5]

    tz = depth
    safe_tz = torch.where(torch.abs(tz) < 1e-6, torch.full_like(tz, 1e-6), tz)
    limx = 1.3 * cam.tanfovx
    limy = 1.3 * cam.tanfovy
    txtz = torch.clamp(pv[0] / safe_tz, -limx, limx)
    tytz = torch.clamp(pv[1] / safe_tz, -limy, limy)
    tx = txtz * tz
    ty = tytz * tz

    # M = J @ W, rows m0/m1 as component columns:
    #   J = [[fx/tz, 0, -fx·tx/tz²], [0, fy/tz, -fy·ty/tz²]]
    inv_tz = 1.0 / safe_tz
    a0 = fx * inv_tz
    a2x = -fx * tx * inv_tz * inv_tz
    b1 = fy * inv_tz
    b2y = -fy * ty * inv_tz * inv_tz
    Wv = cam.world_view[:3, :3]
    m0 = [a0 * Wv[0, k] + a2x * Wv[2, k] for k in range(3)]
    m1 = [b1 * Wv[1, k] + b2y * Wv[2, k] for k in range(3)]

    def sigma_dot(m):  # Σ @ m for symmetric-6 Σ
        return (sxx * m[0] + sxy * m[1] + sxz * m[2],
                sxy * m[0] + syy * m[1] + syz * m[2],
                sxz * m[0] + syz * m[1] + szz * m[2])

    s0 = sigma_dot(m0)
    s1 = sigma_dot(m1)
    c00 = m0[0] * s0[0] + m0[1] * s0[1] + m0[2] * s0[2]
    c01 = m0[0] * s1[0] + m0[1] * s1[1] + m0[2] * s1[2]
    c11 = m1[0] * s1[0] + m1[1] * s1[1] + m1[2] * s1[2]
    det_orig = c00 * c11 - c01 * c01
    c00 = c00 + dilation
    c11 = c11 + dilation
    det = c00 * c11 - c01 * c01

    safe_det = torch.where(det == 0, torch.ones_like(det), det)
    inv_det = 1.0 / safe_det
    conic = torch.stack([c11 * inv_det, -c01 * inv_det, c00 * inv_det], -1)

    mid = 0.5 * (c00 + c11)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0)))

    if antialiasing:
        h_conv = torch.sqrt(torch.clamp(det_orig / safe_det, min=2.5e-5))
        opacity_eff = opacity * h_conv
    else:
        opacity_eff = opacity

    # Tight binning extents: the AABB of the {alpha >= alpha_min} level-set
    # ellipse dᵀ(Σ₂d)⁻¹d ≤ t = 2·ln(op/alpha_min) (+1e-3 slack), intersected
    # with the reference's ±radius square. A pixel outside it is provably
    # below the compositor's alpha floor, so the image does not change.
    t_cut = torch.clamp(
        2.0 * torch.log(torch.clamp(opacity_eff, min=1e-12) / alpha_min)
        + 1e-3, min=0.0)
    rx = torch.minimum(
        torch.ceil(torch.sqrt(t_cut * torch.clamp(c00, min=0.0))), radius)
    ry = torch.minimum(
        torch.ceil(torch.sqrt(t_cut * torch.clamp(c11, min=0.0))), radius)

    # --- SH → RGB (clamped), degree masked by the warm-up state ---
    if colors_precomp is None:
        dirs = xyz - cam.camera_center[None, :]
        # Double-where normalization: dead padding slots can sit exactly at
        # the camera center, where the norm's gradient is inf and 0·inf
        # would poison their xyz gradient.
        nz = torch.sum(dirs * dirs, dim=-1, keepdim=True) > 0
        safe_dirs = torch.where(nz, dirs, torch.ones_like(dirs))
        norm = torch.linalg.norm(safe_dirs, dim=-1, keepdim=True)
        dirs = torch.where(nz, safe_dirs / norm, torch.zeros_like(dirs))
        K = features.shape[1]
        max_deg = int(round(K ** 0.5)) - 1
        basis = sh_lib.sh_basis(max_deg, dirs)                     # (N,K)
        k_active = (int(active_sh_degree) + 1) ** 2
        keep = torch.arange(K, device=basis.device)[None, :] < k_active
        basis = torch.where(keep, basis, torch.zeros_like(basis))
        color = (features * basis[:, :, None]).sum(1) + 0.5
        color = torch.clamp(color, min=0.0)
    else:
        color = colors_precomp

    # --- visibility: z-cull at 0.2, zero/negative determinant cull ---
    visible = (depth > 0.2) & (det > 0)
    if active_mask is not None:
        visible = visible & active_mask
    zero = torch.zeros_like(radius)
    radius = torch.where(visible, radius, zero)
    tight_visible = visible & (t_cut > 0.0)
    rx = torch.where(tight_visible, rx, zero)
    ry = torch.where(tight_visible, ry, zero)

    safe_depth = torch.where(depth == 0, torch.ones_like(depth), depth)
    invdepth = torch.where(depth > 0.2, 1.0 / safe_depth,
                           torch.zeros_like(depth))

    return Preprocessed(mean2d=mean2d, depth=depth, conic=conic, color=color,
                        opacity=opacity_eff, radius=radius, invdepth=invdepth,
                        rx=rx, ry=ry,
                        t_cut=torch.where(tight_visible, t_cut, zero))


def pack_rows(pre: Preprocessed) -> torch.Tensor:
    """(N, 16) per-gaussian packed rows. Columns: 0 mx, 1 my, 2 conic_a,
    3 conic_b, 4 conic_c, 5 opacity, 6..8 rgb, 9 invdepth, 10..15 zero."""
    n = pre.mean2d.shape[0]
    return torch.cat([
        pre.mean2d, pre.conic, pre.opacity[:, None], pre.color,
        pre.invdepth[:, None],
        torch.zeros((n, 6), dtype=pre.mean2d.dtype, device=pre.mean2d.device),
    ], dim=-1)


def pack_entries(pre: Preprocessed) -> torch.Tensor:
    """(N+1, 16) packed rows; row N is the zero row that sentinel entries
    address."""
    cols = pack_rows(pre)
    return torch.cat([cols, cols.new_zeros((1, 16))], dim=0)


def preprocess_packed_plain(gaussians: GaussianParams, cam: CameraView,
                            image_width: int, image_height: int, *,
                            scaling_modifier: float = 1.0,
                            antialiasing: bool = False,
                            dilation: float = 0.3,
                            alpha_min: float = 1.0 / 255.0,
                            mean2d_tap: Optional[torch.Tensor] = None,
                            cov3d_precomp: Optional[torch.Tensor] = None,
                            colors_precomp: Optional[torch.Tensor] = None):
    """``preprocess_packed`` in plain PyTorch on any device: the activated
    fields through ``preprocess``, the tap added into the means, and
    ``pack_entries``. Returns (Preprocessed, packed (N+1, 16))."""
    pre = preprocess(
        gaussians.xyz, gaussians.get_scaling(), gaussians.get_rotation(),
        gaussians.get_opacity(), gaussians.get_features(),
        gaussians.active_sh_degree, cam, image_width, image_height,
        active_mask=gaussians.active, scaling_modifier=scaling_modifier,
        antialiasing=antialiasing, dilation=dilation, alpha_min=alpha_min,
        cov3d_precomp=cov3d_precomp, colors_precomp=colors_precomp)
    if mean2d_tap is not None:
        # NDC-unit gradient tap: the screen-space mean gradient scaled like
        # the reference's mean2D gradients that feed densification
        scale = torch.tensor([[0.5 * image_width, 0.5 * image_height]],
                             dtype=torch.float32, device=mean2d_tap.device)
        pre = pre._replace(mean2d=pre.mean2d + mean2d_tap * scale)
    return pre, pack_entries(pre)


def preprocess_packed(gaussians: GaussianParams, cam: CameraView,
                      image_width: int, image_height: int, *,
                      scaling_modifier: float = 1.0,
                      antialiasing: bool = False,
                      dilation: float = 0.3,
                      alpha_min: float = 1.0 / 255.0,
                      mean2d_tap: Optional[torch.Tensor] = None,
                      cov3d_precomp: Optional[torch.Tensor] = None,
                      colors_precomp: Optional[torch.Tensor] = None):
    """Every gaussian projected and packed: (Preprocessed, packed), packed
    the (N+1, 16) rows of ``pack_entries`` (row N zero) with the tap
    (N, 2), where given, added into columns 0-1 scaled by (W/2, H/2).

    Routed by what the inputs are: CUDA tensors with neither precomputed
    covariances nor colours, and at most 16 SH coefficients, go through the
    fused kernels; the Preprocessed's mean2d, conic, opacity, color and
    invdepth are then views of the packed rows and depth, radius, rx, ry,
    t_cut carry no gradient (binning reads them detached). Anything else
    takes ``preprocess_packed_plain``; ``preprocess_packed.plain_cuda``
    counts such calls on a CUDA device."""
    kw = dict(scaling_modifier=scaling_modifier, antialiasing=antialiasing,
              dilation=dilation, alpha_min=alpha_min)
    if gaussians.device.type != "cuda" or cov3d_precomp is not None \
            or colors_precomp is not None \
            or gaussians.f_rest.shape[1] + 1 > kpre.MAX_COEFFS:
        if gaussians.device.type == "cuda":
            preprocess_packed.plain_cuda += 1
        return preprocess_packed_plain(
            gaussians, cam, image_width, image_height, mean2d_tap=mean2d_tap,
            cov3d_precomp=cov3d_precomp, colors_precomp=colors_precomp, **kw)
    g = gaussians
    packed, depth, radius, rx, ry, t_cut = kpre.preprocess_packed_cuda(
        (g.xyz, g.scaling, g.rotation, g.opacity, g.f_dc, g.f_rest,
         g.active), mean2d_tap, cam,
        kpre.Settings(image_width, image_height, g.active_sh_degree, **kw))
    rows = packed[:-1]
    return Preprocessed(mean2d=rows[:, 0:2], depth=depth, conic=rows[:, 2:5],
                        color=rows[:, 6:9], opacity=rows[:, 5],
                        radius=radius, invdepth=rows[:, 9], rx=rx, ry=ry,
                        t_cut=t_cut), packed


preprocess_packed.plain_cuda = 0   # CUDA calls on the plain path
