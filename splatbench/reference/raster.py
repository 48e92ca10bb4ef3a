"""The plain reference renderer of 3D Gaussian splats: projection, tile
binning and front-to-back alpha compositing in plain PyTorch, float32,
with its own gradient pass.

It follows the rasterizer of Kerbl et al., "3D Gaussian Splatting for
Real-Time Radiance Field Rendering" (ACM TOG 42(4), 2023), with the
constants of its public CUDA code: z-near cull at 0.2, the 1.3·tan(fov)
clamp of the Jacobian, 0.3 px² dilation, radius ceil(3·sqrt(λ_max)),
alpha = min(0.99, opacity·exp(power)) skipped below 1/255 or where
power > 0, a pixel stopping before the first splat that would take its
transmittance below 1e-4, and the gradient of an alpha that the 0.99 clamp
holds taken as that of opacity·exp(power), as the CUDA backward takes it.
Two rules are those of the system measured, stated in its documentation:
a splat reaches the tiles of its rectangle cut to the axis-aligned box of
its alpha >= 1/255 ellipse (level 2·ln(opacity·255) + 1e-3), and a
splat's SH colour is max(c + 0.5, 0).

Two step options of the 3DGS code are here too, off by default: the EWA
filter of its ``dr_aa`` rasterizer (``antialiasing``: the opacity scaled by
sqrt(max(2.5e-5, det(Σ₂) / det(Σ₂ + 0.3·I))), which the binning box then
sees), and a per-image exposure, the 3 x 4 affine applied to the raw image
before the clamp. A loss may read the frame's inverse depth and give its
gradient, which enters the compositing walk's fourth column.

Every product of a matrix or a batch of small matrices goes through
``Products.mm``, which in the lower-precision control rounds both operands
to TF32 (10 mantissa bits) first, as the tensor cores do with TF32 on.
The reference turns the library's own TF32 off while it runs
(``full_f32``), whatever the process had set, so that its products are
float32 unless the control rounds them. Nothing here imports the system
under test.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
DILATION = 0.3
Z_NEAR_CULL = 0.2

AA_MIN_RATIO = 2.5e-5
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest TF32 value (10 mantissa bits, ties to
    even), with the gradient passed straight through."""
    i = x.detach().contiguous().view(torch.int32)
    r = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return x + (r.view(torch.float32) - x).detach()


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuBLAS's products and cuDNN's convolutions inside, the
    flags as they were after."""
    mm = torch.backends.cuda.matmul.allow_tf32
    conv = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = conv


class Products:
    """Matrix products in float32, or with ``tf32`` on their operands
    rounded to TF32 first (the lower-precision control)."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def r(self, x):
        return tf32_round(x) if self.tf32 else x

    def mm(self, a, b):
        return torch.matmul(self.r(a), self.r(b))

    def conv(self, x, w, **kw):
        return torch.nn.functional.conv2d(self.r(x), self.r(w), **kw)


class View(NamedTuple):
    """A pinhole camera: 4x4 world-to-view and full projection matrices
    (column-vector convention), centre, tan of the half fields of view."""
    world_view: torch.Tensor
    full_proj: torch.Tensor
    center: torch.Tensor
    tanfovx: float
    tanfovy: float


class ViewRecord(NamedTuple):
    """One check view as the reference takes it, on the device, holding
    the values the system's step was fed: the view, the pose's index, the
    ground truth (3, H, W), the alpha mask (1, H, W) in [0, 1], the inverse
    depth and its mask (1, H, W), each None where the scene gives none. A
    (view, ground truth) pair reads as a record with no alpha mask (all
    ones) and no depth: ``ViewRecord(*pair)``."""
    view: View
    gt: torch.Tensor
    pose: int = -1
    alpha_mask: Optional[torch.Tensor] = None
    invdepth: Optional[torch.Tensor] = None
    depth_mask: Optional[torch.Tensor] = None


class Projected(NamedTuple):
    mean2d: torch.Tensor    # (N, 2) pixels, centres at integers
    depth: torch.Tensor     # (N,)
    conic: torch.Tensor     # (N, 3)
    opacity: torch.Tensor   # (N,)
    color: torch.Tensor     # (N, 3)
    invdepth: torch.Tensor  # (N,)
    radius: torch.Tensor    # (N,) 0 = culled
    rx: torch.Tensor        # (N,) half-extents of the binning box
    ry: torch.Tensor


def quat_to_rotmat(q):
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def sh_basis(deg, d):
    """(N, (deg+1)²) real SH basis at unit directions ``d``, degree <= 3,
    in the order of the 3DGS code's eval_sh."""
    x, y, z = d.unbind(-1)
    out = [torch.full_like(x, SH_C0)]
    if deg > 0:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out += [SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2 * zz - xx - yy),
                SH_C2[3] * xz, SH_C2[4] * (xx - yy)]
    if deg > 2:
        out += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z,
                SH_C3[2] * y * (4 * zz - xx - yy),
                SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                SH_C3[6] * x * (xx - 3 * yy)]
    return torch.stack(out, -1)


def project(p: dict, view: View, W: int, H: int, sh_degree: int,
            prod: Products, antialiasing: bool = False) -> Projected:
    """Screen-space splats of the parameters ``p`` (pre-activation:
    ``xyz``, ``f_dc`` (N,3), ``f_rest`` (N,K-1,3), log ``scaling``,
    unnormalised quaternion ``rotation`` wxyz, logit ``opacity`` (N,));
    with ``antialiasing`` the opacity carries the EWA filter's
    compensation."""
    xyz = p["xyz"]
    n = xyz.shape[0]
    xh = torch.cat([xyz, torch.ones((n, 1), dtype=xyz.dtype,
                                    device=xyz.device)], 1)
    ph = prod.mm(xh, view.full_proj.T)
    pv = prod.mm(xh, view.world_view.T)
    pw = 1.0 / (ph[:, 3] + 1e-7)
    mean2d = torch.stack([((ph[:, 0] * pw + 1.0) * W - 1.0) * 0.5,
                          ((ph[:, 1] * pw + 1.0) * H - 1.0) * 0.5], -1)
    depth = pv[:, 2]

    m = quat_to_rotmat(p["rotation"]) * torch.exp(p["scaling"])[:, None, :]
    sigma = prod.mm(m, m.transpose(1, 2))                       # (N,3,3)
    fx, fy = W / (2.0 * view.tanfovx), H / (2.0 * view.tanfovy)
    tz = torch.where(depth.abs() < 1e-6, torch.full_like(depth, 1e-6), depth)
    itz = 1.0 / tz
    tx = torch.clamp(pv[:, 0] * itz, -1.3 * view.tanfovx,
                     1.3 * view.tanfovx) * depth
    ty = torch.clamp(pv[:, 1] * itz, -1.3 * view.tanfovy,
                     1.3 * view.tanfovy) * depth
    zero = torch.zeros_like(depth)
    jac = torch.stack([fx * itz, zero, -fx * tx * itz * itz,
                       zero, fy * itz, -fy * ty * itz * itz],
                      -1).reshape(n, 2, 3)
    t = prod.mm(jac, view.world_view[:3, :3])                   # (N,2,3)
    cov = prod.mm(prod.mm(t, sigma), t.transpose(1, 2))         # (N,2,2)
    c00 = cov[:, 0, 0] + DILATION
    c01 = cov[:, 0, 1]
    c11 = cov[:, 1, 1] + DILATION
    det = c00 * c11 - c01 * c01
    inv = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
    conic = torch.stack([c11 * inv, -c01 * inv, c00 * inv], -1)
    mid = 0.5 * (c00 + c11)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0)))

    opacity = torch.sigmoid(p["opacity"])
    if antialiasing:
        # the determinant's share that survives the dilation
        det0 = cov[:, 0, 0] * cov[:, 1, 1] - c01 * c01
        ratio = det0 / torch.where(det == 0, torch.ones_like(det), det)
        opacity = opacity * torch.sqrt(torch.clamp(ratio, min=AA_MIN_RATIO))
    level = torch.clamp(2.0 * torch.log(torch.clamp(opacity, min=1e-12)
                                        / ALPHA_MIN) + 1e-3, min=0.0)
    rx = torch.minimum(torch.ceil(torch.sqrt(level * c00.clamp(min=0.0))),
                       radius)
    ry = torch.minimum(torch.ceil(torch.sqrt(level * c11.clamp(min=0.0))),
                       radius)

    d = xyz - view.center[None, :]
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    feats = torch.cat([p["f_dc"][:, None, :], p["f_rest"]], 1)  # (N,K,3)
    k = (sh_degree + 1) ** 2
    basis = sh_basis(sh_degree, d)
    color = prod.mm(basis[:, None, :], feats[:, :k])[:, 0] + 0.5
    color = torch.clamp(color, min=0.0)

    visible = (depth > Z_NEAR_CULL) & (det > 0)
    tight = visible & (level > 0)
    radius = torch.where(visible, radius, zero)
    rx = torch.where(tight, rx, zero)
    ry = torch.where(tight, ry, zero)
    safe = torch.where(depth == 0, torch.ones_like(depth), depth)
    invdepth = torch.where(depth > Z_NEAR_CULL, 1.0 / safe, zero)
    return Projected(mean2d, depth, conic, opacity, color, invdepth,
                     radius, rx, ry)


class Bins(NamedTuple):
    """Every (tile, splat) pair, sorted by tile and then front to back."""
    splat: torch.Tensor       # (M,) splat index of each pair
    tile_start: torch.Tensor  # (T,) first pair of each tile
    tile_count: torch.Tensor  # (T,)
    n_tiles_x: int
    n_tiles_y: int


def bin_splats(pr: Projected, W: int, H: int, tile: int = 32) -> Bins:
    """The pairs of every splat with the tiles of its rectangle
    [floor((m - r)/t), floor((m + r + t - 1)/t)) on each axis, r the
    binning half-extent; ties in depth keep the splats' order."""
    ntx, nty = -(-W // tile), -(-H // tile)
    mean2d, rx, ry = pr.mean2d.detach(), pr.rx.detach(), pr.ry.detach()
    dev = mean2d.device
    n = mean2d.shape[0]

    def lo_hi(m, r, cap):
        lo = torch.clamp(torch.floor((m - r) / tile), 0, cap).long()
        hi = torch.clamp(torch.div(m + r + tile - 1, tile,
                                   rounding_mode="floor"), 0, cap).long()
        return lo, torch.clamp(hi - lo, min=0)

    x0, w = lo_hi(mean2d[:, 0], rx, ntx)
    y0, h = lo_hi(mean2d[:, 1], ry, nty)
    ok = (pr.radius > 0) & (rx > 0) & (ry > 0)
    w = torch.where(ok, w, 0)
    counts = w * torch.where(ok, h, 0)
    rank = torch.empty(n, dtype=torch.long, device=dev)
    rank[torch.sort(pr.depth.detach(), stable=True).indices] = torch.arange(
        n, device=dev)
    g = torch.repeat_interleave(torch.arange(n, device=dev), counts)
    k = torch.arange(g.shape[0], device=dev) - (torch.cumsum(counts, 0)
                                                - counts)[g]
    wg = w[g]
    t = (y0[g] + k // wg) * ntx + x0[g] + k % wg
    order = torch.sort(t * n + rank[g]).indices
    t = t[order]
    count = torch.bincount(t, minlength=ntx * nty)
    return Bins(g[order], torch.cumsum(count, 0) - count, count, ntx, nty)


def pack(pr: Projected) -> torch.Tensor:
    """(N, 10) per-splat rows the compositor reads: mean (2), conic (3),
    opacity, colour (3), inverse depth."""
    return torch.cat([pr.mean2d, pr.conic, pr.opacity[:, None], pr.color,
                      pr.invdepth[:, None]], 1)


class Walk:
    """Front-to-back compositing of every tile, all tiles one chunk of G
    pairs at a time (a tile drops out when its list ends or all its pixels
    have stopped). ``forward`` keeps what ``backward`` needs to run each
    chunk again under autograd, last chunk first."""

    def __init__(self, rows: torch.Tensor, bins: Bins, prod: Products,
                 tile: int = 32, chunk: int = 64):
        """``rows``: (M, 10) the packed row of each pair, in ``bins``'
        order."""
        dev = rows.device
        self.rows, self.bins, self.prod = rows, bins, prod
        self.G, self.P = chunk, tile * tile
        self.T = bins.n_tiles_x * bins.n_tiles_y
        p = torch.arange(self.P, device=dev)
        self.px, self.py = (p % tile).float(), (p // tile).float()
        tid = torch.arange(self.T, device=dev)
        self.ox = ((tid % bins.n_tiles_x) * tile).float()
        self.oy = ((tid // bins.n_tiles_x) * tile).float()
        self.g = torch.arange(chunk, device=dev)
        self.start, self.count = bins.tile_start, bins.tile_count
        self.n_chunks = -(-self.count // chunk)
        self.tile = tile

    def chunk(self, rows, j, idx, t_in, done_in):
        """One chunk of the tiles ``idx``: (colour and inverse-depth sums
        (L,4,P), transmittance after (L,P), stopped after (L,P), 1 + rank
        of each pixel's last contributor in it (L,P), contributing pairs
        (L,G,P) bool)."""
        rank = j * self.G + self.g
        valid = rank[None, :] < self.count[idx, None]
        at = torch.clamp(self.start[idx, None] + rank[None, :],
                         max=rows.shape[0] - 1)
        d = rows[at]                                            # (L,G,10)
        dx = self.px - (d[..., 0:1] - self.ox[idx, None, None])
        dy = self.py - (d[..., 1:2] - self.oy[idx, None, None])
        power = (-0.5 * (d[..., 2:3] * dx * dx + d[..., 4:5] * dy * dy)
                 - d[..., 3:4] * dx * dy)
        raw = d[..., 5:6] * torch.exp(torch.clamp(power, max=0.0))
        alpha = raw - (raw - ALPHA_MAX).clamp(min=0.0).detach()
        live = valid[..., None] & (alpha >= ALPHA_MIN) & (power <= 0.0)
        a1 = torch.where(live, alpha, torch.zeros_like(alpha))
        t0 = t_in[:, None, :]
        one = torch.ones_like(t0)
        cum = torch.cumprod(1.0 - a1, 1)
        test = t0 * torch.cat([one, cum[:, :-1]], 1) * (1.0 - a1)
        cross = (a1 > 0) & (test < T_EPS)
        stopped = done_in[:, None, :] | (torch.cumsum(cross.int(), 1) > 0)
        contrib = (a1 > 0) & ~stopped
        a2 = torch.where(contrib, a1, torch.zeros_like(a1))
        cum2 = torch.cumprod(1.0 - a2, 1)
        wgt = t0 * torch.cat([one, cum2[:, :-1]], 1) * a2        # (L,G,P)
        acc = self.prod.mm(wgt.transpose(1, 2), d[..., 6:10]).transpose(1, 2)
        last = torch.where(contrib, (rank + 1)[None, :, None], 0).amax(1)
        return (acc, t_in * cum2[:, -1], done_in | cross.any(1), last,
                contrib)

    @torch.no_grad()
    def forward(self, keep: bool = False):
        """(accum (T,4,P), final transmittance (T,P), n_contrib (T,P),
        count of contributing pairs, per-tile largest n_contrib)."""
        dev = self.rows.device
        T, P = self.T, self.P
        accum = torch.zeros((T, 4, P), device=dev)
        t_run = torch.ones((T, P), device=dev)
        done = torch.zeros((T, P), dtype=torch.bool, device=dev)
        nc = torch.zeros((T, P), dtype=torch.long, device=dev)
        hits = torch.zeros((), dtype=torch.long, device=dev)
        self.saved = []
        j = 0
        while True:
            idx = torch.nonzero((self.n_chunks > j) & ~done.all(1)).squeeze(1)
            if idx.numel() == 0:
                break
            t_in, d_in = t_run[idx], done[idx]
            if keep:
                self.saved.append((j, idx, t_in, d_in))
            acc, t_out, d_out, last, contrib = self.chunk(self.rows, j, idx,
                                                          t_in, d_in)
            accum[idx] += acc
            t_run[idx] = t_out
            done[idx] = d_out
            nc[idx] = torch.maximum(nc[idx], last)
            hits += contrib.sum()
            j += 1
        return accum, t_run, nc, int(hits), nc.amax(1)

    def backward(self, d_accum: torch.Tensor, d_t: torch.Tensor):
        """The gradient of the rows from those of accum (T,4,P) and of the
        final transmittance (T,P): accum is a sum over chunks, so every
        chunk sees d_accum; the transmittance's gradient runs back through
        the chunks."""
        rows = self.rows.detach().requires_grad_()
        d_t = d_t.clone()
        for j, idx, t_in, d_in in reversed(self.saved):
            t_leaf = t_in.clone().requires_grad_()
            with torch.enable_grad():
                acc, t_out, _, _, _ = self.chunk(rows, j, idx, t_leaf, d_in)
                torch.autograd.backward([acc, t_out],
                                        [d_accum[idx], d_t[idx]])
            d_t[idx] = t_leaf.grad
        self.saved = []
        return rows.grad if rows.grad is not None else torch.zeros_like(rows)


def tiles_to_image(x: torch.Tensor, bins: Bins, W: int, H: int,
                   tile: int = 32) -> torch.Tensor:
    """(T, C, P) -> (C, H, W)."""
    c = x.shape[1]
    img = x.reshape(bins.n_tiles_y, bins.n_tiles_x, c, tile, tile)
    img = img.permute(2, 0, 3, 1, 4).reshape(c, bins.n_tiles_y * tile,
                                             bins.n_tiles_x * tile)
    return img[:, :H, :W]


def image_to_tiles(img: torch.Tensor, bins: Bins, tile: int = 32):
    """(C, H, W) -> (T, C, P), zero outside the image."""
    c, H, W = img.shape
    full = img.new_zeros((c, bins.n_tiles_y * tile, bins.n_tiles_x * tile))
    full[:, :H, :W] = img
    x = full.reshape(c, bins.n_tiles_y, tile, bins.n_tiles_x, tile)
    return x.permute(1, 3, 0, 2, 4).reshape(-1, c, tile * tile)


class Frame(NamedTuple):
    image: torch.Tensor      # (3, H, W) clamped to [0, 1]
    invdepth: torch.Tensor   # (1, H, W)
    radius: torch.Tensor     # (N,)
    t_final: torch.Tensor    # (T, P)
    pairs: int               # (tile, splat) pairs
    contributing: int        # (pair, pixel) contributions
    bwd_rows: int            # pairs up to each tile's last contributor


def expose(raw: torch.Tensor, exposure: torch.Tensor, prod: Products):
    """The exposure affine (3, 4) on a raw (3, H, W) image: colour k is
    sum_c raw_c E[c, k] + E[k, 3], as the 3DGS renderer applies it."""
    return (prod.mm(raw.permute(1, 2, 0), exposure[:3, :3]).permute(2, 0, 1)
            + exposure[:3, 3, None, None])


@full_f32()
def render(p: dict, view: View, W: int, H: int, bg: torch.Tensor,
           sh_degree: int, prod: Products, *, with_grad: bool = False,
           d_image_fn=None, mean2d_grad: bool = False,
           exposure: Optional[torch.Tensor] = None,
           antialiasing: bool = False):
    """One frame; with ``exposure`` (3, 4) its affine applied to the raw
    image before the clamp, with ``antialiasing`` the EWA filter. Without
    ``with_grad``: a ``Frame``. With it, ``d_image_fn(image, invdepth) ->
    (value, d image, d invdepth or None)`` gives the loss and its gradients
    at the clamped image and at the inverse depth, and the result is
    (Frame, value, the gradients of ``p``'s leaves by key); with
    ``exposure`` also its gradient under ``"exposure"``; with
    ``mean2d_grad`` also that of the splats' screen-space means in pixels,
    (N, 2), under ``"mean2d"``."""
    with torch.set_grad_enabled(with_grad):
        pr = project(p, view, W, H, sh_degree, prod, antialiasing)
        rows = pack(pr)
    bins = bin_splats(pr, W, H)
    walk = Walk(rows.detach()[bins.splat], bins, prod)
    accum, t_final, nc, hits, nc_max = walk.forward(keep=with_grad)
    raw = tiles_to_image(accum[:, :3], bins, W, H) + tiles_to_image(
        t_final[:, None], bins, W, H) * bg[:, None, None]
    image = torch.clamp(raw if exposure is None
                        else expose(raw, exposure.detach(), prod), 0.0, 1.0)
    frame = Frame(image, tiles_to_image(accum[:, 3:4], bins, W, H),
                  pr.radius.detach(), t_final, int(bins.splat.shape[0]),
                  hits, int(torch.minimum(bins.tile_count, nc_max).sum()))
    if not with_grad:
        return frame
    raw_leaf = raw.detach().requires_grad_()
    seen = [raw_leaf]
    shown = raw_leaf
    if exposure is not None:
        seen.append(exposure.detach().requires_grad_())
        shown = expose(raw_leaf, seen[1], prod)
    value, d_img, d_inv = d_image_fn(torch.clamp(shown, 0.0, 1.0),
                                     frame.invdepth)
    d_shown = torch.autograd.grad(torch.clamp(shown, 0.0, 1.0), seen, d_img)
    d_raw = d_shown[0]
    d_accum = torch.zeros_like(accum)
    d_accum[:, :3] = image_to_tiles(d_raw, bins)
    if d_inv is not None:
        d_accum[:, 3:4] = image_to_tiles(d_inv, bins)
    d_t = image_to_tiles((d_raw * bg[:, None, None]).sum(0, keepdim=True),
                         bins)[:, 0]
    d_pairs = walk.backward(d_accum, d_t)
    d_rows = torch.zeros_like(rows).index_add_(0, bins.splat, d_pairs)
    leaves = [v for v in p.values() if v.requires_grad]
    grads = torch.autograd.grad(rows, leaves, d_rows, allow_unused=True)
    out = {k: (torch.zeros_like(v) if gr is None else gr)
           for (k, v), gr in zip(((k, v) for k, v in p.items()
                                  if v.requires_grad), grads)}
    if exposure is not None:
        out["exposure"] = d_shown[1]
    if mean2d_grad:
        out["mean2d"] = d_rows[:, :2]
    return frame, value, out
