"""The cases the fused preprocess kernels are held to the plain path on,
shared by tests/test_torch_preprocess_packed.py (the kernels' sources built
for the host) and tests/test_torch_cuda.py (the card)."""
import numpy as np
import torch

from gsplat_tpu_torch.core.camera import CameraView
from gsplat_tpu_torch.models import gaussian_model as gm

W, H = 96, 64
# (SH degree, active degree, antialiasing): degrees 0-3, the active degree
# at 0, one below the maximum and the maximum
CASES = [(deg, ad, aa) for deg in range(4)
         for ad in sorted({0, max(deg - 1, 0), deg}) for aa in (False, True)]
CASE_IDS = [f"sh{d}-active{a}-{'aa' if x else 'noaa'}" for d, a, x in CASES]


def scene(deg=3, active_deg=None, n=300, seed=0, device="cpu"):
    """Random gaussians in front of a camera at the origin, made with numpy,
    about 10% of them dead rows. Rows 0-6 are edge cases: at the camera
    centre, before the near plane, behind the camera, past the tanfov clamp
    (two), colours clamped at 0, and a 2-D covariance that overflows (its
    determinant NaN, so culled)."""
    rng = np.random.default_rng(seed)
    K = (deg + 1) ** 2
    xyz = rng.standard_normal((n, 3)).astype(np.float32)
    xyz[:, 2] += 5.0
    a = dict(xyz=xyz,
             f_dc=rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32),
             f_rest=(0.3 * rng.standard_normal((n, K - 1, 3))).astype(
                 np.float32),
             scaling=rng.uniform(-2.5, -1.0, (n, 3)).astype(np.float32),
             rotation=rng.standard_normal((n, 4)).astype(np.float32),
             opacity=rng.uniform(-3.0, 3.0, n).astype(np.float32),
             active=rng.uniform(size=n) > 0.1,
             active_sh_degree=deg if active_deg is None else active_deg)
    a["xyz"][0] = 0.0                          # at the camera centre
    a["xyz"][1] = [0.1, 0.1, 0.1]              # before the near plane
    a["xyz"][2] = [1.0, 0.5, -2.0]             # behind the camera
    a["xyz"][3] = [20.0, 0.0, 5.0]             # past the tanfov clamp
    a["xyz"][4] = [0.0, -30.0, 6.0]
    a["f_dc"][5] = -5.0                        # colour clamped at 0
    a["scaling"][6] = [30.0, 30.0, -30.0]      # c00 c11 overflows: det NaN
    return (gm.from_numpy(a, device=device),
            CameraView.create(np.eye(3), np.zeros(3), 0.9, 0.7,
                              device=device))


def same(a, b):
    """Bit for bit, NaN where NaN."""
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def with_leaves(g):
    leaves = {k: getattr(g, k).clone().requires_grad_()
              for k in gm.TRAINABLE_FIELDS}
    return gm.with_trainables(g, leaves), leaves
