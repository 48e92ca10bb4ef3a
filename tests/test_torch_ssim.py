"""Port parity of SSIM. The plain PyTorch ``ssim``/``ssim_map``/``fast_ssim``
(the CPU route and the oracle of the CUDA kernels) against JAX's ``ssim``
and ``ssim_map`` and against its fused Pallas kernel ``ssim_fused`` in
interpret mode, on identical numpy inputs: values within rtol 1e-5 /
atol 1e-6, img1 gradients within rtol 2e-4 / atol 1e-6
(tests/test_train.py's gate for the fused kernel), under the mean's
uniform cotangent and a non-uniform one.

At a pixel whose variance is exactly 0 (a constant window), the port's
clamp passes no gradient, as the fused kernels' mask [v > 0] does; JAX's
XLA form (``jnp.maximum``) passes half. That case is held to the fused
kernel."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsplat_tpu.ops import ssim as jssim
from gsplat_tpu.ops.pallas.ssim_kernel import _Static, ssim_map_fused
from gsplat_tpu_torch.ops import losses
from gsplat_tpu_torch.ops import ssim as tssim
from gsplat_tpu_torch.ops.kernels import ssim as kssim

from torch_parity import t2n

VAL_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=1e-6)
SHAPE = (3, 37, 53)
_ST = _Static(window_size=11, sigma=1.5, c1=0.01 ** 2, c2=0.03 ** 2,
              interpret=True)


@jax.jit
def _jax_ref(a, b, wts):
    """JAX XLA form: mean SSIM, map, and img1 grads of the mean and of the
    map weighted by wts."""
    return (jssim.ssim(a, b), jssim.ssim_map(a, b),
            jax.grad(lambda x: jssim.ssim(x, b))(a),
            jax.grad(lambda x: jnp.sum(jssim.ssim_map(x, b) * wts))(a))


@jax.jit
def _jax_fused(a, b, wts):
    """The Pallas fused kernel (interpret mode): the same four."""
    return (jnp.mean(ssim_map_fused(a, b, _ST)), ssim_map_fused(a, b, _ST),
            jax.grad(lambda x: jnp.mean(ssim_map_fused(x, b, _ST)))(a),
            jax.grad(lambda x: jnp.sum(ssim_map_fused(x, b, _ST) * wts))(a))


def _images(rng, zero_patch=False):
    a = rng.uniform(0, 1, SHAPE).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(SHAPE).astype(np.float32),
                0, 1)
    if zero_patch:       # windows wholly inside: blur x² − mu1² == 0 exactly
        a[:, 4:24, 6:30] = 0.0
    wts = rng.uniform(0, 1, SHAPE).astype(np.float32)
    return a, b, wts


def _port(a, b, wts, map_fn):
    """The port's four, through map_fn (plain ssim_map or the dispatch)."""
    x1 = torch.tensor(a, requires_grad=True)
    x2 = torch.tensor(a, requires_grad=True)
    bt = torch.tensor(b)
    mean = map_fn(x1, bt).mean()
    m = map_fn(x2, bt)
    mean.backward()
    (m * torch.tensor(wts)).sum().backward()
    return t2n(mean), t2n(m), t2n(x1.grad), t2n(x2.grad)


def _assert_four(got, want):
    for i, name in enumerate(("ssim", "map", "grad of mean",
                              "grad of weighted map")):
        tol = VAL_TOL if i < 2 else GRAD_TOL
        np.testing.assert_allclose(got[i], np.asarray(want[i]), err_msg=name,
                                   **tol)


@pytest.mark.parametrize("route", ["plain", "dispatch"])
def test_ssim_matches_jax_and_fused_kernel(rng, route):
    a, b, wts = _images(rng)
    map_fn = tssim.ssim_map if route == "plain" else kssim.ssim_map_fused
    got = _port(a, b, wts, map_fn)
    args = tuple(map(jnp.asarray, (a, b, wts)))
    _assert_four(got, _jax_ref(*args))
    _assert_four(got, _jax_fused(*args))
    np.testing.assert_allclose(t2n(tssim.ssim(torch.tensor(a),
                                              torch.tensor(b))),
                               got[0], rtol=1e-6)


def test_variance_clamp_matches_fused_kernel(rng):
    a, b, wts = _images(rng, zero_patch=True)
    at = torch.tensor(a)
    v = tssim._blur(at * at, 11, 1.5) - tssim._blur(at, 11, 1.5) ** 2
    assert int((v == 0).sum()) > 100                  # the clamp is hit
    got = _port(a, b, wts, tssim.ssim_map)
    _assert_four(got, _jax_fused(*map(jnp.asarray, (a, b, wts))))


def test_fast_ssim_treats_img2_as_constant(rng):
    a, b, _ = _images(rng)
    x = torch.tensor(a, requires_grad=True)
    y = torch.tensor(b, requires_grad=True)
    v = losses.fast_ssim(x, y)
    v.backward()
    assert y.grad is None and x.grad.abs().max() > 0
    want = float(jssim.fast_ssim(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(float(v.detach()), want, **VAL_TOL)
    with pytest.raises(ValueError, match="window_size 11"):
        losses.fast_ssim(x, y, window_size=7)
    with pytest.raises(ValueError, match="CUDA"):
        kssim.ssim_fwd_cuda(x, y)               # CPU tensors: refused


def test_losses_match_jax(rng):
    from gsplat_tpu.ops import losses as jlosses
    a, b, _ = _images(rng)
    a4, b4 = a[None], b[None]
    for name, x, y in (("l1_loss", a, b), ("l2_loss", a, b), ("mse", a4, b4),
                       ("psnr", a4, b4)):
        got = getattr(losses, name)(torch.tensor(x), torch.tensor(y))
        want = getattr(jlosses, name)(jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-5,
                                   err_msg=name)


def test_ssim_matches_torch_reference(rng):
    """The port's SSIM against an independent implementation of the
    published SSIM (11x11 Gaussian window σ=1.5, C1=0.01², C2=0.03²,
    same-padded depthwise conv2d), in float32 on the CPU."""
    import torch.nn.functional as F

    def conv_ssim(img1, img2, window_size=11, sigma=1.5):
        C = img1.shape[0]
        xs = torch.arange(window_size, dtype=torch.float64)
        g = torch.exp(-((xs - window_size // 2) ** 2) / (2 * sigma ** 2))
        g = (g / g.sum()).float()
        win = (g[:, None] @ g[None, :]).expand(C, 1, window_size,
                                               window_size)
        pad = window_size // 2

        def blur(x):
            return F.conv2d(x[None], win, padding=pad, groups=C)[0]

        mu1, mu2 = blur(img1), blur(img2)
        s1 = blur(img1 * img1) - mu1 ** 2
        s2 = blur(img2 * img2) - mu2 ** 2
        s12 = blur(img1 * img2) - mu1 * mu2
        c1, c2 = 0.01 ** 2, 0.03 ** 2
        m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
            (mu1 ** 2 + mu2 ** 2 + c1) * (s1 + s2 + c2))
        return float(m.mean())

    a = rng.uniform(0, 1, (3, 40, 56)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal((3, 40, 56)).astype(np.float32),
                0, 1)
    ours = float(tssim.ssim(torch.from_numpy(a), torch.from_numpy(b)))
    want = conv_ssim(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(ours, want, rtol=2e-5, atol=2e-6)
