"""Port parity: every Preprocessed field and the gradients through them,
with and without antialiasing, cov3d_precomp and colors_precomp. Fields
within rtol 1e-5 / atol 1e-6, gradients within rtol 1e-5 / atol 1e-5 of
their largest entry; the integer-valued radius/rx/ry (ceil of a float)
equal on ≥ 99.9% of gaussians and off by at most 1 elsewhere."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsplat_tpu.ops import preprocess as jpre
from gsplat_tpu_torch.ops import preprocess as tpre

from torch_parity import make_scene, port_scene, t2n

TOL = dict(rtol=1e-5, atol=1e-6)
FLOAT_FIELDS = ("mean2d", "depth", "conic", "color", "opacity", "invdepth",
                "t_cut")
INT_FIELDS = ("radius", "rx", "ry")
W, H = 256, 96


def _inputs(g, rng, variant):
    """Differentiable preprocess inputs as numpy (activated params, plus the
    precomputed covariance / colors for those variants)."""
    x = dict(xyz=g.xyz, scaling=g.get_scaling(), rotation=g.get_rotation(),
             opacity=g.get_opacity(), features=g.get_features())
    x = {k: np.asarray(v) for k, v in x.items()}
    if variant == "cov3d_precomp":
        x["cov3d_precomp"] = np.asarray(g.get_covariance())
    if variant == "colors_precomp":
        x["colors_precomp"] = rng.uniform(0, 1, (g.capacity, 3)).astype(
            np.float32)
    return x


@pytest.mark.parametrize("variant", ["plain", "antialiasing", "cov3d_precomp",
                                     "colors_precomp"])
def test_preprocess_fields_and_grads_match_jax(rng, variant):
    g, cam = make_scene(rng, n=250, cap=300, sh_degree=2)
    _, tcam = port_scene(g, cam)
    x = _inputs(g, rng, variant)
    aa = variant == "antialiasing"
    kw = dict(active_mask=g.active, antialiasing=aa)
    deg = int(g.active_sh_degree)

    @jax.jit
    def jax_pre(xs):
        return jpre.preprocess(
            xs["xyz"], xs["scaling"], xs["rotation"], xs["opacity"],
            xs["features"], deg, cam, W, H,
            cov3d_precomp=xs.get("cov3d_precomp"),
            colors_precomp=xs.get("colors_precomp"), **kw)

    def torch_pre(xs):
        return tpre.preprocess(
            xs["xyz"], xs["scaling"], xs["rotation"], xs["opacity"],
            xs["features"], deg, tcam, W, H,
            active_mask=torch.tensor(np.asarray(g.active)), antialiasing=aa,
            cov3d_precomp=xs.get("cov3d_precomp"),
            colors_precomp=xs.get("colors_precomp"))

    pj = jax_pre({k: jnp.asarray(v) for k, v in x.items()})
    xt = {k: torch.tensor(v, requires_grad=True) for k, v in x.items()}
    pt = torch_pre(xt)

    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(t2n(getattr(pt, f)),
                                   np.asarray(getattr(pj, f)),
                                   err_msg=f, **TOL)
    for f in INT_FIELDS:
        a, b = t2n(getattr(pt, f)), np.asarray(getattr(pj, f))
        assert np.abs(a - b).max() <= 1, f
        assert (a == b).mean() >= 0.999, f
    assert (t2n(pt.radius) > 0).sum() > 100       # the scene is on screen

    # gradients of a random linear functional of every float field
    weights = {f: rng.standard_normal(np.asarray(getattr(pj, f)).shape)
               .astype(np.float32) for f in FLOAT_FIELDS}

    def jax_loss(xs):
        p = jax_pre(xs)
        return sum(jnp.sum(jnp.asarray(weights[f]) * getattr(p, f))
                   for f in FLOAT_FIELDS)

    gj = jax.jit(jax.grad(jax_loss))({k: jnp.asarray(v) for k, v in x.items()})
    loss = sum((torch.tensor(weights[f]) * getattr(pt, f)).sum()
               for f in FLOAT_FIELDS)
    loss.backward()
    for k in x:
        got = (np.zeros_like(x[k]) if xt[k].grad is None
               else t2n(xt[k].grad))
        want = np.asarray(gj[k])
        # each gradient sums the cotangents of seven fields, associated
        # differently by XLA's fused backward and by autograd: cancellation
        # leaves absolute errors up to a few 1e-6 of the array's largest
        # entry, so atol is 1e-5 of that scale
        np.testing.assert_allclose(got, want, rtol=TOL["rtol"],
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"d/d{k}")
