"""Port parity of LPIPS (gsplat_tpu_torch/ops/lpips.py against
gsplat_tpu/ops/lpips.py) on the CPU, with random weights made by the
recipe of tests/test_lpips.py:31-43 (``lpips.random_weights``) into the
npz that ``GSPLAT_LPIPS_WEIGHTS`` names: the distance of a 64x64 pair
within rel 1e-5 / abs 1e-6 of JAX's (the gate tests/test_lpips.py holds
JAX's LPIPS to against its torch oracle), the distance of an image to
itself below 1e-7, and ``FileNotFoundError`` without the file."""
import numpy as np
import pytest
import torch

from gsplat_tpu.ops import lpips as jlpips
from gsplat_tpu_torch.ops import lpips as tlpips


@pytest.fixture
def weights(tmp_path, rng, monkeypatch):
    path = tmp_path / "lpips_random.npz"
    np.savez(path, **tlpips.random_weights(rng))
    monkeypatch.setenv("GSPLAT_LPIPS_WEIGHTS", str(path))
    return path


def test_random_weights_follow_the_jax_suite_recipe(rng):
    from test_lpips import _random_weights
    w = tlpips.random_weights(np.random.default_rng(5))
    convs, lins = _random_weights(np.random.default_rng(5))
    for i, (cw, cb) in enumerate(convs):
        assert np.array_equal(w[f"conv{i}_w"], cw)
        assert np.array_equal(w[f"conv{i}_b"], cb)
    for j, lin in enumerate(lins):
        assert np.array_equal(w[f"lin{j}"], lin)


def test_lpips_matches_jax(weights, rng):
    x = rng.uniform(0, 1, (1, 3, 64, 64)).astype(np.float32)
    y = np.clip(x + 0.1 * rng.standard_normal(x.shape).astype(np.float32),
                0, 1)
    jfn = jlpips.lpips_vgg()
    want = float(jfn(x, y))
    fn = tlpips.lpips_vgg(device="cpu")
    got = float(fn(torch.tensor(x), torch.tensor(y)))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-6)
    assert abs(float(fn(torch.tensor(x), torch.tensor(x)))) < 1e-7


@pytest.mark.parametrize("env", ["unset", "missing"])
def test_missing_weights_raise(env, tmp_path, monkeypatch):
    if env == "unset":
        monkeypatch.delenv("GSPLAT_LPIPS_WEIGHTS", raising=False)
    else:
        monkeypatch.setenv("GSPLAT_LPIPS_WEIGHTS", str(tmp_path / "no.npz"))
    with pytest.raises(FileNotFoundError, match="GSPLAT_LPIPS_WEIGHTS"):
        tlpips.lpips_vgg(device="cpu")
