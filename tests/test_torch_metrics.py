"""Port parity of the metrics CLI (gsplat_tpu_torch/cli/metrics.py against
gsplat_tpu/cli/metrics.py) on the CPU: the same directory of PNGs through
JAX's ``main`` and the port's ``--device cpu`` gives ``results.json`` and
``per_view.json`` with the same keys, SSIM and PSNR within rel 1e-5, and
LPIPS within rel 1e-5 with random weights (NaN in both without them). A
scene without ``test/`` is reported and skipped; an error raised inside a
metric, or by a weights file that is there but broken, is not swallowed."""
import json
import math

import numpy as np
import pytest

from gsplat_tpu.cli import metrics as jmetrics
from gsplat_tpu_torch.cli import metrics as tmetrics
from gsplat_tpu_torch.ops import lpips as tlpips


def _model(root, rng, methods=("ours_7", "ours_30"), n=2, H=48, W=64):
    """A model directory of render / gt PNG pairs per method."""
    from PIL import Image
    for m in methods:
        rdir = root / "test" / m / "renders"
        gdir = root / "test" / m / "gt"
        rdir.mkdir(parents=True)
        gdir.mkdir(parents=True)
        for i in range(n):
            a = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
            b = np.clip(a + rng.integers(-20, 20, a.shape), 0, 255).astype(
                np.uint8)
            Image.fromarray(a).save(rdir / f"{i:05d}.png")
            Image.fromarray(b).save(gdir / f"{i:05d}.png")
    return root


def _read(root):
    with open(root / "results.json") as f, open(root / "per_view.json") as g:
        return json.load(f), json.load(g)


def _close(a, b):
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return a == pytest.approx(b, rel=1e-5)


@pytest.mark.parametrize("lpips", ["random weights", "no weights"])
def test_metrics_cli_matches_jax(lpips, tmp_path, rng, monkeypatch):
    if lpips == "random weights":
        w = tmp_path / "w.npz"
        np.savez(w, **tlpips.random_weights(rng))
        monkeypatch.setenv("GSPLAT_LPIPS_WEIGHTS", str(w))
    else:
        monkeypatch.delenv("GSPLAT_LPIPS_WEIGHTS", raising=False)
    model = _model(tmp_path / "model", rng)
    jmetrics.main(["-m", str(model)])
    want = _read(model)
    tmetrics.main(["-m", str(model), "--device", "cpu"])
    got = _read(model)
    for g, w_ in zip(got, want):
        assert g.keys() == w_.keys() == {"ours_7", "ours_30"}
        for method in g:
            assert g[method].keys() == w_[method].keys() == {
                "SSIM", "PSNR", "LPIPS"}
    (res, per_view), (jres, jper_view) = got, want
    for method in res:
        for k in ("SSIM", "PSNR", "LPIPS"):
            assert _close(res[method][k], jres[method][k]), (method, k)
            assert per_view[method][k].keys() == jper_view[method][k].keys()
            for view, v in per_view[method][k].items():
                assert _close(v, jper_view[method][k][view]), (method, k)
    lp = res["ours_7"]["LPIPS"]
    assert (math.isfinite(lp) and lp > 0) if lpips == "random weights" \
        else math.isnan(lp)


def test_scene_without_test_dir_is_reported_and_skipped(tmp_path, rng,
                                                       capsys, monkeypatch):
    monkeypatch.delenv("GSPLAT_LPIPS_WEIGHTS", raising=False)
    empty = tmp_path / "empty"
    empty.mkdir()
    model = _model(tmp_path / "model", rng, methods=("ours_7",), n=1)
    tmetrics.main(["-m", str(empty), str(model), "--device", "cpu"])
    assert f"Unable to compute metrics for model {empty}" in \
        capsys.readouterr().out
    assert not (empty / "results.json").exists()
    res, _ = _read(model)
    assert math.isfinite(res["ours_7"]["SSIM"])


def test_metric_errors_are_not_swallowed(tmp_path, rng, monkeypatch):
    from gsplat_tpu_torch.ops import losses

    monkeypatch.delenv("GSPLAT_LPIPS_WEIGHTS", raising=False)
    model = _model(tmp_path / "model", rng, methods=("ours_7",), n=1)

    def broken_ssim(*a, **kw):
        raise RuntimeError("kernel failure")
    monkeypatch.setattr(losses, "ssim", broken_ssim)
    with pytest.raises(RuntimeError, match="kernel failure"):
        tmetrics.main(["-m", str(model), "--device", "cpu"])
    assert not (model / "results.json").exists()


def test_broken_weights_file_raises(tmp_path, rng, monkeypatch):
    w = tmp_path / "w.npz"
    np.savez(w, lin0=np.ones(64, np.float32))      # no conv weights
    monkeypatch.setenv("GSPLAT_LPIPS_WEIGHTS", str(w))
    model = _model(tmp_path / "model", rng, methods=("ours_7",), n=1)
    with pytest.raises(KeyError):
        tmetrics.main(["-m", str(model), "--device", "cpu"])
