"""The port's COLMAP conversion CLI (gsplat_tpu_torch/cli/convert.py, an
own copy) against gsplat_tpu/cli/convert.py, with ``subprocess.run``
replaced by a recorder that writes the outputs each COLMAP stage would:
the same argument lists, the same ``sparse/0`` layout and the same image
pyramids, for the full pipeline (PIL's resize, and ImageMagick's through a
given executable) and for ``--skip_matching --no_gpu`` (the cases of
tests/test_cli.py:273 and :310, which are ``slow`` there)."""
import os
import shutil
import subprocess

import numpy as np
import pytest

from gsplat_tpu.cli import convert as jconvert
from gsplat_tpu_torch.cli import convert as tconvert


def _arg(cmd, flag):
    return cmd[cmd.index(flag) + 1]


def _fake_run(calls):
    """subprocess.run that records each argument list and fabricates the
    files the next stage reads."""
    def run(cmd, *a, **kw):
        calls.append(list(cmd))
        stage = cmd[1]
        if stage == "feature_extractor":
            open(_arg(cmd, "--database_path"), "wb").close()
        elif stage == "mapper":
            out = os.path.join(_arg(cmd, "--output_path"), "0")
            os.makedirs(out, exist_ok=True)
            for n in ("cameras.bin", "images.bin", "points3D.bin"):
                open(os.path.join(out, n), "wb").close()
        elif stage == "image_undistorter":
            out = _arg(cmd, "--output_path")
            os.makedirs(os.path.join(out, "sparse"), exist_ok=True)
            for n in ("cameras.bin", "images.bin", "points3D.bin"):
                open(os.path.join(out, "sparse", n), "wb").close()
            shutil.copytree(_arg(cmd, "--image_path"),
                            os.path.join(out, "images"))
        return subprocess.CompletedProcess(cmd, 0)
    return run


def _source(src, W=16, H=12, n=3):
    from PIL import Image
    os.makedirs(os.path.join(src, "input"))
    rng = np.random.default_rng(7)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (H, W, 3)).astype(np.uint8)) \
            .save(os.path.join(src, "input", f"im_{i}.png"))


def _tree(root):
    """Every file under root with its size in bytes, or its image size."""
    from PIL import Image
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            key = os.path.relpath(p, root)
            if f.endswith(".png"):
                with Image.open(p) as im:
                    out[key] = im.size
            else:
                out[key] = os.path.getsize(p)
    return out


@pytest.mark.parametrize("flags", [
    ["--resize"],
    ["--resize", "--magick_executable", "magick"],
    ["--skip_matching", "--no_gpu"],
    ["--no_gpu", "--camera", "PINHOLE"],
], ids=["full-pil", "full-magick", "skip-matching-no-gpu", "no-gpu"])
def test_convert_matches_jax(flags, tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    src = str(tmp_path / "scene")
    results = []
    for mod in (jconvert, tconvert):
        if os.path.exists(src):
            shutil.rmtree(src)
        _source(src)
        if "--skip_matching" in flags:    # a prior reconstruction
            os.makedirs(os.path.join(src, "distorted", "sparse", "0"))
        calls = []
        monkeypatch.setattr(subprocess, "run", _fake_run(calls))
        mod.main(["--source_path", src, "--colmap_executable", "colmap",
                  *flags])
        results.append((calls, _tree(src)))
    (jcalls, jtree), (tcalls, ttree) = results
    assert tcalls == jcalls
    assert ttree == jtree
    assert sorted(os.listdir(os.path.join(src, "sparse"))) == ["0"]
    assert sorted(os.listdir(os.path.join(src, "sparse", "0"))) == [
        "cameras.bin", "images.bin", "points3D.bin"]
    stages = [c[1] for c in tcalls]
    if "--skip_matching" in flags:
        assert stages == ["image_undistorter"]
    else:
        assert stages[:4] == ["feature_extractor", "exhaustive_matcher",
                              "mapper", "image_undistorter"]
        gpu = "0" if "--no_gpu" in flags else "1"
        assert _arg(tcalls[0], "--SiftExtraction.use_gpu") == gpu
    if "--magick_executable" in flags:
        assert stages[4:] == ["mogrify"] * 9
    elif "--resize" in flags:
        for div, size in ((2, (8, 6)), (4, (4, 3)), (8, (2, 2))):
            assert ttree[os.path.join(f"images_{div}", "im_0.png")] == size
    else:
        assert not os.path.exists(os.path.join(src, "images_2"))
