"""The port's PLY files (scene/ply.py) as ranks that share a scene see
them: a reader finds no file or the whole one, never a file another
process is still writing, and a cut file raises where it is read, both in
its header (which was read line by line until ``end_header``, forever on
a file cut inside it) and in its rows."""
import os
import threading

import numpy as np
import pytest

from gsplat_tpu_torch.scene import ply


def cloud(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)).astype(np.float32),
            rng.integers(0, 256, (n, 3)).astype(np.uint8))


@pytest.mark.parametrize("cut", ["header", "rows"])
def test_a_cut_file_raises(tmp_path, cut):
    path = str(tmp_path / "points3D.ply")
    ply.save_point_ply(path, *cloud(50, 0))
    raw = open(path, "rb").read()
    end = raw.index(b"end_header")
    open(path, "wb").write(raw[:end - 20] if cut == "header" else raw[:-7])
    with pytest.raises(ValueError):
        ply.load_point_ply(path)


def test_a_failed_write_leaves_no_file(tmp_path, monkeypatch):
    path = str(tmp_path / "points3D.ply")

    def refuse(src, dst):
        raise OSError("no room")
    monkeypatch.setattr(os, "replace", refuse)
    with pytest.raises(OSError):
        ply.save_point_ply(path, *cloud(50, 0))
    assert os.listdir(tmp_path) == []


def test_readers_racing_writers_see_whole_clouds(tmp_path):
    """Two writers put two clouds of different sizes at one path over and
    over, as ranks that each find no points3D.ply write it; a reader
    meanwhile loads the path again and again and gets one cloud whole each
    time."""
    path = str(tmp_path / "points3D.ply")
    clouds = [cloud(20_000, 1), cloud(30_000, 2)]
    ply.save_point_ply(path, *clouds[0])
    stop = threading.Event()

    def write(c):
        while not stop.is_set():
            ply.save_point_ply(path, *c)
    writers = [threading.Thread(target=write, args=(c,)) for c in clouds]
    for t in writers:
        t.start()
    seen = set()
    try:
        for _ in range(150):
            xyz, rgb = ply.load_point_ply(path)
            k = [i for i, (x, c) in enumerate(clouds)
                 if x.shape == xyz.shape and np.array_equal(x, xyz)
                 and np.array_equal(np.rint(rgb * 255).astype(np.uint8), c)]
            assert len(k) == 1
            seen.add(k[0])
    finally:
        stop.set()
        for t in writers:
            t.join()
    assert os.listdir(tmp_path) == ["points3D.ply"]
