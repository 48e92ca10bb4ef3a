"""The SIBR viewer bridge and rank 0's writes under camera data parallelism
(gsplat_tpu_torch/train/loop.py with ``parallel/mesh.py:Hold``), on 2 gloo
ranks on the CPU (tests/torch_dist_worker.py) whose collectives time out
after ``GROUP_TIMEOUT`` seconds.

Rank 0 alone serves the bridge and writes. Its client keeps training
paused at iteration 1 and keeps the last iteration alive; in a run with no
bridge its saves (at iteration 2 and at the last) are made slow: each for
``HOLD_S`` seconds, longer than the group's timeout. Rank 1 waits for rank 0 in the Hold each time, not in
a collective of the next step, so both ranks run to the end with equal
states, and rank 1 writes nothing.
"""
import json
import socket
import threading
import time

import numpy as np
import pytest

from test_torch_dp import _assert_ranks_equal
from test_torch_viewer import H, W, _payload, _recv_exact
from torch_parity import free_port, make_colmap_scene, spawn

GROUP_TIMEOUT = 5.0    # seconds a collective of the steps waits
HOLD_S = 6.0           # each of rank 0's waits outlasts it
ITERS = 3


def _client(port, frames):
    """Pause training for HOLD_S, train on one frame per iteration, keep the
    last iteration alive for HOLD_S, close."""
    deadline = time.monotonic() + 120
    while True:
        try:
            s = socket.create_connection(("127.0.0.1", port), timeout=120)
            break
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.02)

    def frame(train):
        # camera 0 of the scene: at (0, 0, -3), looking at the cloud
        data = json.dumps(_payload(np.eye(3), [0.0, 0.0, 3.0], train=train,
                                   keep_alive=True)).encode()
        s.sendall(len(data).to_bytes(4, "little") + data)
        _recv_exact(s, W * H * 3)
        _recv_exact(s, int.from_bytes(_recv_exact(s, 4), "little"))
        frames.append(train)

    with s:
        frame(False)                        # iteration 1's poll, paused
        end = time.monotonic() + HOLD_S
        while time.monotonic() < end:
            frame(False)
            time.sleep(0.05)
        # the first ends iteration 1's poll; the last comes in the last
        # iteration's, which keeps serving while the client asks
        for _ in range(ITERS):
            frame(True)
        end = time.monotonic() + HOLD_S
        while time.monotonic() < end:
            frame(True)
            time.sleep(0.05)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One group of 2 ranks for both jobs: the bridge's, and slow saves
    with no bridge (where the bridge's wait would cover them)."""
    root = tmp_path_factory.mktemp("dp_bridge")
    src = make_colmap_scene(str(root / "scene"))
    port = free_port()
    frames = []
    client = threading.Thread(target=_client, args=(port, frames))
    client.start()
    job = dict(kind="loop", model_kw=dict(source_path=src, sh_degree=1),
               opt_kw=dict(iterations=ITERS), rcfg_kw={})
    jobs = dict(
        bridge=dict(job, model=str(root / "bridge"), hooks=([], [], []),
                    gui_port=port),
        slow_save=dict(job, model=str(root / "slow"),
                       hooks=([], [2, ITERS], []), slow_save=HOLD_S))
    try:
        results = spawn(2, jobs, str(root / "ranks"), timeout=GROUP_TIMEOUT)
    finally:
        client.join(timeout=60)
    assert not client.is_alive()
    return root, results, frames


def test_bridge_pause_and_keep_alive_outlast_the_group_timeout(ranks):
    _, results, frames = ranks
    polls = results[0]["bridge"]["polls"]
    assert [it for it, _ in polls] == [1, 2, 3]
    assert polls[0][1] > GROUP_TIMEOUT       # paused
    assert polls[2][1] > GROUP_TIMEOUT       # kept alive
    assert results[1]["bridge"]["polls"] == []
    assert frames.count(True) > ITERS and False in frames
    _assert_ranks_equal(results, "bridge")
    assert results[1]["bridge"]["writes"] == []


def test_slow_saves_of_rank_0_outlast_the_group_timeout(ranks):
    root, results, _ = ranks
    _assert_ranks_equal(results, "slow_save")
    assert results[1]["slow_save"]["writes"] == []
    for it in (2, ITERS):
        assert (root / "slow" / "point_cloud" / f"iteration_{it}"
                / "point_cloud.ply").exists()
