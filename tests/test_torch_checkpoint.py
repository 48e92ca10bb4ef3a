"""The port's checkpoints (gsplat_tpu_torch/train/checkpoint.py) against the
JAX package's: npz files cross both ways with every leaf equal (the port's
host ints come back as ints), the port's own round trip, ``grow_capacity``,
the background-thread manager (keep-N, ``restore_latest``, ``close``), and
the ``--debug`` snapshot's keys against JAX's ``dump_snapshot`` of the same
state and camera. Ports of tests/test_train.py:236, 266 (the npz part)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsplat_tpu.core.camera import CameraView as JaxCameraView
from gsplat_tpu.models import gaussian_model as jgm
from gsplat_tpu.train import checkpoint as jckpt
from gsplat_tpu.train import optim as joptim
from gsplat_tpu.train import trainer as jtrainer
from gsplat_tpu.utils import debug as jdebug
from gsplat_tpu_torch.core.camera import CameraView
from gsplat_tpu_torch.train import checkpoint as tckpt
from gsplat_tpu_torch.train import trainer as ttrainer
from gsplat_tpu_torch.utils import debug as tdebug

from torch_parity import CAM_FIELDS, state_to_numpy, to_numpy


def _jax_state(rng, n=40, cap=64, deg=1, n_img=3, step=123):
    """A JAX TrainState whose every leaf holds distinct values."""
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    g = jgm.create_from_pcd(pts, cols, deg, capacity=cap)
    g = dataclasses.replace(g, active_sh_degree=jnp.asarray(deg, jnp.int32))
    s = jtrainer.init_state(g, n_img)

    def rnd(tree):
        return jax.tree_util.tree_map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape), jnp.float32), tree)

    return dataclasses.replace(
        s, adam=joptim.AdamState(mu=rnd(s.adam.mu), nu=rnd(s.adam.nu),
                                 count=jnp.asarray(step - 1, jnp.int32)),
        exposure=rnd(s.exposure),
        exp_adam=joptim.AdamState(mu=rnd(s.exp_adam.mu),
                                  nu=rnd(s.exp_adam.nu),
                                  count=jnp.asarray(step, jnp.int32)),
        stats=rnd(s.stats), step=jnp.asarray(step, jnp.int32))


def _port(state):
    return ttrainer.state_from_numpy(state_to_numpy(state), device="cpu")


def _assert_equal(tstate, jstate):
    """Every leaf of the port's state equal to the JAX state's, in JAX's
    flatten order; the host ints as ints."""
    leaves = jax.tree_util.tree_leaves(jstate)
    items = tckpt.state_items(tstate)
    assert len(items) == len(leaves) == 29
    for (name, got), want in zip(items, leaves):
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert isinstance(tstate.step, int) and isinstance(tstate.adam.count, int)
    assert isinstance(tstate.gaussians.active_sh_degree, int)


def test_state_items_follow_jax_flatten_order(rng):
    js = _jax_state(rng)
    names = [jax.tree_util.keystr(kp) for kp, _ in
             jax.tree_util.tree_flatten_with_path(js)[0]]
    assert [n for n, _ in tckpt.state_items(_port(js))] == names


def test_port_checkpoint_loads_in_jax(tmp_path, rng):
    js = _jax_state(rng)
    path = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(path, _port(js), 123)
    back, it = jckpt.load_checkpoint(path)
    assert it == 123
    for a, b in zip(jax.tree_util.tree_leaves(js),
                    jax.tree_util.tree_leaves(back)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_jax_checkpoint_loads_in_port(tmp_path, rng):
    js = _jax_state(rng, deg=2, n_img=1, step=7)
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, js, 7)
    ts, it = tckpt.load_checkpoint(path, device="cpu")
    assert it == 7 and ts.step == 7 and ts.adam.count == 6
    assert ts.gaussians.active_sh_degree == 2
    _assert_equal(ts, js)


def test_port_checkpoint_round_trip(tmp_path, rng):
    ts = _port(_jax_state(rng))
    path = str(tmp_path / "rt.npz")
    tckpt.save_checkpoint(path, ts, 5)
    back, it = tckpt.load_checkpoint(path, device="cpu")
    assert it == 5
    for (n, a), (_, b) in zip(tckpt.state_items(ts),
                              tckpt.state_items(back)):
        np.testing.assert_array_equal(a, b, err_msg=n)


def test_grow_capacity_matches_jax(rng):
    js = _jax_state(rng, cap=48)
    want = jckpt.grow_capacity(js, 1024)
    got = tckpt.grow_capacity(_port(js), 1024)
    _assert_equal(got, want)
    assert tckpt.grow_capacity(got, 512) is got      # never shrinks


def test_async_manager_keeps_newest_and_restores(tmp_path, rng):
    js = _jax_state(rng, deg=2)
    d = tmp_path / "mngr"
    mngr = tckpt.AsyncCheckpointManager(str(d), max_to_keep=2)
    states = {}
    for step in (100, 200, 300):
        states[step] = _port(dataclasses.replace(
            js, step=jnp.asarray(step, jnp.int32)))
        mngr.save(step, states[step])
    mngr.close()
    assert not mngr._thread.is_alive()
    assert sorted(p.name for p in d.iterdir()) == ["step_200.npz",
                                                   "step_300.npz"]
    with pytest.raises(RuntimeError, match="closed"):
        mngr.save(400, states[300])

    mngr2 = tckpt.AsyncCheckpointManager(str(d))
    restored, it = mngr2.restore_latest(device="cpu")
    mngr2.close()
    assert it == 300 and restored.step == 300
    for (n, a), (_, b) in zip(tckpt.state_items(states[300]),
                              tckpt.state_items(restored)):
        np.testing.assert_array_equal(a, b, err_msg=n)
    # one file of the manager is a checkpoint JAX loads
    back, it = jckpt.load_checkpoint(str(d / "step_200.npz"))
    assert it == 200 and int(back.step) == 200

    empty = tckpt.AsyncCheckpointManager(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        empty.restore_latest(device="cpu")
    empty.close()


def test_async_manager_save_returns_a_host_copy(tmp_path, rng):
    """``save`` copies the state to host memory before it returns: a
    later change to the tensors does not reach the file."""
    ts = _port(_jax_state(rng))
    mngr = tckpt.AsyncCheckpointManager(str(tmp_path / "m"))
    mngr.save(1, ts)
    want = ts.gaussians.xyz.clone()
    ts.gaussians.xyz.add_(1.0)
    mngr.close()
    back, _ = tckpt.load_checkpoint(str(tmp_path / "m" / "step_1.npz"),
                                    device="cpu")
    torch.testing.assert_close(back.gaussians.xyz, want, rtol=0, atol=0)


def test_debug_snapshot_keys_match_jax(tmp_path, rng):
    js = _jax_state(rng)
    cam = JaxCameraView.create(R=np.eye(3), T=np.zeros(3), fovx=0.9,
                               fovy=0.7)
    H, W = 6, 8
    arrays = (rng.uniform(0, 1, (3, H, W)).astype(np.float32),
              np.ones((1, H, W), np.float32), np.zeros((1, H, W), np.float32),
              np.zeros((1, H, W), np.float32))
    jpath = jdebug.dump_snapshot(str(tmp_path / "jax.npz"), js, cam, arrays,
                                 4, reason="non-finite loss nan")
    tcam = CameraView.from_numpy(to_numpy(cam, CAM_FIELDS), device="cpu")
    tpath = tdebug.dump_snapshot(
        str(tmp_path / "port.npz"), _port(js), tcam,
        tuple(torch.tensor(a) for a in arrays), 4,
        reason="non-finite loss nan")
    with np.load(jpath) as j, np.load(tpath) as t:
        assert set(t.keys()) == set(j.keys())
        for k in j.keys():
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
