"""The port's training loop (gsplat_tpu_torch/train/loop.py) against the JAX
package's ``train`` on the same tiny COLMAP scene (120 points, 6 cameras,
64x48; the scene of tests/test_cli.py, written with the port's writers),
with ``random.seed(0)`` before each, so that both draw one camera order.
JAX's densify draws come from its key sequence (``PRNGKey(0)``, split per
event, ``loop.py``); the port is handed the same draws through the
``noise=`` of ``trainer.densify_step``, as tests/test_torch_train.py does.

Tolerances. The losses and eval scalars in the logs: rtol 1e-4; every
other logged value, the camera order, the event lines and the densify
masks: equal. The final parameters: the step gate of test_torch_train.py
carried through the loop. Each Adam step moves a parameter by lr·m̂/(√v̂+ε),
a ratio of the gradient's moments, so a gradient within the gradient gate
(rtol 5e-3) moves it within 2·5e-3·lr of JAX's move, and a gradient within
rounding of 0 (|g| < 1e-6, the gate's atol) may flip its sign and move it
by up to 2·lr more. Summed over the steps: |Δp| <= 1e-6·|p| + 1e-7 +
Σ_t lr_t·(0.01 + 2·[|g_t| < 1e-6]), with g_t JAX's gradient of step t.
A densify decision may differ only for a gaussian whose statistic lies
within the gradient gate of ``densify_grad_threshold``; after such a flip
the states differ in structure and are compared no further. The forced
cases run the port alone: a pair overflow retried from the pre-step state
commits what a run with ample capacity commits, and a densify event that
runs out of slots grows the capacity.
"""
import json
import random
import re
import sys

import numpy as np
import pytest
import torch

import jax

from gsplat_tpu import config as jcfg
from gsplat_tpu.train import loop as jloop
from gsplat_tpu.train import trainer as jtrainer
from gsplat_tpu_torch import config as tcfg
from gsplat_tpu_torch.train import loop as tloop
from gsplat_tpu_torch.train import trainer as ttrainer

from torch_parity import make_colmap_scene, state_to_numpy, t2n

ITERS = 10
# one densify event (iteration 6) and one opacity reset (iteration 8)
OPT_KW = dict(iterations=ITERS, densify_from_iter=2, densification_interval=6,
              opacity_reset_interval=8)
GRAD_TOL = dict(rtol=5e-3, atol=1e-6)    # test_torch_train.py's gate
TRAINABLE = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")
EVENT = re.compile(r"^\[iter \d+\] .*$", re.M)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """Both packages' telemetry mirror their scalars to TensorBoard when it
    imports, which loads TensorFlow here (about 17 s a process); the JSONL
    logs these tests read do not need it."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _jax_noise(key, cap):
    return (jax.random.normal(key, (cap, 3)),
            jax.random.normal(jax.random.fold_in(key, 1), (cap, 3)))


def _record(monkeypatch, rec):
    """Wrap both packages' step, densify event and opacity reset: the
    camera of each step, JAX's gradient of each step (from its Adam
    moments), the state each densify event starts from and the mask it
    leaves, the step of each reset; the port's densify event gets JAX's
    draws."""
    jstep, tstep = jtrainer.train_step, ttrainer.train_step
    jdens, tdens = jtrainer.densify_step, ttrainer.densify_step
    jreset, treset = jtrainer.opacity_reset_step, ttrainer.opacity_reset_step
    key = [jax.random.PRNGKey(0)]

    def jax_step(s, cam, *a, **kw):
        s2, aux = jstep(s, cam, *a, **kw)
        grads = {k: (np.asarray(s2.adam.mu[k])
                     - 0.9 * np.asarray(s.adam.mu[k])) / 0.1
                 for k in TRAINABLE}
        rec["jax_steps"].append((int(s.step) + 1, np.asarray(cam.world_view),
                                 grads))
        return s2, aux

    def port_step(s, cam, *a, **kw):
        rec["port_cams"].append(t2n(cam.world_view))
        return tstep(s, cam, *a, **kw)

    def jax_densify(state, k, *a, **kw):
        out = jdens(state, k, *a, **kw)
        st = state.stats
        grad = np.where(np.asarray(st.denom) > 0,
                        np.asarray(st.xyz_gradient_accum)
                        / np.maximum(np.asarray(st.denom), 1.0), 0.0)
        rec["jax_densify"].append((int(state.step), grad,
                                   np.asarray(out[0].gaussians.active)))
        return out

    def port_densify(state, gen, *a, **kw):
        key[0], sub = jax.random.split(key[0])
        noise = tuple(torch.tensor(np.asarray(x)) for x in _jax_noise(
            sub, state.gaussians.capacity))
        out = tdens(state, gen, *a, noise=noise, **kw)
        rec["port_densify"].append((state.step,
                                    t2n(out[0].gaussians.active)))
        return out

    def reset(side, fn):
        def wrapped(state):
            rec[side + "_reset"].append(int(state.step))
            return fn(state)
        return wrapped

    monkeypatch.setattr(jtrainer, "opacity_reset_step", reset("jax", jreset))
    monkeypatch.setattr(ttrainer, "opacity_reset_step",
                        reset("port", treset))
    monkeypatch.setattr(jtrainer, "train_step", jax_step)
    monkeypatch.setattr(ttrainer, "train_step", port_step)
    monkeypatch.setattr(jtrainer, "densify_step", jax_densify)
    monkeypatch.setattr(ttrainer, "densify_step", port_densify)


def test_loop_matches_jax_train(tmp_path, capsys, monkeypatch):
    src = make_colmap_scene(str(tmp_path / "scene"))
    rec = {k: [] for k in ("jax_steps", "port_cams", "jax_densify",
                           "port_densify", "jax_reset", "port_reset")}
    _record(monkeypatch, rec)
    kw = dict(source_path=src, sh_degree=1, eval=True)
    hooks = ([ITERS], [ITERS], [])

    random.seed(0)
    tscene, tstate = tloop.train(
        tcfg.ModelConfig(model_path=str(tmp_path / "port"), **kw),
        tcfg.OptimizationConfig(**OPT_KW), tcfg.PipelineConfig(),
        tcfg.RasterizerConfig(), *hooks, quiet=True, device="cpu")
    port_out = capsys.readouterr().out
    random.seed(0)
    _, jstate = jloop.train(
        jcfg.ModelConfig(model_path=str(tmp_path / "jax"), **kw),
        jcfg.OptimizationConfig(**OPT_KW), jcfg.PipelineConfig(),
        jcfg.RasterizerConfig(), *hooks, quiet=True)
    jax_out = capsys.readouterr().out

    # the camera order and every event: densify, growth, reset, shrink,
    # retry (the last three as the loops print them)
    assert len(rec["port_cams"]) == len(rec["jax_steps"]) == ITERS
    for got, (_, want, _) in zip(rec["port_cams"], rec["jax_steps"]):
        np.testing.assert_array_equal(got, want)
    assert EVENT.findall(port_out) == EVENT.findall(jax_out)
    assert "[iter 1] shrinking pairs_per_gaussian" in port_out
    assert [s for s, _ in rec["port_densify"]] == \
        [s for s, _, _ in rec["jax_densify"]] == [6]
    assert rec["port_reset"] == rec["jax_reset"] == [8]

    # the densify masks; a decision may differ only within the gate
    flipped = False
    thr = tcfg.OptimizationConfig(**OPT_KW).densify_grad_threshold
    for (_, got), (_, stat, want) in zip(rec["port_densify"],
                                         rec["jax_densify"]):
        differ = np.nonzero(got != want)[0]
        gate = GRAD_TOL["rtol"] * thr + GRAD_TOL["atol"]
        assert (np.abs(stat[differ] - thr)
                <= gate).all(), f"densify masks differ at {differ}"
        flipped |= differ.size > 0
    if flipped:
        return              # the states now differ in structure

    # the logs, key by key but the clock
    tlog, jlog = _log(tmp_path / "port" / "training_log.jsonl"), \
        _log(tmp_path / "jax" / "training_log.jsonl")
    assert len(tlog) == len(jlog) == ITERS + 2          # + the two evals
    for a, b in zip(tlog, jlog):
        assert set(a) == set(b), (a, b)
        for k in set(a) - {"t", "iter_time"}:
            if "loss" in k or "psnr" in k:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
            else:
                assert a[k] == b[k], (k, a, b)

    # the final state
    want = state_to_numpy(jstate)
    assert tstate.step == want["step"] == ITERS
    assert tstate.adam.count == want["adam"]["count"]
    np.testing.assert_array_equal(t2n(tstate.gaussians.active),
                                  want["gaussians"]["active"])
    opt = tcfg.OptimizationConfig(**OPT_KW)
    for k in TRAINABLE:
        allow = 0.0
        for step, _, grads in rec["jax_steps"]:
            lr = ttrainer._lr_dict(opt, step, tscene.cameras_extent)[k]
            allow = allow + lr * (0.01 + 2.0 * (np.abs(grads[k])
                                                < GRAD_TOL["atol"]))
        got = t2n(getattr(tstate.gaussians, k))
        ref = want["gaussians"][k]
        assert (np.abs(got - ref) <= 1e-6 * np.abs(ref) + 1e-7 + allow).all(), k
    np.testing.assert_allclose(t2n(tstate.exposure), want["exposure"],
                               rtol=1e-6, atol=1e-7)


def _port_train(tmp_path, name, src, *, rcfg=None, opt_kw=OPT_KW, **kw):
    random.seed(0)
    return tloop.train(
        tcfg.ModelConfig(model_path=str(tmp_path / name), source_path=src,
                         sh_degree=1),
        tcfg.OptimizationConfig(**opt_kw), tcfg.PipelineConfig(),
        rcfg or tcfg.RasterizerConfig(), [], [], [], quiet=True,
        device="cpu", **kw)


def test_overflow_retry_commits_the_ample_capacity_state(tmp_path, capsys):
    """A pair list far too small for the frame: every overflowing frame is
    retried from the pre-step state with a grown list, so the committed
    states are those of a run whose list never overflowed."""
    src = make_colmap_scene(str(tmp_path / "scene"))
    opt_kw = dict(OPT_KW, iterations=4)
    _, small = _port_train(tmp_path, "small", src, opt_kw=opt_kw,
                           rcfg=tcfg.RasterizerConfig(pairs_per_gaussian=0.05))
    out = capsys.readouterr().out
    assert "retrying frame from pre-step state" in out
    _, ample = _port_train(tmp_path, "ample", src, opt_kw=opt_kw,
                           rcfg=tcfg.RasterizerConfig(pairs_per_gaussian=40.0))
    assert "retrying" not in capsys.readouterr().out
    assert small.step == ample.step == 4
    for k in TRAINABLE:
        np.testing.assert_array_equal(t2n(getattr(small.gaussians, k)),
                                      t2n(getattr(ample.gaussians, k)),
                                      err_msg=k)
        np.testing.assert_array_equal(t2n(small.adam.mu[k]),
                                      t2n(ample.adam.mu[k]), err_msg=k)
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        np.testing.assert_array_equal(t2n(getattr(small.stats, k)),
                                      t2n(getattr(ample.stats, k)))
    small_log = _log(tmp_path / "small" / "training_log.jsonl")
    ample_log = _log(tmp_path / "ample" / "training_log.jsonl")
    assert [r["train_loss_patches/total_loss"] for r in small_log] == \
        [r["train_loss_patches/total_loss"] for r in ample_log]


def test_overflow_that_persists_raises(tmp_path, monkeypatch):
    """A frame still truncated after 4 grow-retries is never committed."""
    src = make_colmap_scene(str(tmp_path / "scene"), n_cams=2)
    step = ttrainer.train_step

    def always_overflows(s, *a, **kw):
        s2, aux = step(s, *a, **kw)
        return s2, aux._replace(overflow=torch.tensor(1))

    monkeypatch.setattr(ttrainer, "train_step", always_overflows)
    with pytest.raises(RuntimeError, match="after 4 grow-retries"):
        _port_train(tmp_path, "m", src, opt_kw=dict(OPT_KW, iterations=1))


def test_forced_capacity_growth(tmp_path, capsys):
    """About 1,000 points at capacity_multiplier 1.0 (1,024 slots) and a
    threshold every visible gaussian passes: the densify event runs out of
    slots, the loop grows the capacity by the overflow (rounded to 1,024
    rows, padding with dead slots and zero moments) and trains on."""
    src = make_colmap_scene(str(tmp_path / "scene"), n_pts=1000, n_cams=3)
    opt_kw = dict(OPT_KW, iterations=7, densify_grad_threshold=1e-9)
    _, state = _port_train(tmp_path, "m", src, opt_kw=opt_kw,
                           capacity_multiplier=1.0)
    out = capsys.readouterr().out
    m = re.search(r"\[iter 6\] capacity 1024 → (\d+) \(overflow (\d+)\)", out)
    assert m, out
    new_cap, ovf = int(m.group(1)), int(m.group(2))
    assert new_cap == -(-(1024 + max(ovf, 1024)) // 1024) * 1024
    assert state.gaussians.capacity == new_cap
    for k in TRAINABLE:
        assert state.adam.mu[k].shape[0] == new_cap
        assert float(state.adam.mu[k][1024:].abs().sum()) == 0.0
    assert state.stats.denom.shape[0] == new_cap
    log = _log(tmp_path / "m" / "training_log.jsonl")
    assert log[-1]["step"] == 7 and all(np.isfinite(
        r["train_loss_patches/total_loss"]) for r in log)
    assert log[5]["total_points"] > log[4]["total_points"]
