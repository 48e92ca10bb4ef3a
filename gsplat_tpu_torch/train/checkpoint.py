"""Training checkpoints: the full state to an npz file and back, capacity
growth, and a manager that writes checkpoints on a background thread.
Counterpart of gsplat_tpu/train/checkpoint.py.

The npz layout is the JAX package's: ``iteration``, ``n_leaves`` and
``leaf_{i}`` in the order JAX flattens its ``TrainState`` (``state_items``),
so a file written by either package loads in the other. The port's step,
Adam counts and active SH degree are host ints; they are written as 0-d
int32 arrays, as JAX holds them, and read back as ints. JAX's orbax
manager directory has no counterpart: ``AsyncCheckpointManager`` writes one
npz file per step in this same layout.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import re
import threading
from typing import List, Tuple

import numpy as np
import torch

from gsplat_tpu_torch.models import gaussian_model as gm
from gsplat_tpu_torch.train import densify as densify_lib
from gsplat_tpu_torch.train import optim
from gsplat_tpu_torch.train import trainer

STATS_FIELDS = tuple(f.name for f in dataclasses.fields(
    densify_lib.DensifyStats))


def _host(x) -> np.ndarray:
    """A host copy (never a view of a CPU tensor's storage)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x, np.int32)        # a host int: step, count, degree


def _adam_items(prefix: str, a: optim.AdamState):
    return ([(f"{prefix}.mu['{k}']", a.mu[k]) for k in sorted(a.mu)]
            + [(f"{prefix}.nu['{k}']", a.nu[k]) for k in sorted(a.nu)]
            + [(f"{prefix}.count", a.count)])


def state_items(state: "trainer.TrainState") -> List[Tuple[str, np.ndarray]]:
    """(name, host array) for every leaf of the state, in JAX's tree-flatten
    order of its ``TrainState``, named as ``jax.tree_util.keystr`` names
    them: the gaussians' fields, Adam's moments by sorted key and its count,
    the exposure, the exposure Adam, the densification statistics, the
    step."""
    g = state.gaussians
    items = [(f".gaussians.{k}", getattr(g, k)) for k in gm.TENSOR_FIELDS]
    items.append((".gaussians.active_sh_degree", g.active_sh_degree))
    items += _adam_items(".adam", state.adam)
    items.append((".exposure", state.exposure))
    items += _adam_items(".exp_adam", state.exp_adam)
    items += [(f".stats.{k}", getattr(state.stats, k)) for k in STATS_FIELDS]
    items.append((".step", state.step))
    return [(name, _host(x)) for name, x in items]


def _state_from_leaves(leaves: List[np.ndarray], device
                       ) -> "trainer.TrainState":
    """The inverse of ``state_items``: leaves in that order."""
    it = iter(leaves)
    g = {k: next(it) for k in gm.TENSOR_FIELDS}
    g["active_sh_degree"] = int(next(it))
    keys = sorted(gm.TRAINABLE_FIELDS)

    def adam(keys):
        mu = {k: next(it) for k in keys}
        nu = {k: next(it) for k in keys}
        return dict(mu=mu, nu=nu, count=int(next(it)))

    arrays = dict(gaussians=g, adam=adam(keys))
    arrays["exposure"] = next(it)
    arrays["exp_adam"] = adam(["exposure"])
    arrays["stats"] = {k: next(it) for k in STATS_FIELDS}
    arrays["step"] = int(next(it))
    if next(it, None) is not None:
        raise ValueError("checkpoint has more leaves than a TrainState")
    return trainer.state_from_numpy(arrays, device=device)


def _write(f, iteration: int, leaves: List[np.ndarray]):
    np.savez_compressed(f, iteration=iteration, n_leaves=len(leaves),
                        **{f"leaf_{i}": x for i, x in enumerate(leaves)})


def save_checkpoint(path: str, state: "trainer.TrainState", iteration: int):
    _write(path, iteration, [a for _, a in state_items(state)])


def load_checkpoint(path: str, *, device="cuda"
                    ) -> Tuple["trainer.TrainState", int]:
    """(state on ``device``, iteration) from an npz of either package."""
    with np.load(path) as data:
        n = int(data["n_leaves"])
        leaves = [data[f"leaf_{i}"] for i in range(n)]
        iteration = int(data["iteration"])
    return _state_from_leaves(leaves, device), iteration


def grow_capacity(state: "trainer.TrainState", new_cap: int
                  ) -> "trainer.TrainState":
    """Pad every per-slot tensor (parameters, Adam moments, statistics) to
    ``new_cap`` rows. New slots are inactive, with zero moments."""
    old_cap = state.gaussians.capacity
    extra = new_cap - old_cap
    if extra <= 0:
        return state

    def pad_rows(a):
        return torch.cat([a, a.new_zeros((extra,) + a.shape[1:])])

    adam = optim.AdamState(
        mu={k: pad_rows(v) for k, v in state.adam.mu.items()},
        nu={k: pad_rows(v) for k, v in state.adam.nu.items()},
        count=state.adam.count)
    stats = densify_lib.DensifyStats(**{
        k: pad_rows(getattr(state.stats, k)) for k in STATS_FIELDS})
    return dataclasses.replace(
        state, gaussians=gm.pad_to_capacity(state.gaussians, new_cap),
        adam=adam, stats=stats)


class AsyncCheckpointManager:
    """Periodic checkpoints written on a background thread. ``save``
    returns once the state has been copied to host memory; the thread
    compresses it to ``<dir>/step_<N>.npz`` (the layout of
    ``save_checkpoint``) while training goes on, and keeps the newest
    ``max_to_keep`` steps. An error of the thread is raised by the next
    ``wait_until_finished``, ``restore_latest`` or ``close``."""

    _STEP = re.compile(r"step_(\d+)\.npz$")

    def __init__(self, dir_path: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(dir_path)
        os.makedirs(self._dir, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._queue: "queue.Queue" = queue.Queue()
        self._error = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="checkpoint-writer")
        self._thread.start()

    def _run(self):
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                iteration, leaves = item
                final = os.path.join(self._dir, f"step_{iteration}.npz")
                tmp = final + ".tmp"
                with open(tmp, "wb") as f:
                    _write(f, iteration, leaves)
                os.replace(tmp, final)
                for old in self.steps()[:-self._max_to_keep]:
                    os.remove(os.path.join(self._dir, f"step_{old}.npz"))
            except Exception as e:       # kept for the caller's next wait
                self._error = e
            finally:
                self._queue.task_done()

    def save(self, iteration: int, state: "trainer.TrainState") -> None:
        if not self._thread.is_alive():
            raise RuntimeError("checkpoint manager is closed")
        self._queue.put((iteration, [a for _, a in state_items(state)]))

    def steps(self) -> List[int]:
        """The steps on disk, oldest first."""
        return sorted(int(m.group(1)) for m in map(
            self._STEP.match, os.listdir(self._dir)) if m)

    def wait_until_finished(self) -> None:
        self._queue.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def restore_latest(self, *, device="cuda"):
        """(state on ``device``, iteration) of the newest step on disk."""
        self.wait_until_finished()
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no step_*.npz checkpoints in {self._dir}")
        return load_checkpoint(
            os.path.join(self._dir, f"step_{steps[-1]}.npz"), device=device)

    def close(self) -> None:
        """Block until every save has landed, then stop the thread."""
        if self._thread.is_alive():
            self._queue.put(None)
            self._thread.join()
        self.wait_until_finished()
