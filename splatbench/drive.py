"""One run of one cell: set-up, the measured window, the traced steps and
the check, on every rank of the cell.

The traffic mix's parameters (``splatbench/traffic/<mix>.json``) say what
a run drives:

- ``entry``: ``train_step`` (the system's training step; over more than
  one rank the camera data-parallel step, one view a rank) or ``render``
  (a viewer's frame);
- ``poses``: how many poses of the configuration's camera path the mix
  visits; ``order``: ``shuffle`` (a fresh random order of them every pass,
  as the training loop draws cameras without replacement) or ``in_order``;
- ``check_steps`` / ``check_frames``: the steps of set-up the reference
  follows, or the frames of the window it renders again;
- ``trace_steps``: the calls profiled after the window in a traced run.

Training cells make their first ``check_steps`` steps at set-up through the
window's own call and feed, on distinct poses, and the window continues
from that same state; the reference follows those steps after the window.
Every training step uploads its view's images from pageable host memory
(the loop's upload, timed as a span) and reads the loss and the overflow
on the host, as the training loop does. The state goes back to the
set-up state at the start of every pass over the poses, so that the work
does not drift across the window.
"""
from __future__ import annotations

import gc
import math
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from splatbench import check, counts, scene, spec, trace
from splatbench.reference import raster
from splatbench.reference import train as ref_train

BANNED = ("jax", "jaxlib", "flax", "gsplat_tpu")


def banned_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


class Schedule:
    """The poses of the steps, this rank's and the whole batch's: every
    pass an order of the mix's poses (shuffled from the seed, or in
    order), cut into batches of one pose a rank."""

    def __init__(self, mix: dict, seed: int, world: int, rank: int):
        self.n = mix["poses"]
        self.shuffle = mix.get("order", "in_order") == "shuffle"
        self.rng = np.random.default_rng(seed)
        self.world, self.rank = world, rank
        self.order: list = []

    def next_batch(self):
        """(this rank's pose, whether a new pass began)."""
        new_pass = len(self.order) < self.world
        if new_pass:
            idx = (self.rng.permutation(self.n) if self.shuffle
                   else np.arange(self.n))
            self.order = [int(i) for i in idx]
        batch, self.order = self.order[:self.world], self.order[self.world:]
        return batch[self.rank], new_pass


def power_limit(dev) -> Optional[str]:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return None
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", str(dev.index or 0),
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


class Run:
    """One rank's run of a cell. ``all_reduce`` sums a list of tensors over
    the ranks (None on one rank); ``broadcast_int`` gives rank 0's int."""

    def __init__(self, cell: spec.Cell, seed: int, seconds: float,
                 traced: bool, dev: torch.device, rank: int = 0,
                 world: int = 1, t_start: Optional[float] = None,
                 all_reduce=None, broadcast_int=None):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.traced, self.dev = traced, dev
        self.rank, self.world = rank, world
        self.t_start = t_start if t_start is not None else time.perf_counter()
        self.all_reduce = all_reduce
        self.broadcast_int = broadcast_int or (lambda v: v)
        self.cfg, self.mix = cell.config, cell.traffic
        self.W, self.H = self.cfg["width"], self.cfg["height"]
        self.sh = self.cfg["sh_degree"]
        self.r = SimpleNamespace(attempted=0, failed=0, steps=0, window_s=0.0,
                                 upload_s=0.0, frame_ms=[], setup_s=0.0,
                                 peak_window=0, profile=None, views=[],
                                 checks={}, ok=True, notes=[])

    # ---- set-up -------------------------------------------------------
    def inputs(self):
        program = self.program_module()
        self.n_poses = self.mix["poses"]
        p, self.poses, self.gt = scene.make(self.cfg, self.seed, self.dev,
                                            self.n_poses)
        self.fov = scene.fov(self.cfg)
        self.extent = scene.extent(self.cfg, self.n_poses)
        self.bg = torch.tensor(self.cfg["background"], dtype=torch.float32,
                               device=self.dev)
        self.cams = [program.camera(i, self.poses[i], self.fov, self.gt[i])
                     for i in range(self.n_poses)]
        return p

    def right_size(self, g):
        views = [self.program.view(c, self.dev) for c in self.cams]
        rcfg, pairs = self.program.right_size(
            g, views, self.W, self.H, self.bg,
            self.cfg["first_pairs_per_gaussian"])
        self.r.notes.append(f"right-sized: largest pairs {pairs}, "
                            f"pairs_per_gaussian {rcfg.pairs_per_gaussian:.4f}"
                            f", pad_cap {rcfg.pad_cap}")
        return rcfg, views

    # ---- training -------------------------------------------------------
    def setup_train(self):
        """Inputs, right-sizing, and the first steps, which the reference
        follows. Returns (state, step, feed)."""
        prog, mix = self.program, self.mix
        p = self.inputs()
        rcfg, _ = self.right_size(prog.gaussians(p, self.sh))
        kw = prog.step_kw(self.W, self.H, rcfg, self.extent)
        step = (prog.dp_step(kw) if self.world > 1
                else (lambda s, x, bg: prog.train_step(s, x, bg, kw)))
        sched = Schedule(mix, self.seed, self.world, self.rank)

        def feed(i):
            t = time.perf_counter()
            with torch.profiler.record_function("splatbench.upload"):
                x = prog.upload(self.cams[i], self.dev)
            return x, time.perf_counter() - t

        # the first steps, which the reference follows
        state = prog.init_state(p, self.sh, self.cfg["first_step"])
        first = {k: v for k, v in p.items()}
        del p
        losses, self.check_poses = [], []
        check_bad = 0
        for s in range(mix["check_steps"]):
            i, _ = sched.next_batch()
            self.check_poses.append(i)
            state, aux = step(state, feed(i)[0], self.bg)
            losses.append(float(aux.loss))
            check_bad += int(aux.overflow) > 0 or not math.isfinite(losses[-1])
            if s == 0:
                grad_norm = prog.adam_first_grad_norms(state)
        change = {k: float(torch.linalg.norm(prog.params(state)[k] - first[k]))
                  for k in prog.LEAVES}
        del first
        self.program_readings = dict(loss=losses, grad_norm=grad_norm,
                                     change_norm=change, bad=check_bad)
        self.r.attempted += mix["check_steps"]
        self.r.failed += check_bad
        return state, step, feed

    def run_train(self):
        mix = self.mix
        state, step, feed = self.setup_train()
        check_bad = self.r.failed
        setup_state = state
        sched = Schedule(mix, self.seed + 1, self.world, self.rank)

        def one():
            nonlocal state
            i, new_pass = sched.next_batch()
            if new_pass:
                state = setup_state
            x, up = feed(i)
            self.r.upload_s += up
            with torch.profiler.record_function("splatbench.step"):
                state, aux = step(state, x, self.bg)
            with torch.profiler.record_function("splatbench.host_read"):
                loss = float(aux.loss)
                self.r.failed += (int(aux.overflow) > 0
                                  or not math.isfinite(loss))
            self.r.views.append(i)

        # steps in the window: rank 0's count where ranks must agree
        n_steps = None
        if self.world > 1:
            sync(self.dev)
            t = time.perf_counter()
            for _ in range(2):
                one()
            sync(self.dev)
            per = (time.perf_counter() - t) / 2
            n_steps = self.broadcast_int(max(1, round(self.seconds / per)))
            state = setup_state
            sched = Schedule(mix, self.seed + 1, self.world, self.rank)
            self.r.views, self.r.upload_s, self.r.failed = [], 0.0, check_bad
        self.window(one, n_steps)
        if self.traced:
            self.r.views = []
            self.r.profile = trace.profile(one, mix["trace_steps"], self.dev)
            self.traced_views = list(self.r.views)
        self.r.memory_peak = self.peak()
        del state, setup_state, step
        free(self.dev)
        self.check_train()

    def window(self, one, n_steps=None):
        """Calls ``one()`` for ``seconds`` (or ``n_steps`` times), after the
        set-up is over; nothing compiles inside."""
        sync(self.dev)
        if self.dev.type == "cuda":
            self.setup_peak = torch.cuda.max_memory_allocated(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        self.r.setup_s = time.perf_counter() - self.t_start
        t0 = time.perf_counter()
        while True:
            one()
            self.r.steps += 1
            if (self.r.steps >= n_steps if n_steps is not None
                    else time.perf_counter() - t0 >= self.seconds):
                break
        sync(self.dev)
        self.r.window_s = time.perf_counter() - t0
        self.r.attempted += self.r.steps
        if self.dev.type == "cuda":
            self.r.peak_window = torch.cuda.max_memory_allocated(self.dev)

    def peak(self) -> int:
        if self.dev.type != "cuda":
            return 0
        return max(torch.cuda.max_memory_allocated(self.dev),
                   self.r.peak_window, getattr(self, "setup_peak", 0))

    def reference_inputs(self):
        """The parameters again from the seed, and a pose's reference view
        and ground truth on the device."""
        p = scene.make(self.cfg, self.seed, self.dev, 1)[0]

        def view(i):
            R, T = self.poses[i]
            return (scene.view(R, T, *self.fov, self.dev),
                    torch.tensor(self.gt[i], device=self.dev))
        return p, view

    def reference_train(self, p0, view, tf32: bool = False):
        """The reference's readings of the check steps (its control with
        ``tf32``)."""
        return ref_train.train_steps(
            p0, [[view(i)] for i in self.check_poses], W=self.W, H=self.H,
            bg=self.bg, sh_degree=self.sh, extent=self.extent,
            opt=self.cfg["optimization"], first_step=self.cfg["first_step"],
            prod=raster.Products(tf32),
            reduce=self.all_reduce or ref_train.identity, batch=self.world)

    def check_train(self):
        t = time.perf_counter()
        p0, view = self.reference_inputs()
        got = self.reference_train(p0, view)
        self.r.notes.append(f"reference: {time.perf_counter() - t:.2f} s, "
                            f"pairs {[f.pairs for f in got.frames]}, "
                            f"contributing "
                            f"{[f.contributing for f in got.frames]}")
        self.reference_readings = got
        nums = check.train_numbers(self.program_readings, got)
        self.r.checks = check.judge(nums, self.cell.limits)
        self.r.ok = (self.program_readings["bad"] == 0
                     and all(c["value"] <= c["limit"]
                             for c in self.r.checks.values()))
        if self.traced:
            self.r.views = self.count_views(p0, view, self.traced_views)

    def count_views(self, p0, view, poses):
        """What each traced view needs, from the reference's walk of it at
        the set-up parameters."""
        n_tiles = (-(-self.W // 32)) * (-(-self.H // 32))
        seen = {}
        with torch.no_grad():
            for i in set(poses):
                f = raster.render(p0, view(i)[0], self.W, self.H, self.bg,
                                  self.sh, raster.Products(False))
                seen[i] = counts.FrameCount(f.pairs, f.bwd_rows,
                                            f.contributing, n_tiles,
                                            self.W * self.H)
        return [seen[i] for i in poses]

    # ---- rendering ------------------------------------------------------
    def setup_render(self):
        """Inputs and right-sizing (which renders every pose once). Returns
        (splats, views, rasterizer config, the poses the check samples)."""
        p = self.inputs()
        g = self.program.gaussians(p, self.sh)
        rcfg, views = self.right_size(g)
        rng = np.random.default_rng(self.seed)
        sample = sorted(int(i) for i in rng.choice(
            self.n_poses, min(self.mix["check_frames"], self.n_poses),
            replace=False))
        return g, views, rcfg, sample

    def reference_frames(self, p0, view, poses, tf32: bool = False):
        """{pose: (image, inverse depth, radii)} of the reference (its
        control with ``tf32``)."""
        out = {}
        with torch.no_grad():
            for i in poses:
                f = raster.render(p0, view(i)[0], self.W, self.H, self.bg,
                                  self.sh, raster.Products(tf32))
                out[i] = (f.image, f.invdepth, f.radius)
        return out

    def run_render(self):
        prog, mix = self.program_module(), self.mix
        g, views, rcfg, sample = self.setup_render()
        kept = {}
        ovf_dev = torch.zeros((), dtype=torch.long, device=self.dev)
        bad_dev = torch.zeros((), dtype=torch.long, device=self.dev)
        k = 0

        def one():
            nonlocal ovf_dev, bad_dev, k
            i = k % self.n_poses
            t = time.perf_counter()
            with torch.profiler.record_function("splatbench.frame"):
                out = prog.frame(g, views[i], self.W, self.H, self.bg, rcfg)
                sync(self.dev)
            self.r.frame_ms.append((time.perf_counter() - t) * 1e3)
            ovf_dev = torch.maximum(ovf_dev, out.overflow)
            bad_dev = bad_dev + (out.overflow > 0).long()
            if i in sample:
                kept[i] = (out.image, out.invdepth, out.radii)
            self.r.views.append(i)
            k += 1

        self.window(one)
        self.r.failed += int(bad_dev)
        frames_ms = list(self.r.frame_ms)
        if self.traced:
            self.r.views = []
            self.r.profile = trace.profile(one, mix["trace_steps"], self.dev)
            traced = list(self.r.views)
        self.r.frame_ms = frames_ms
        self.r.memory_peak = self.peak()
        # a sampled pose the window did not reach: its frame from the same
        # call, after the close
        for i in sample:
            if i not in kept:
                out = prog.frame(g, views[i], self.W, self.H, self.bg, rcfg)
                kept[i] = (out.image, out.invdepth, out.radii)
        got = {i: kept[i] for i in sample}
        del g, views, kept
        free(self.dev)
        t = time.perf_counter()
        p0, view = self.reference_inputs()
        ref = self.reference_frames(p0, view, sample)
        self.r.notes.append(f"reference: {time.perf_counter() - t:.2f} s")
        self.reference_readings = ref
        nums = check.frame_numbers(got, ref)
        self.r.checks = check.judge(nums, self.cell.limits)
        self.r.ok = all(c["value"] <= c["limit"]
                        for c in self.r.checks.values())
        if self.traced:
            self.r.views = self.count_views(p0, view, traced)

    def program_module(self):
        from splatbench import program
        self.program = program
        return program

    def run(self):
        if self.mix["entry"] == "render":
            self.run_render()
        else:
            self.program_module()
            self.run_train()
        return self.r


def e2e_values(cell: spec.Cell, r, world: int) -> dict:
    """The cell's end-to-end metrics from a run's readings."""
    W, H = cell.config["width"], cell.config["height"]
    out = {}
    for m in cell.end_to_end:
        stat = spec.statistic(m["name"], cell.root)
        if stat == "setup_s":
            v = r.setup_s
        elif stat == "pixels_per_s":
            v = r.steps * world * W * H / r.window_s
        elif stat == "request_ms_mean":
            v = r.window_s * 1e3 / r.steps
        elif stat == "request_ms_p95":
            v = float(np.percentile(np.asarray(r.frame_ms), 95))
        else:
            raise ValueError(f"unknown statistic {stat!r} of {m['name']}")
        out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def layer_context(cell: spec.Cell, r, world: int):
    """What a per-layer metric's reader sees of one rank's run."""
    return SimpleNamespace(
        cell=cell.name, config=cell.config, traffic=cell.traffic,
        world=world, profile=r.profile, views=r.views,
        steps=r.steps, window_s=r.window_s, upload_s=r.upload_s,
        peak_window_bytes=r.peak_window, n_splats=cell.config["gaussians"],
        counts=counts, trace=trace)
