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
- ``trace_steps``: the calls profiled after the window in a traced run;
- ``events``: with ``true``, after each training step the loop's events
  that are due at its iteration (``train/loop.py``): a densify event every
  ``densification_interval`` iterations, with split draws made from the
  seed, and an opacity reset every ``opacity_reset_interval``; the
  configuration's ``optimization`` block sets the intervals.

Training cells make their first ``check_steps`` steps at set-up through the
window's own call and feed, on distinct poses, and the window continues
from that same state; the reference follows those steps after the window.
With events, the check steps end in a densify event, and the reference's
event (the configuration's ``reference`` module's ``densify``) is applied
to the program's state before it; the pair capacity, sized on the seed's
state, has to hold every view of the state after that event with a tenth
to spare, or it is sized again on that state and the check steps are made
again through the new call. The window's events are timed, not counted:
after the close, its first pass is made again from the set-up state, and
that pass's event is counted.
The reference takes each check view as one record
(``reference.raster.ViewRecord``: the view, the pose, the ground truth,
the alpha mask, the inverse depth and its mask, as the program's upload
fed them), and the configuration's step options.
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
from splatbench.reference.raster import ViewRecord

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
        self.capacity = self.cfg.get("capacity", 0)
        self.options = spec.options(self.cfg)
        self.events = bool(self.mix.get("events", False))
        self.ref = spec.module("reference", self.cfg.get("reference", "train"),
                               cell.root)
        self.ref.accept(self.options)
        if self.events and not hasattr(self.ref, "densify"):
            raise ValueError("the traffic densifies and the configuration's "
                             "reference has no densify event")
        if self.events and world > 1:
            raise ValueError("densify events are driven on one card")
        self.r = SimpleNamespace(attempted=0, failed=0, steps=0, window_s=0.0,
                                 upload_s=0.0, frame_ms=[], setup_s=0.0,
                                 peak_window=0, profile=None, views=[],
                                 checks={}, ok=True, notes=[], densify_s=[],
                                 events=0)

    # ---- set-up -------------------------------------------------------
    def inputs(self):
        program = self.program_module()
        self.n_poses = self.mix["poses"]
        root = self.cell.root
        p, self.poses, self.gt = scene.make(self.cfg, self.seed, self.dev,
                                            self.n_poses, root)
        self.fov = scene.fov(self.cfg)
        self.extent = scene.extent(self.cfg, self.n_poses, root)
        self.bg = torch.tensor(self.cfg["background"], dtype=torch.float32,
                               device=self.dev)
        self.depth = scene.depths(self.cfg, self.poses, self.seed, root)
        self.masks = scene.masks(self.cfg, self.poses, self.seed, root)
        self.cams = [program.camera(
            i, self.poses[i], self.fov, self.gt[i],
            None if self.depth is None
            else (self.depth[0][i], self.depth[1][i]),
            exposure=self.options["train_test_exp"],
            alpha=None if self.masks is None else self.masks[i])
            for i in range(self.n_poses)]
        return p

    def right_size(self, g, first_ppg=None):
        views = [self.program.view(c, self.dev) for c in self.cams]
        rcfg, pairs = self.program.right_size(
            g, views, self.W, self.H, self.bg,
            first_ppg or self.cfg["first_pairs_per_gaussian"],
            self.options["antialiasing"])
        self.r.notes.append(f"right-sized: largest pairs {pairs}, "
                            f"pairs_per_gaussian {rcfg.pairs_per_gaussian:.4f}"
                            f", pad_cap {rcfg.pad_cap}")
        return rcfg, views

    # ---- training -------------------------------------------------------
    def step_kw(self, rcfg):
        return self.program.step_kw(self.W, self.H, rcfg, self.extent,
                                    self.options, self.cfg["optimization"])

    def make_step(self, kw):
        prog = self.program
        return (prog.dp_step(kw) if self.world > 1
                else (lambda s, x, bg: prog.train_step(s, x, bg, kw)))

    def feed(self, i):
        t = time.perf_counter()
        with torch.profiler.record_function("splatbench.upload"):
            x = self.program.upload(self.cams[i], self.dev)
        return x, time.perf_counter() - t

    def split_noise(self):
        """The split samples of every densify event: two (capacity, 3)
        standard-normal draws from the seed, on the device."""
        gen = scene.generator(self.seed ^ 0x5E11, self.dev)
        rows = max(self.capacity, self.cfg["gaussians"])
        return tuple(torch.randn((rows, 3), generator=gen, device=self.dev)
                     for _ in range(2))

    def event(self, state, kw):
        """The loop's events due after the step that made ``state``:
        (state, the densify event's readings or None). The event's span
        runs from its call to the host's read of its overflow."""
        prog = self.program
        densify, screen, reset = prog.events(kw, prog.iteration(state))
        info = None
        if densify:
            pre = state
            t = time.perf_counter()
            with torch.profiler.record_function("splatbench.densify"):
                state, overflow = prog.densify(state, self.noise, self.extent,
                                               kw, screen)
                overflow = int(overflow)
            info = dict(pre=pre, post=state, overflow=overflow,
                        seconds=time.perf_counter() - t)
        if reset:
            state = prog.opacity_reset(state)
        return state, info

    def event_counts(self, info, kw):
        """An event's clones and splits (the program's selection rule on
        its statistics before the event) and live rows before and after,
        as one device tensor."""
        prog, opt = self.program, kw["opt"]
        rows = prog.rows(info["pre"])
        denom = rows["denom"]
        grads = torch.where(denom > 0, rows["xyz_gradient_accum"]
                            / torch.clamp(denom, min=1.0), 0.0)
        big = torch.exp(rows["scaling"]).amax(dim=1) > (
            opt.percent_dense * self.extent)
        hit = rows["active"] & (grads >= opt.densify_grad_threshold)
        return torch.stack([(hit & ~big).sum(), (hit & big).sum(),
                            rows["active"].sum(),
                            prog.rows(info["post"])["active"].sum()])

    def check_steps(self, p, step, kw):
        """The first steps from the seed's state, on distinct poses,
        through the window's call and events. Returns (state, readings,
        the densify event that ends them or None). The readings hold the
        leaves' first gradients and changes, and the exposures' too where
        each image has its own."""
        prog, mix = self.program, self.mix
        exposure = self.options["train_test_exp"]
        sched = Schedule(mix, self.seed, self.world, self.rank)
        state = prog.init_state(
            p, self.sh, self.cfg["first_step"], self.capacity,
            self.n_poses if exposure else 1)
        exp0 = prog.exposures(state).clone() if exposure else None
        losses, poses, bad, grad_norm, last = [], [], 0, None, None
        for s in range(mix["check_steps"]):
            i, _ = sched.next_batch()
            poses.append(i)
            state, aux = step(state, self.feed(i)[0], self.bg)
            losses.append(float(aux.loss))
            bad += int(aux.overflow) > 0 or not math.isfinite(losses[-1])
            if s == 0:
                grad_norm = prog.adam_first_grad_norms(state, exposure)
            if self.events:
                state, info = self.event(state, kw)
                if info is not None:
                    if s != mix["check_steps"] - 1:
                        raise ValueError("a densify event falls inside the "
                                         "check steps")
                    last = info
                    bad += info["overflow"] > 0
        if self.events and last is None:
            bad += 1        # the steps did not reach the event's iteration
        end = last["pre"] if last else state
        before = prog.params(end)
        n = p["xyz"].shape[0]
        change = {k: float(torch.linalg.norm(before[k][:n] - p[k]))
                  for k in prog.LEAVES}
        if exposure:
            change["exposure"] = float(torch.linalg.norm(
                prog.exposures(end) - exp0))
        return state, dict(loss=losses, grad_norm=grad_norm,
                           change_norm=change, bad=bad, poses=poses), last

    def fits(self, g, rcfg) -> bool:
        """Whether every view of the splats ``g`` leaves a tenth of the
        pair capacity and of the alignment padding free under ``rcfg``."""
        pairs = pad = 0
        for c in self.cams:
            out = self.program.frame(g, self.program.view(c, self.dev),
                                     self.W, self.H, self.bg, rcfg,
                                     self.options["antialiasing"])
            if int(out.overflow):
                return False
            pairs = max(pairs, int(out.num_pairs))
            pad = max(pad, int(out.num_padded) - int(out.num_pairs))
        room = 1.1 * pairs <= rcfg.pairs_per_gaussian * g.capacity and (
            1.1 * pad <= rcfg.pad_cap)
        self.r.notes.append(f"after the check's event: largest pairs {pairs}"
                            f", padding {pad}; "
                            + ("fits" if room else "sized again"))
        return room

    def setup_train(self):
        """Inputs, right-sizing, and the first steps, which the reference
        follows. Returns (state, step, feed, kw)."""
        prog, mix = self.program, self.mix
        t = [time.perf_counter()]
        p = self.inputs()
        t.append(time.perf_counter())
        rcfg, _ = self.right_size(prog.gaussians(p, self.sh, self.capacity))
        kw = self.step_kw(rcfg)
        if self.events:
            if not prog.events(kw, self.cfg["first_step"]
                               + mix["check_steps"])[0]:
                raise ValueError("the check steps end in no densify event: "
                                 "first_step + check_steps has to be a "
                                 "multiple of the densification interval")
            self.noise = self.split_noise()
        step = self.make_step(kw)
        state, self.program_readings, last = self.check_steps(p, step, kw)
        if last is not None and not self.fits(state.gaussians, rcfg):
            rcfg, _ = self.right_size(state.gaussians,
                                      rcfg.pairs_per_gaussian)
            del state, last
            kw = self.step_kw(rcfg)
            step = self.make_step(kw)
            state, self.program_readings, last = self.check_steps(p, step,
                                                                  kw)
        del p
        self.check_poses = self.program_readings["poses"]
        t.append(time.perf_counter())
        self.event_pre = None
        if last is not None:
            # the state before the event waits on the host for the check
            self.event_pre = {k: v.cpu()
                              for k, v in prog.rows(last["pre"]).items()}
            del last
        t.append(time.perf_counter())
        self.r.notes.append(
            "set-up: to inputs {:.2f} s, inputs {:.2f} s, right-sizing and "
            "check steps {:.2f} s, state to the host {:.2f} s".format(
                t[0] - self.t_start, *(b - a for a, b in zip(t, t[1:]))))
        self.r.attempted += mix["check_steps"]
        self.r.failed += self.program_readings["bad"]
        return state, step, self.feed, kw

    def run_train(self):
        mix = self.mix
        state, step, feed, kw = self.setup_train()
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
            if self.events:
                state, info = self.event(state, kw)
                if info is not None:
                    self.r.densify_s.append(info["seconds"])
                    self.r.failed += info["overflow"] > 0
                    self.r.events += 1

        # steps in the window: rank 0's count where ranks must agree, from
        # the time of one pass over the poses
        n_steps = None
        if self.world > 1:
            calib = max(2, self.n_poses // self.world)
            sync(self.dev)
            t = time.perf_counter()
            for _ in range(calib):
                one()
            sync(self.dev)
            per = (time.perf_counter() - t) / calib
            n_steps = self.broadcast_int(max(1, round(self.seconds / per)))
            state = setup_state
            sched = Schedule(mix, self.seed + 1, self.world, self.rank)
            self.r.views, self.r.upload_s, self.r.failed = [], 0.0, check_bad
        self.window(one, n_steps)
        self.r.attempted += self.r.events
        if self.traced:
            self.r.views = []
            if self.events:
                sched.order = []    # a pass from its start: no event traced
            self.r.profile = trace.profile(one, mix["trace_steps"], self.dev)
            self.traced_views = list(self.r.views)
        self.r.memory_peak = self.peak()
        post = None
        if self.events:
            del state
            self.replay_event(setup_state, step, kw)
            post = self.program.rows(setup_state)
        del setup_state, step
        free(self.dev)
        self.check_train(post)

    def replay_event(self, state, step, kw):
        """The window's first pass made again from the set-up state, after
        the close: its event's clones, splits and pruned rows (pruned: the
        live rows before, plus clones and splits, less the live rows
        after) in the notes."""
        sched = Schedule(self.mix, self.seed + 1, self.world, self.rank)
        info = None
        for _ in range(self.n_poses):
            i = sched.next_batch()[0]
            state = step(state, self.program.upload(self.cams[i], self.dev),
                         self.bg)[0]
            state, info = self.event(state, kw)
            if info is not None:
                break
        if info is None:
            self.r.notes.append("the window's first pass, made again after "
                                "the close, reached no event")
            return
        c, s, live0, live1 = (int(x) for x in self.event_counts(info, kw))
        self.r.event_counts = (c, s, live0 + c + s - live1)
        self.r.notes.append(
            f"the window's first event, made again after the close "
            f"(clones, splits, pruned): {self.r.event_counts}; live rows "
            f"{live0} -> {live1}")

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
        """The parameters again from the seed, and a pose's record
        (``raster.ViewRecord``) on the device: its reference view, and the
        ground truth, alpha mask, inverse depth and depth mask the
        program's upload fed it (all-ones alpha where the scene gives no
        mask; no depth where it gives none)."""
        p = scene.make(self.cfg, self.seed, self.dev, 1, self.cell.root)[0]

        def host(a):
            return torch.tensor(a, dtype=torch.float32, device=self.dev)

        def record(i):
            R, T = self.poses[i]
            mask = (np.ones((1, self.H, self.W), np.float32)
                    if self.masks is None else self.masks[i])
            inv, dmask = ((None, None) if self.depth is None else
                          (host(self.depth[0][i]), host(self.depth[1][i])))
            return ViewRecord(scene.view(R, T, *self.fov, self.dev),
                              host(self.gt[i]), i, host(mask), inv, dmask)
        return p, record

    def reference_train(self, p0, record, tf32: bool = False):
        """The reference's readings of the check steps (its control with
        ``tf32``)."""
        kw = dict(stats=True) if self.events else {}
        return self.ref.train_steps(
            p0, [[record(i)] for i in self.check_poses], W=self.W, H=self.H,
            bg=self.bg, sh_degree=self.sh, extent=self.extent,
            opt=self.cfg["optimization"], first_step=self.cfg["first_step"],
            prod=self.ref.Products(tf32),
            reduce=self.all_reduce or (lambda ts: ts), batch=self.world,
            options=self.options, **kw)

    def reference_event(self, rows: dict, tf32: bool = False):
        """The reference's densify event on ``rows`` with the run's split
        draws: (rows after, counts)."""
        it = self.cfg["first_step"] + self.mix["check_steps"]
        return self.ref.densify(
            rows, self.noise, extent=self.extent,
            opt=self.cfg["optimization"],
            screen_size_prune=it > self.cfg["optimization"][
                "opacity_reset_interval"],
            prod=self.ref.Products(tf32))

    def reference_rows(self, steps) -> dict:
        """A reference state after the check steps as rows of the
        configuration's capacity (``program.rows``' names), the rows past
        its splats dead and zero."""
        n = steps.params["xyz"].shape[0]
        cap = max(self.capacity, n)
        rows = {"active": check.pad(torch.ones(n, dtype=torch.bool,
                                                device=self.dev), cap)}
        for k, v in steps.params.items():
            rows[k] = check.pad(v, cap)
            rows[f"mu.{k}"] = check.pad(steps.mu[k], cap)
            rows[f"nu.{k}"] = check.pad(steps.nu[k], cap)
        for k, v in steps.stats.items():
            rows[k] = check.pad(v, cap)
        return rows

    def train_numbers(self, p0, record, post=None):
        """The check's numbers of the program's readings against the
        reference's, and the reference's readings. ``post``: the
        program's rows after the check steps' densify event."""
        got = self.reference_train(p0, record)
        nums = check.train_numbers(self.program_readings, got)
        if self.events and self.event_pre is None:
            nums.update(count_rows_gap=math.inf, radii_gap=math.inf,
                        accum_gap=math.inf, live_rows_gap=math.inf,
                        densify_gap=math.inf)
        elif self.events:
            pre = {k: v.to(self.dev) for k, v in self.event_pre.items()}
            nums.update(check.stats_numbers(pre, got.stats))
            ref_rows, n = self.reference_event(pre)
            del pre
            self.r.notes.append(f"check event: {n}")
            self.r.check_event = n
            nums.update(check.densify_numbers(post, ref_rows))
        return nums, got

    def control_numbers(self, p0, record, ref) -> dict:
        """The control's numbers: the reference with its products in TF32
        in the program's place, against the reference ``ref``; with events,
        its own state's event in TF32 against the reference's event on
        that state."""
        ctrl = self.reference_train(p0, record, tf32=True)
        nums = check.train_numbers(dict(loss=ctrl.loss,
                                        grad_norm=ctrl.grad_norm,
                                        change_norm=ctrl.change_norm), ref)
        if self.events:
            nums.update(check.stats_numbers(ctrl.stats, ref.stats))
            rows = self.reference_rows(ctrl)
            got = self.reference_event(rows, tf32=True)[0]
            nums.update(check.densify_numbers(
                got, self.reference_event(rows)[0]))
        return nums

    def check_train(self, post=None):
        t = time.perf_counter()
        p0, record = self.reference_inputs()
        nums, got = self.train_numbers(p0, record, post)
        self.r.notes.append(f"reference: {time.perf_counter() - t:.2f} s, "
                            f"pairs {[f.pairs for f in got.frames]}, "
                            f"contributing "
                            f"{[f.contributing for f in got.frames]}")
        self.reference_readings = got
        self.r.checks = check.judge(nums, self.cell.limits)
        self.r.ok = (self.program_readings["bad"] == 0
                     and all(c["value"] <= c["limit"]
                             for c in self.r.checks.values()))
        if self.traced:
            self.r.views = self.count_views(p0, record, self.traced_views)

    def count_views(self, p0, record, poses):
        """What each traced view needs, from the reference's walk of it at
        the set-up parameters."""
        n_tiles = (-(-self.W // 32)) * (-(-self.H // 32))
        seen = {}
        with torch.no_grad():
            for i in set(poses):
                f = self.ref.render(p0, record(i).view, self.W, self.H,
                                    self.bg, self.sh, self.ref.Products(False),
                                    options=self.options)
                seen[i] = counts.FrameCount(f.pairs, f.bwd_rows,
                                            f.contributing, n_tiles,
                                            self.W * self.H)
        return [seen[i] for i in poses]

    # ---- rendering ------------------------------------------------------
    def setup_render(self):
        """Inputs and right-sizing (which renders every pose once). Returns
        (splats, views, rasterizer config, the poses the check samples)."""
        p = self.inputs()
        g = self.program.gaussians(p, self.sh, self.capacity)
        rcfg, views = self.right_size(g)
        rng = np.random.default_rng(self.seed)
        sample = sorted(int(i) for i in rng.choice(
            self.n_poses, min(self.mix["check_frames"], self.n_poses),
            replace=False))
        return g, views, rcfg, sample

    def reference_frames(self, p0, record, poses, tf32: bool = False):
        """{pose: (image, inverse depth, radii)} of the reference (its
        control with ``tf32``)."""
        out = {}
        with torch.no_grad():
            for i in poses:
                f = self.ref.render(p0, record(i).view, self.W, self.H,
                                    self.bg, self.sh, self.ref.Products(tf32),
                                    options=self.options)
                out[i] = (f.image, f.invdepth, f.radius)
        return out

    def run_render(self):
        prog, mix = self.program_module(), self.mix
        g, views, rcfg, sample = self.setup_render()
        aa = self.options["antialiasing"]
        kept = {}
        ovf_dev = torch.zeros((), dtype=torch.long, device=self.dev)
        bad_dev = torch.zeros((), dtype=torch.long, device=self.dev)
        k = 0

        def one():
            nonlocal ovf_dev, bad_dev, k
            i = k % self.n_poses
            t = time.perf_counter()
            with torch.profiler.record_function("splatbench.frame"):
                out = prog.frame(g, views[i], self.W, self.H, self.bg, rcfg,
                                 aa)
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
                out = prog.frame(g, views[i], self.W, self.H, self.bg, rcfg,
                                 aa)
                kept[i] = (out.image, out.invdepth, out.radii)
        got = {i: kept[i] for i in sample}
        del g, views, kept
        free(self.dev)
        t = time.perf_counter()
        p0, record = self.reference_inputs()
        ref = self.reference_frames(p0, record, sample)
        self.r.notes.append(f"reference: {time.perf_counter() - t:.2f} s")
        self.reference_readings = ref
        nums = check.frame_numbers(got, ref)
        self.r.checks = check.judge(nums, self.cell.limits)
        self.r.ok = all(c["value"] <= c["limit"]
                        for c in self.r.checks.values())
        if self.traced:
            self.r.views = self.count_views(p0, record, traced)

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
        densify_s=r.densify_s,
        peak_window_bytes=r.peak_window, n_splats=cell.config["gaussians"],
        counts=counts, trace=trace)
