"""The host-side training loop around the train step. Counterpart of
gsplat_tpu/train/loop.py.

It follows the reference trainer: a random camera order without replacement
per epoch (Python's ``random``, as the JAX loop draws it), test, save and
checkpoint hooks, progress reporting; and the host duties of the padded
buffers: growing the gaussian capacity when a densify event runs out of
slots, and the pair-list capacity (``pairs_per_gaussian``) grown with a
retry of the frame from the pre-step state when a frame overflows, and
shrunk when it is over-provisioned.

Where JAX's loop splits one ``PRNGKey(0)`` per random draw (the random
background, the split samples of a densify event), the port draws from one
``torch.Generator`` seeded 0 on the training device. The step, the densify
event and the opacity reset are looked up on ``trainer`` at call time, so a
caller can wrap them. The loop reads the loss, the overflow and the number
of live gaussians on the host every iteration, as JAX's does.

Branches. Without a process group, ``shard_gaussians`` with
``n_shards > 1`` holds the state in ``n_shards`` row shards in this one
process and each step runs ``parallel/sharded.py:make_sharded_train_step``
over them (JAX takes the mesh size as the shard count). Under a process
group of more than one rank (one per card, ``parallel/mesh.py``):

- ``data_parallel`` alone trains a batch of one camera per rank each step
  (``parallel/dp.py:make_dp_train_step``), every rank holding the whole
  state;
- ``shard_gaussians`` alone shards the ``prim`` axis over the whole world:
  each rank holds ITS rows of every per-gaussian tensor and renders its
  band (``make_sharded_train_step`` on ``RankParts(mesh, "prim")``);
- both lay out JAX's 2-D mesh, ``data`` 2 x ``prim`` world // 2 (at least
  4 ranks, an even count), the step
  ``make_sharded_dp_train_step``.

``n_shards > 1`` under a group raises (it is the one-process form). Every
rank draws the same batch (Python's ``random``, JAX's batch filling line
for line) and takes its own row; the retry, shrink and growth decisions
read all-reduced values, so every rank takes the same branch. Densify,
opacity reset and capacity growth work on a rank's rows
(``densify_and_prune(parts=)``, ``parallel/rows.py:grow_rows``), with the
one-process result. Rank 0 alone writes files (``Scene``'s ``input.ply``
and ``cameras.json``, saves, checkpoints, telemetry, the debug snapshot
with the whole batch) and reports evaluation, while the other ranks wait
for it in a ``parallel/mesh.py:Hold`` (no deadline of the steps' group runs
meanwhile); under rank-sharded storage its writes first gather the rows to
its host, shard by shard, so the files are a one-process run's, and every
rank renders the evaluation views through the sharded render. Every rank
reads the scene and a checkpoint and keeps its rows. A world of one
changes nothing, as JAX on one device; one process that sees several
cards raises (JAX takes every local device in one process; the port takes
one process per card, from ``torchrun``). A ``network_gui_server``
(viewer/network_gui.py) is polled at the top of every iteration, as in JAX;
an error of its render raises out of ``train``. Under a process group rank
0 alone serves it, and the other ranks wait in the Hold while its client
keeps training paused or keeps the last iteration alive; under
rank-sharded storage they render every frame with it instead
(``network_gui.RankFrames``: rank 0 sends each request over the Hold's
group, every prim line renders it through the sharded render, and rank 0
answers), until rank 0's poll ends.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
import random
import time
from typing import Optional

import torch

from gsplat_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                     PipelineConfig, RasterizerConfig)
from gsplat_tpu_torch.models import gaussian_model as gm
from gsplat_tpu_torch.ops import losses
from gsplat_tpu_torch.ops.rasterize import render
from gsplat_tpu_torch.parallel import LocalParts, RankParts
from gsplat_tpu_torch.parallel import dp as dp_lib
from gsplat_tpu_torch.parallel import mesh as mesh_lib
from gsplat_tpu_torch.parallel import rows as rows_lib
from gsplat_tpu_torch.parallel import sharded as sharded_lib
from gsplat_tpu_torch.scene import Scene
from gsplat_tpu_torch.train import checkpoint as ckpt_lib
from gsplat_tpu_torch.train import trainer
from gsplat_tpu_torch.utils.general import Timer, resolve_device
from gsplat_tpu_torch.utils.telemetry import Telemetry
from gsplat_tpu_torch.viewer import network_gui


def _round_up(x, m):
    return -(-x // m) * m


def fill_batch(cam, viewpoint_stack, train_cams, data_batch):
    """``cam`` and ``data_batch - 1`` more cameras of its resolution, taken
    from ``viewpoint_stack`` (by position: a camera holds numpy arrays, so
    == is not usable) with Python's ``random``, the stack refilled from
    ``train_cams`` when it runs dry mid-batch and drawn on WITHOUT
    replacement: JAX's batch filling (gsplat_tpu/train/loop.py), the same
    draws in the same order."""
    W, H = cam.width, cam.height
    batch = [cam]
    rest_idx = [i for i, c in enumerate(viewpoint_stack)
                if (c.width, c.height) == (W, H)]
    random.shuffle(rest_idx)
    for i in sorted(rest_idx[:data_batch - 1], reverse=True):
        batch.append(viewpoint_stack.pop(i))
    while len(batch) < data_batch:
        viewpoint_stack.extend(train_cams)
        idxs = [i for i, c in enumerate(viewpoint_stack)
                if (c.width, c.height) == (W, H)]
        random.shuffle(idxs)
        for i in sorted(idxs[:data_batch - len(batch)], reverse=True):
            batch.append(viewpoint_stack.pop(i))
    return batch


def train(dataset: ModelConfig, opt: OptimizationConfig, pipe: PipelineConfig,
          rcfg: RasterizerConfig, testing_iterations, saving_iterations,
          checkpoint_iterations, start_checkpoint: Optional[str] = None,
          network_gui_server=None, quiet: bool = False,
          capacity_multiplier: float = 4.0, data_parallel: bool = False,
          checkpoint_interval: int = 0, shard_gaussians: bool = False,
          shard_transient: str = "replicated", *, device="cuda",
          n_shards: int = 1):
    """Run the full optimization on ``device``. Returns (scene, state)."""
    dev = resolve_device(device)
    rank, n_ranks = mesh_lib.world()
    if n_shards > 1 and not shard_gaussians:
        raise ValueError("n_shards > 1 needs shard_gaussians")
    if n_shards > 1 and n_ranks > 1:
        raise ValueError(
            f"n_shards={n_shards} keeps the row shards in one process; under "
            f"a process group of {n_ranks} ranks shard_gaussians puts one "
            f"shard on each rank: torchrun --nproc_per_node=N train_torch.py "
            f"--shard_gaussians")
    if n_ranks > 1 and not (data_parallel or shard_gaussians):
        raise ValueError(f"a process group of {n_ranks} ranks trains with "
                         "data_parallel (one camera per rank and step) or "
                         "shard_gaussians (one row shard per rank)")
    # one part of the gaussians' storage per rank (parallel/sharded.py)
    ranked = n_ranks > 1 and shard_gaussians
    if ranked and data_parallel and (n_ranks < 4 or n_ranks % 2):
        raise ValueError(f"the data x prim mesh needs at least 4 ranks and "
                         f"an even count, got {n_ranks}")
    if (data_parallel and n_ranks == 1 and dev.type == "cuda"
            and torch.cuda.device_count() > 1):
        raise ValueError(
            f"data_parallel in one process that sees "
            f"{torch.cuda.device_count()} cards: start one process per card "
            "with torchrun --nproc_per_node=N")
    if network_gui_server is not None and rank != 0:
        raise ValueError("the viewer bridge is served by rank 0 alone")
    writer = rank == 0
    # where rank 0 works alone (its writes below, the bridge's frames) the
    # other ranks wait for it here, not in a collective of the next step
    hold = mesh_lib.Hold() if n_ranks > 1 else None
    # the ranks wait at the top of every iteration while rank 0 serves a
    # viewer client, which may keep training paused
    hold_for_bridge = hold is not None and hold.from_rank0(
        network_gui_server is not None)

    # ---- the mesh: camera data parallelism and / or gaussian-sharded
    # storage over the ranks, or row shards in this process ----
    mesh, data_batch = None, 1
    if ranked:
        data_batch = 2 if data_parallel else 1
        mesh = mesh_lib.make_mesh(
            (("data", 2), ("prim", -1)) if data_parallel
            else (("prim", -1),))
        parts = RankParts(mesh, "prim")
    else:
        parts = LocalParts(n_shards if shard_gaussians else 1)
        if data_parallel and n_ranks > 1:
            data_batch = n_ranks
            mesh = mesh_lib.make_mesh((("data", n_ranks),))
    # under rank-sharded storage every rank renders the client's frames
    bridge_ranks = (network_gui.RankFrames(hold, parts,
                                           transient=shard_transient)
                    if ranked and hold_for_bridge else None)
    n_prim = parts.n
    data_coord = mesh.coords.get("data", 0) if mesh is not None else 0
    if data_batch > 1:
        print(f"camera data-parallel training over {data_batch} "
              + ("data lines" if ranked else "ranks"))

    # every rank reads the scene; rank 0 alone writes its input.ply and
    # cameras.json (a Scene without a model path writes nothing)
    scene = Scene(dataset if writer
                  else dataclasses.replace(dataset, model_path=""),
                  dataset.sh_degree, capacity=0, device=dev)
    n0 = scene.gaussians.num_active()
    cap0 = _round_up(max(int(n0 * capacity_multiplier), 1024), 1024)
    scene.gaussians = gm.pad_to_capacity(scene.gaussians, cap0)

    train_cams = scene.getTrainCameras()
    first_iter = 0
    if start_checkpoint:
        # under rank-sharded storage every rank reads the file on its host
        # and keeps its rows
        at = "cpu" if ranked else dev
        if os.path.isdir(start_checkpoint):
            # a manager directory (--checkpoint_interval output)
            mngr = ckpt_lib.AsyncCheckpointManager(start_checkpoint)
            state, first_iter = mngr.restore_latest(device=at)
            mngr.close()
        else:
            state, first_iter = ckpt_lib.load_checkpoint(start_checkpoint,
                                                         device=at)
        print(f"Resumed from {start_checkpoint} at iteration {first_iter}")
    elif ranked:
        # this rank's rows of the point cloud's gaussians; its moments and
        # statistics are made at its size
        g = scene.gaussians
        g = gm.pad_to_capacity(g, _round_up(g.capacity, n_prim))
        rows = sharded_lib.own_rows(parts, g.capacity)
        state = trainer.init_state(dataclasses.replace(g, **{
            k: getattr(g, k)[rows].clone() for k in gm.TENSOR_FIELDS}),
            len(train_cams))
    else:
        state = trainer.init_state(scene.gaussians, len(train_cams))

    bg_color = torch.tensor([1.0, 1.0, 1.0] if dataset.white_background
                            else [0.0, 0.0, 0.0], dtype=torch.float32,
                            device=dev)
    use_sparse_adam = opt.optimizer_type == "sparse_adam"
    use_depth = any(c.invdepthmap is not None for c in train_cams)
    spatial_lr_scale = float(scene.cameras_extent)
    step_kw = dict(opt=opt, spatial_lr_scale=spatial_lr_scale,
                   antialiasing=pipe.antialiasing,
                   use_sparse_adam=use_sparse_adam,
                   train_test_exp=dataset.train_test_exp, use_depth=use_depth)

    # ---- gaussian-sharded storage (parallel/sharded.py) ----
    if n_prim > 1 and (start_checkpoint or not ranked):
        state = ckpt_lib.grow_capacity(
            state, _round_up(state.gaussians.capacity, n_prim))
        state = sharded_lib.shard_state(state, parts)
        if ranked:
            state = trainer.to_device(state, dev)
    if ranked:
        scene.gaussians = state.gaussians
    if n_prim > 1:
        rows_per = state.gaussians.capacity // len(parts.mine)
        print(f"gaussian-sharded training over {n_prim} "
              + ("ranks" if ranked else "shards")
              + f" ({rows_per} rows/shard)"
              + (f" x {data_batch} camera-DP" if data_batch > 1 else ""))

    # the step's factory, given each frame's size and pair capacity; None:
    # trainer.train_step
    make_step = None
    if ranked and data_parallel:
        make_step = functools.partial(
            sharded_lib.make_sharded_dp_train_step, mesh,
            transient=shard_transient)
    elif n_prim > 1:
        make_step = functools.partial(sharded_lib.make_sharded_train_step,
                                      parts if ranked else n_prim,
                                      transient=shard_transient)
    elif mesh is not None:
        make_step = functools.partial(dp_lib.make_dp_train_step, mesh)

    def n_live(st) -> int:
        """The live gaussians of the whole state."""
        if ranked:
            return int(parts.psum_value([st.gaussians.active.sum()]))
        return st.gaussians.num_active()

    def on_host(st):
        """The whole state for rank 0's writes: under rank-sharded storage
        its rows gathered to rank 0's host (the ranks of data line 0 take
        part; None elsewhere)."""
        if not ranked:
            return st
        if data_coord:
            return None
        return rows_lib.gather_to_host(st, parts, hold.group)

    viewpoint_stack = []
    ema_loss = 0.0
    ema_depth = 0.0
    pair_ema = None
    ppg_floor = 4.0    # raised after overflow-grows (shrink hysteresis)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    timer = Timer()
    telemetry = Telemetry(scene.model_path if writer else None)
    t_iter = time.time()
    # periodic checkpoints written on a background thread
    # (--checkpoint_interval), beside the synchronous
    # --checkpoint_iterations snapshots
    ckpt_mngr = None
    if checkpoint_interval > 0 and writer:
        ckpt_mngr = ckpt_lib.AsyncCheckpointManager(
            os.path.join(scene.model_path, "checkpoints"))

    for iteration in range(first_iter + 1, opt.iterations + 1):
        if network_gui_server is not None:
            network_gui_server.poll(state, scene, pipe, rcfg, bg_color,
                                    iteration, opt.iterations,
                                    dataset.train_test_exp,
                                    ranks=bridge_ranks)
        elif bridge_ranks is not None:
            bridge_ranks.follow(state, rcfg, pipe, bg_color, dev)
        if hold_for_bridge and bridge_ranks is None:
            hold.wait()

        if not viewpoint_stack:
            viewpoint_stack = list(scene.getTrainCameras())
        cam = viewpoint_stack.pop(random.randint(0, len(viewpoint_stack) - 1))

        H, W = cam.height, cam.width
        if opt.random_background:
            bg = torch.rand(3, generator=gen, device=dev)
        else:
            bg = bg_color

        # the frame's images go to the device every iteration: with a
        # batch, every rank draws the same batch and uploads its own row
        if data_batch > 1:
            batch = fill_batch(cam, viewpoint_stack, scene.getTrainCameras(),
                               data_batch)
            cam = batch[data_coord]
        view, gt, amask, inv_gt, dmask = dp_lib.camera_inputs(cam, dev)

        def run_step(s):
            kw = dict(image_width=W, image_height=H, rcfg=rcfg, **step_kw)
            if make_step is None:
                return trainer.train_step(s, view, gt, amask, inv_gt, dmask,
                                          bg, **kw)
            return make_step(**kw)(s, view, gt, amask, inv_gt, dmask, bg)

        prev_state = state        # the step returns a new state
        state, aux = run_step(state)

        # ---- adaptive pair-list capacity: overflow retry ----
        # A truncated frame trained on garbage gradients. Grow the capacity
        # and redo the step FROM THE PRE-STEP STATE: params, Adam moments
        # and the frame's densification stats are all rolled back, then the
        # retry applies the one true update. Runs before densification so a
        # densify event never acts on the corrupted stats.
        retry = 0
        while int(aux.overflow) > 0:
            retry += 1
            if retry > 4:   # growth is exponential; 4 doublings = 16x
                raise RuntimeError(
                    f"[iter {iteration}] pair list still overflows after "
                    f"{retry - 1} grow-retries (pairs_per_gaussian="
                    f"{rcfg.pairs_per_gaussian:.1f}) — a retry that still "
                    "truncates must never be committed (garbage gradients)")
            n_act = max(n_live(state), 1)
            pairs_pg = int(aux.num_pairs) / n_act
            rcfg = dataclasses.replace(
                rcfg, pairs_per_gaussian=max(rcfg.pairs_per_gaussian * 2,
                                             pairs_pg * 1.5))
            # hysteresis: the overflow also covers the chunk-padding
            # budget, whose need does not track the pair count: never
            # shrink back into the same overflow
            ppg_floor = max(ppg_floor, rcfg.pairs_per_gaussian * 0.55)
            print(f"[iter {iteration}] pair overflow {int(aux.overflow)} — "
                  f"pairs_per_gaussian → {rcfg.pairs_per_gaussian:.1f}; "
                  f"retrying frame from pre-step state")
            state, aux = run_step(prev_state)

        # ---- --debug failure snapshot ----
        loss_now = float(aux.loss)
        if pipe.debug and not math.isfinite(loss_now):
            from gsplat_tpu_torch.utils.debug import dump_snapshot
            path = os.path.join(dataset.model_path or ".",
                                f"snapshot_iter{iteration}.npz")
            # exactly what the failing step consumed: with a batch, every
            # rank's camera and images (every rank drew the whole batch)
            snap = on_host(prev_state)
            if writer:
                inputs = (dp_lib.stack_camera_batch(batch, dev)
                          if data_batch > 1
                          else (view, (gt, amask, inv_gt, dmask)))
                dump_snapshot(path, snap, *inputs, iteration,
                              reason=f"non-finite loss {loss_now}")
            raise FloatingPointError(
                f"[iter {iteration}] non-finite loss {loss_now}; step inputs "
                f"dumped to {path} (replay with python -m "
                f"gsplat_tpu_torch.tools.debug_nan --snapshot {path})")

        # ---- densification, capacity growth, opacity reset ----
        if iteration < opt.densify_until_iter:
            if (iteration > opt.densify_from_iter
                    and iteration % opt.densification_interval == 0):
                use_ss = iteration > opt.opacity_reset_interval
                state, ovf = trainer.densify_step(
                    state, gen, float(scene.cameras_extent), opt=opt,
                    use_screen_size_prune=use_ss,
                    **(dict(parts=parts) if ranked else {}))
                ovf = int(ovf)
                if ovf > 0:
                    cap = parts.total_rows(state.gaussians.capacity)
                    new_cap = _round_up(cap + max(ovf, cap), 1024)
                    new_cap = _round_up(new_cap, n_prim)
                    print(f"[iter {iteration}] capacity {cap} → {new_cap} "
                          f"(overflow {ovf})")
                    if ranked:
                        state = rows_lib.grow_rows(state, parts, new_cap)
                    else:
                        state = ckpt_lib.grow_capacity(state, new_cap)
                        state = sharded_lib.shard_state(state, parts)
            if (iteration % opt.opacity_reset_interval == 0
                    or (dataset.white_background
                        and iteration == opt.densify_from_iter)):
                state = trainer.opacity_reset_step(state)

        depth_f = float(aux.depth_l1)
        ema_loss = 0.4 * loss_now + 0.6 * ema_loss
        ema_depth = 0.4 * depth_f + 0.6 * ema_depth

        # scalar telemetry (the reference trainer's report)
        now = time.time()
        n_act = n_live(state)
        telemetry.scalars(
            iteration,
            **{"train_loss_patches/l1_loss": float(aux.l1),
               "train_loss_patches/total_loss": loss_now,
               "train_loss_patches/depth_l1": depth_f,
               "iter_time": now - t_iter,
               "total_points": n_act,
               "num_pairs": int(aux.num_pairs)})
        t_iter = now

        # ---- adaptive pair-list capacity: shrink when over-provisioned ----
        # Binning fills m_cap static slots, so its cost follows the
        # capacity: track the real pair count and keep the capacity ~1.5x
        # above it. Iteration 1 also fires: the configured default can be
        # ~10x the scene's real pair count (an under-shrink from one frame
        # corrects itself through the overflow retry and the floor).
        pairs_pg = int(aux.num_pairs) / max(n_act, 1)
        pair_ema = pairs_pg if pair_ema is None else \
            0.1 * pairs_pg + 0.9 * pair_ema
        if ((iteration == 1 or iteration % 500 == 0)
                and rcfg.pairs_per_gaussian > ppg_floor
                and rcfg.pairs_per_gaussian > 2.5 * pair_ema):
            new_ppg = max(pair_ema * 1.5, ppg_floor)
            print(f"[iter {iteration}] shrinking pairs_per_gaussian "
                  f"{rcfg.pairs_per_gaussian:.1f} → {new_ppg:.1f}")
            rcfg = dataclasses.replace(rcfg, pairs_per_gaussian=new_ppg)

        if not quiet and iteration % 10 == 0:
            print(f"[{iteration}/{opt.iterations}] loss={ema_loss:.5f} "
                  f"depth={ema_depth:.5f} n={n_act} "
                  f"({timer.elapsed():.0f}s)", flush=True)

        evaluating = iteration in testing_iterations
        saving = iteration in saving_iterations
        checkpointing = iteration in checkpoint_iterations
        managed = checkpoint_interval > 0 \
            and iteration % checkpoint_interval == 0
        if evaluating and ranked:
            # every rank renders its band of each view; rank 0 reports
            report_eval(scene, state, rcfg, pipe, bg_color, iteration,
                        dataset.train_test_exp,
                        telemetry=telemetry if writer else None,
                        parts=parts, quiet=not writer)
        elif evaluating and writer:
            report_eval(scene, state, rcfg, pipe, bg_color, iteration,
                        dataset.train_test_exp, telemetry=telemetry)
        host = on_host(state) if (saving or checkpointing or managed) \
            else None
        if writer and saving:
            print(f"\n[ITER {iteration}] Saving Gaussians")
            scene.gaussians = host.gaussians
            scene.save(iteration, exposures=host.exposure.cpu().numpy()
                       if dataset.train_test_exp else None)
            scene.gaussians = state.gaussians
        if writer and checkpointing:
            print(f"\n[ITER {iteration}] Saving Checkpoint")
            ckpt_lib.save_checkpoint(
                os.path.join(scene.model_path, f"chkpnt{iteration}.npz"),
                host, iteration)
        if ckpt_mngr is not None and managed:
            ckpt_mngr.save(iteration, host)
        del host
        if hold is not None and (evaluating or saving or checkpointing
                                 or managed):
            hold.wait()

    scene.gaussians = state.gaussians
    if dev.type == "cuda":           # this process's allocator peaks, MiB
        telemetry.scalars(
            opt.iterations,
            peak_allocated_mib=torch.cuda.max_memory_allocated(dev) / 2**20,
            peak_reserved_mib=torch.cuda.max_memory_reserved(dev) / 2**20)
    telemetry.close()
    if ckpt_mngr is not None:
        ckpt_mngr.close()
    return scene, state


@torch.no_grad()
def report_eval(scene, state, rcfg, pipe, bg_color, iteration,
                train_test_exp=False, telemetry=None, parts=None,
                quiet=False):
    """Mean L1 and PSNR over the test cameras and over train cameras 5,
    10, ..., 25 (modulo their count), printed (unless ``quiet``) and
    logged. With ``parts`` (a ``RankParts``) the state is this rank's rows
    and every rank of the axis renders the views through the sharded
    render (its image is the single render's: tiles are independent)."""
    dev = state.gaussians.device
    train_cams = scene.getTrainCameras()
    configs = [("test", scene.getTestCameras()),
               ("train", [train_cams[idx % len(train_cams)]
                          for idx in range(5, 30, 5)])]
    for name, cams in configs:
        if not cams:
            continue
        l1_sum, psnr_sum = 0.0, 0.0
        for cam in cams:
            if parts is not None:
                out = sharded_lib.make_sharded_render(
                    parts, image_width=cam.width, image_height=cam.height,
                    cfg=rcfg, antialiasing=pipe.antialiasing)(
                        state.gaussians, cam.view(dev), bg_color)
            else:
                out = render(state.gaussians, cam.view(dev), cam.width,
                             cam.height, bg_color, rcfg,
                             antialiasing=pipe.antialiasing)
            img = torch.clamp(out.image, 0.0, 1.0)
            gt = torch.clamp(torch.tensor(cam.image, device=dev), 0.0, 1.0)
            if train_test_exp:
                img = img[..., img.shape[-1] // 2:]
                gt = gt[..., gt.shape[-1] // 2:]
            l1_sum += float(losses.l1_loss(img, gt))
            psnr_sum += float(losses.psnr(img[None], gt[None]).mean())
        if not quiet:
            print(f"\n[ITER {iteration}] Evaluating {name}: "
                  f"L1 {l1_sum / len(cams):.6f} PSNR "
                  f"{psnr_sum / len(cams):.3f}")
        if telemetry is not None:
            telemetry.scalars(iteration,
                              **{f"{name}/loss_viewpoint - l1_loss":
                                 l1_sum / len(cams),
                                 f"{name}/loss_viewpoint - psnr":
                                 psnr_sum / len(cams)})
