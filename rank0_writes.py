#!/usr/bin/env python3
"""How long rank 0 of a data-parallel run writes alone, while the other
ranks wait for it (``gsplat_tpu_torch/parallel/mesh.py:Hold``).

    python3 rank0_writes.py [--live 3000000] [--capacity 4000000] \\
        [--device cuda] [--out DIR]

Builds a training state of ``--live`` gaussians at SH degree 3 in
``--capacity`` slots (the capacity rounded up to 1024, as the loop's) on
the device, with random parameters, Adam moments and statistics (random
floats compress as poorly as trained ones), and times, on the host clock,
the two writes the loop makes on rank 0 at a save and at a checkpoint
iteration: ``Scene.save`` (compaction and the PLY) and
``train/checkpoint.py:save_checkpoint`` (the state's npz,
``savez_compressed``). Prints the card's name and power limit, one line
per write and a last JSON line with the seconds and the files' sizes. The
files go to a temporary directory (under ``--out`` if given) and are
removed.
"""
import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time
import types

import torch

from gsplat_tpu_torch.models import gaussian_model as gm
from gsplat_tpu_torch.scene import Scene
from gsplat_tpu_torch.train import checkpoint as ckpt_lib
from gsplat_tpu_torch.train import trainer
from gsplat_tpu_torch.utils.general import resolve_device


def random_state(live: int, capacity: int, device) -> "trainer.TrainState":
    g = gm.empty(capacity, 3, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    for name in gm.TRAINABLE_FIELDS:
        t = getattr(g, name)
        t[:live] = torch.randn(t[:live].shape, generator=gen, device=device)
    g.active[:live] = True
    state = trainer.init_state(g, 200)
    for moments in (state.adam.mu, state.adam.nu):
        for t in moments.values():
            t[:live] = torch.rand(t[:live].shape, generator=gen,
                                  device=device)
    for name in ckpt_lib.STATS_FIELDS:
        t = getattr(state.stats, name)
        t[:live] = torch.rand(t[:live].shape, generator=gen, device=device)
    return state


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--live", type=int, default=3_000_000)
    ap.add_argument("--capacity", type=int, default=4_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    capacity = -(-max(args.capacity, args.live) // 1024) * 1024
    state = random_state(args.live, capacity, dev)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    root = tempfile.mkdtemp(dir=args.out)
    try:
        scene = types.SimpleNamespace(gaussians=state.gaussians,
                                      model_path=root)
        t = time.perf_counter()
        Scene.save(scene, 1)
        save_s = time.perf_counter() - t
        ply = os.path.join(root, "point_cloud", "iteration_1",
                           "point_cloud.ply")
        ckpt = os.path.join(root, "chkpnt1.npz")
        t = time.perf_counter()
        ckpt_lib.save_checkpoint(ckpt, state, 1)
        ckpt_s = time.perf_counter() - t
        res = dict(live=args.live, capacity=capacity, save_s=save_s,
                   ply_bytes=os.path.getsize(ply), checkpoint_s=ckpt_s,
                   checkpoint_bytes=os.path.getsize(ckpt),
                   total_s=save_s + ckpt_s)
    finally:
        shutil.rmtree(root)
    print(f"Scene.save: {save_s:.3f} s ({res['ply_bytes']} bytes)")
    print(f"save_checkpoint: {ckpt_s:.3f} s ({res['checkpoint_bytes']} "
          "bytes)")
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
