"""Training CLI: ``python train_torch.py -s <scene> -m <model>``. The flag
surface of gsplat_tpu/cli/train.py, plus ``--device`` (default ``cuda``)
and ``--shards N`` (the number of row shards ``--shard_gaussians`` keeps in
one process, where the JAX package takes the mesh size).

Several cards run one process per card:

    torchrun --nproc_per_node=N train_torch.py -s <scene> -m <model> \
        --data_parallel                      # one camera per rank
    torchrun --nproc_per_node=N train_torch.py ... --shard_gaussians
                                             # one row shard per rank
    torchrun --nproc_per_node=N train_torch.py ... --shard_gaussians \
        --data_parallel                      # data 2 x prim N/2, N >= 4

Each rank joins the process group first (``parallel/mesh.py``) and trains
on ``cuda:LOCAL_RANK`` (``--device cpu``: gloo on the CPU); rank 0 alone
writes the model directory and binds the viewer bridge, and the other
ranks wait for it while its client keeps training paused, or under
rank-sharded storage render its client's frames with it
(``train/loop.py``). ``--shards`` is the one-process form and raises under
torchrun."""
from __future__ import annotations

import dataclasses
import os
import sys
import uuid
from argparse import ArgumentParser


def main(argv=None):
    import torch

    from gsplat_tpu_torch import config as cfg_lib
    from gsplat_tpu_torch.parallel.mesh import init_distributed, world
    from gsplat_tpu_torch.utils.general import (mkdir_p, resolve_device,
                                                safe_state)

    parser = ArgumentParser(description="Training script parameters")
    cfg_lib.add_model_args(parser)
    cfg_lib.add_optimization_args(parser)
    cfg_lib.add_pipeline_args(parser)
    cfg_lib.add_rasterizer_args(parser)
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--debug_from", type=int, default=-1,
                        help="parsed for the flag surface; not used, as in "
                             "the JAX package")
    parser.add_argument("--detect_anomaly", action="store_true", default=False)
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--disable_viewer", action="store_true", default=False)
    parser.add_argument("--data_parallel", action="store_true", default=False,
                        help="camera data-parallel training over the ranks "
                             "of torchrun (one camera per card per step); "
                             "changes nothing in a world of one")
    parser.add_argument("--shard_gaussians", action="store_true",
                        default=False,
                        help="gaussian-sharded storage training: params, "
                             "optimizer state and stats in row shards, one "
                             "per rank under torchrun, else --shards in "
                             "this process (see SCALING.md)")
    parser.add_argument("--shards", type=int, default=1,
                        help="row shards of --shard_gaussians in one "
                             "process, run one after another on the device "
                             "(1: no sharding); raises under torchrun")
    parser.add_argument("--shard_transient", default="replicated",
                        choices=["replicated", "ring", "slab"],
                        help="sharded-storage render-buffer strategy "
                             "(parallel/sharded.py)")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--checkpoint_interval", type=int, default=0,
                        help="every N iterations, write a checkpoint to "
                             "<model_path>/checkpoints on a background "
                             "thread")
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    args.save_iterations.append(args.iterations)
    # multi-process bring-up before anything else (a no-op without
    # torchrun's environment); under a process group "cuda" is this rank's
    # card
    joined = (not torch.distributed.is_initialized()
              and init_distributed(device=args.device))
    device = resolve_device(args.device)
    rank, n_ranks = world()

    dataset = cfg_lib.extract(cfg_lib.ModelConfig, args)
    opt = cfg_lib.extract(cfg_lib.OptimizationConfig, args)
    pipe = cfg_lib.extract(cfg_lib.PipelineConfig, args)
    rcfg = cfg_lib.extract(cfg_lib.RasterizerConfig, args)

    if not dataset.model_path:
        unique = [os.getenv("OAR_JOB_ID") or str(uuid.uuid4())]
        if n_ranks > 1:          # one directory for every rank: rank 0's
            torch.distributed.broadcast_object_list(unique, src=0)
        dataset = dataclasses.replace(
            dataset, model_path=os.path.join("./output/", unique[0][0:10]))
    print("Optimizing " + dataset.model_path)
    if rank == 0:
        mkdir_p(dataset.model_path)
        cfg_lib.save_cfg(dataset.model_path, {
            "model": dataset, "pipeline": pipe, "optimization": opt,
            "rasterizer": rcfg})

    safe_state(args.quiet)
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    server = None
    if not args.disable_viewer and rank == 0:
        from gsplat_tpu_torch.viewer.network_gui import NetworkGUI
        try:
            server = NetworkGUI(args.ip, args.port, device=device)
        except OSError as e:
            print(f"viewer bridge disabled: {e}")

    from gsplat_tpu_torch.train.loop import train
    try:
        train(dataset, opt, pipe, rcfg, args.test_iterations,
              args.save_iterations, args.checkpoint_iterations,
              args.start_checkpoint, network_gui_server=server,
              quiet=args.quiet, data_parallel=args.data_parallel,
              checkpoint_interval=args.checkpoint_interval,
              shard_gaussians=args.shard_gaussians,
              shard_transient=args.shard_transient, device=device,
              n_shards=args.shards)
    finally:
        if server is not None:
            server.close()
        if joined:
            torch.distributed.destroy_process_group()
    print("\nTraining complete.")


if __name__ == "__main__":
    main()
