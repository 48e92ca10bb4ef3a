"""The benchmark of ``gsplat_tpu_torch`` on NVIDIA cards: one run of one
cell, a fresh process each time.

    python -m splatbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. It loads, makes its inputs from the seed,
warms up every shape the cell uses (set-up), measures for ``--seconds``
(``--trace 0``: the cell's end-to-end metrics) or also profiles a few steps
after the window (``--trace 1``: its per-layer metrics), checks what the
measured path produced against the plain reference, and prints one JSON
object as its last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each number compared beside its limit (also the last lines
of standard error). A cell of more than one card starts one process per
card (``torch.distributed`` over NCCL, ``tcp://localhost``); rank 0 prints.

Without enough CUDA cards, or when a module of JAX, Flax or the JAX package
is loaded once the window has closed, it prints no result and exits 2.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def cache_dirs(root: Path):
    """The build and kernel caches inside the checkout, at fixed paths."""
    base = root / "build" / "splatbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def _pack(tensors):
    import torch
    return torch.cat([t.reshape(-1).float() for t in tensors])


def _unpack(flat, like):
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def init_rank(rank: int, world: int, args: dict):
    """This rank's device and, over several ranks, the process group:
    (device, all_reduce, broadcast_int), the last two None on one rank.
    ``args['fault']`` names a fault to plant (``splatbench.faults.plant``:
    the tests' and the calibration's, never a benchmark run's)."""
    import torch
    import torch.distributed as dist

    cuda = args["device"] == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    if world > 1:
        # each rank launches its card's work from one thread: no pools of
        # intra-op threads of the ranks' processes competing for the cores
        torch.set_num_threads(1)
        try:
            torch.set_num_interop_threads(1)
        except RuntimeError:    # the pool already runs: it stays as it is
            pass
    all_reduce = broadcast_int = None
    if world > 1:
        os.environ.update(LOCAL_RANK=str(rank), RANK=str(rank),
                          WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method=f"tcp://localhost:{args['port']}",
                                world_size=world, rank=rank)

        def all_reduce(ts):
            flat = _pack(ts)
            dist.all_reduce(flat)
            return _unpack(flat, ts)

        def broadcast_int(v):
            t = torch.tensor([v], dtype=torch.long, device=dev)
            dist.broadcast(t, src=0)
            return int(t)
    if args.get("fault"):
        from splatbench import faults
        faults.plant(args["fault"], Path(args["root"]))
    return dev, all_reduce, broadcast_int


def rank_main(rank: int, world: int, args: dict, queue=None):
    """One rank of a run; rank 0 prints the result (and puts it on
    ``queue``)."""
    import torch.distributed as dist

    from splatbench import drive, spec

    cell = spec.cell(args["workload"], Path(args["root"]))
    dev, all_reduce, broadcast_int = init_rank(rank, world, args)
    try:
        run = drive.Run(cell, args["seed"], args["seconds"], args["trace"],
                        dev, rank, world, t_start=args["t_start"],
                        all_reduce=all_reduce, broadcast_int=broadcast_int)
        r = run.run()
        layer = {}
        if args["trace"]:
            for m in cell.per_layer:
                layer[m["name"]] = spec.reader(m["name"], cell.root)
        mine = dict(
            layer={k: mod.read(drive.layer_context(cell, r, world))
                   for k, mod in layer.items()},
            peak=r.memory_peak,
            busy=r.profile.busy_s() if r.profile is not None else None,
            window=r.profile.window_s if r.profile is not None else None)
        if world > 1:
            every = [None] * world
            dist.all_gather_object(every, mine)
        else:
            every = [mine]
        if rank != 0:
            return
        result = assemble(cell, r, every, world, args, dev, layer)
        bad = drive.banned_modules()
        if bad:
            print(f"modules of JAX or the JAX package are loaded: {bad}",
                  file=sys.stderr, flush=True)
            raise SystemExit(2)
        for note in r.notes:
            print(note, file=sys.stderr)
        for k, c in result["checks"].items():
            print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
                  file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
        if queue is not None:
            queue.put(result)
    finally:
        if world > 1 and dist.is_initialized():
            dist.destroy_process_group()


def assemble(cell, r, every, world, args, dev, layer_mods) -> dict:
    """The result line of rank 0, from every rank's readings."""
    import torch

    from splatbench import drive, trace

    if args["trace"]:
        metrics = {}
        for m in cell.per_layer:
            vals = [e["layer"][m["name"]] for e in every
                    if e["layer"][m["name"]] is not None]
            if not vals:
                continue
            how = getattr(layer_mods[m["name"]], "AGGREGATE", "mean")
            v = max(vals) if how == "max" else sum(vals) / len(vals)
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = drive.e2e_values(cell, r, world)
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": world,
              "memory_peak_bytes": max(e["peak"] for e in every)}
    limit = drive.power_limit(dev)
    if limit:
        device["nvidia_smi"] = limit
    out = {"correct": bool(r.ok), "attempted": r.attempted,
           "failed": r.failed, "metrics": metrics, "device": device}
    if args["trace"] and r.profile is not None:
        busy = [e["busy"] for e in every]
        device["busy_s"] = sum(busy) / len(busy)
        device["window_s"] = r.profile.window_s
        bd = trace.breakdown(r.profile)
        if bd:
            out["breakdown"] = bd
    out["checks"] = r.checks
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(target, chips: int, args: dict):
    """``target(rank, chips, args, queue)`` on every rank: in this process
    for one (unless a fault is planted, which stays in its own process),
    else one spawned process a rank, all waited for. Returns what rank 0
    put on the queue (None if nothing)."""
    if chips == 1 and not args.get("fault"):
        import queue as q
        out = q.Queue()
        target(0, 1, args, out)
        return out.get() if not out.empty() else None
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.SimpleQueue()
    args = dict(args, port=free_port())
    procs = [ctx.Process(target=target, args=(r, chips, args, out))
             for r in range(chips)]
    for p in procs:
        p.start()
    got = None
    while any(p.is_alive() for p in procs) or not out.empty():
        if not out.empty():
            got = out.get()
        else:
            time.sleep(0.05)
    for p in procs:
        p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise SystemExit(f"ranks exited with {codes}")
    return got


def run(workload: str, seed: int, seconds: float, traced: bool, *,
        device: str = "cuda", root: Path = ROOT, fault: str = "",
        t_start: float = None):
    """One run; returns rank 0's result (None where it printed none)."""
    from splatbench import spec
    args = dict(workload=workload, seed=seed, seconds=seconds,
                trace=traced, device=device, root=str(root), fault=fault,
                t_start=t_start if t_start is not None else T_START)
    return spawn(rank_main, spec.cell(workload, root).chips, args)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    # the host launches the device's work from one thread: no pool of
    # intra-op threads competing with it for the host's cores
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    from splatbench import spec
    chips = spec.cell(args.workload, ROOT).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {chips} CUDA card(s); {n} visible",
              file=sys.stderr)
        return 2
    cache_dirs(ROOT)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    return 0 if result is not None else 2


if __name__ == "__main__":
    sys.exit(main())
