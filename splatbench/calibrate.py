"""The readings that the check's limits are set from, for one cell, over
many seeds in one process (one a card): the system's numbers against the
reference (the lower readings), the lower-precision control's (the
reference with its products in TF32, in the system's place: the upper
readings), and, with ``--fault``, a planted fault's numbers (a fault of
``splatbench/faults.py`` or of ``splatbench/plants/``).

    python -m splatbench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--control] [--fault <name>] [--out <file.jsonl>]

Each seed's set-up is the benchmark run's (inputs, right-sizing, the first
steps through the window's call), with no window. One JSON line a seed on
standard output, and appended to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from splatbench import run as run_lib


def steps_readings(steps) -> dict:
    return dict(loss=steps.loss, grad_norm=steps.grad_norm,
                change_norm=steps.change_norm)


def calib_rank(rank: int, world: int, args: dict, queue=None):
    import torch.distributed as dist

    from splatbench import check, drive, spec

    cell = spec.cell(args["workload"], Path(args["root"]))
    dev, all_reduce, broadcast_int = run_lib.init_rank(rank, world, args)
    rows = []
    try:
        for seed in args["seeds"]:
            t0 = time.perf_counter()
            R = drive.Run(cell, seed, 0.0, False, dev, rank, world,
                          all_reduce=all_reduce, broadcast_int=broadcast_int)
            prog = R.program_module()
            row = {"seed": seed, "fault": args["fault"] or None}
            if cell.traffic["entry"] == "render":
                g, views, rcfg, sample = R.setup_render()
                got = {}
                for i in sample:
                    o = prog.frame(g, views[i], R.W, R.H, R.bg, rcfg,
                                   R.options["antialiasing"])
                    got[i] = (o.image, o.invdepth, o.radii)
                del g, views
                drive.free(dev)
                p0, record = R.reference_inputs()
                ref = R.reference_frames(p0, record, sample)
                row["program"] = check.frame_numbers(got, ref)
                if args["control"]:
                    row["control"] = check.frame_numbers(
                        R.reference_frames(p0, record, sample, tf32=True),
                        ref)
            else:
                state = R.setup_train()[0]
                post = R.program.rows(state) if R.events else None
                del state
                drive.free(dev)
                p0, record = R.reference_inputs()
                row["program"], ref = R.train_numbers(p0, record, post)
                del post
                row["program_raw"] = {k: R.program_readings[k] for k in
                                      ("loss", "grad_norm", "change_norm")}
                row["reference_raw"] = steps_readings(ref)
                row["pairs"] = [f.pairs for f in ref.frames]
                if args["control"]:
                    row["control"] = R.control_numbers(p0, record, ref)
            row["notes"] = R.r.notes
            row["seconds"] = time.perf_counter() - t0
            del R
            drive.free(dev)
            if rank == 0:
                print(json.dumps(row), flush=True)
                if args["out"]:
                    with open(args["out"], "a") as f:
                        f.write(json.dumps(row) + "\n")
            rows.append(row)
        if rank == 0 and queue is not None:
            queue.put(rows)
    finally:
        if world > 1 and dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default="")
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    from splatbench import spec
    run_lib.cache_dirs(run_lib.ROOT)
    args = dict(workload=a.workload, seeds=[int(s) for s in
                                            a.seeds.split(",")],
                control=a.control, fault=a.fault, out=a.out,
                device=a.device, root=str(run_lib.ROOT))
    run_lib.spawn(calib_rank, spec.cell(a.workload).chips, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
