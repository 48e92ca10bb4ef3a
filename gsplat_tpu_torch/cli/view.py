"""Interactive viewer CLI: load a trained model and serve the orbit-camera
web viewer (viewer/web.py), rendering on ``--device`` (default ``cuda``).
Same flags as gsplat_tpu/cli/view.py, plus ``--device``."""
from __future__ import annotations

import os
import sys
from argparse import ArgumentParser


def _latest_iteration(model_path: str) -> int:
    root = os.path.join(model_path, "point_cloud")
    iters = [int(d.split("_")[-1]) for d in os.listdir(root)
             if d.startswith("iteration_")]
    if not iters:
        raise FileNotFoundError(f"no point_cloud/iteration_* under {model_path}")
    return max(iters)


def main(argv=None):
    from gsplat_tpu_torch.utils.general import resolve_device

    parser = ArgumentParser(description="Interactive model viewer")
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8090)
    parser.add_argument("--white_background", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    device = resolve_device(args.device)

    it = args.iteration if args.iteration != -1 \
        else _latest_iteration(args.model_path)
    ply = os.path.join(args.model_path, "point_cloud", f"iteration_{it}",
                       "point_cloud.ply")
    print(f"Loading {ply}")

    from gsplat_tpu_torch.viewer.web import (ViewerServer,
                                             load_gaussians_from_ply)
    g = load_gaussians_from_ply(ply, device=device)
    bg = (1.0, 1.0, 1.0) if args.white_background else (0.0, 0.0, 0.0)
    server = ViewerServer(g, host=args.ip, port=args.port, background=bg,
                          device=device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
