#!/usr/bin/env python
"""Throughput of the PyTorch/CUDA port's training step on bench.py's
workload: ``python bench_torch.py [--ply <point_cloud.ply>] [--row_cull]
[--device cpu]``. Prints bench.py's one JSON line last."""
from gsplat_tpu_torch.tools.bench import main

if __name__ == "__main__":
    main()
