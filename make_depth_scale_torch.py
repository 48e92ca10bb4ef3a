#!/usr/bin/env python
"""Write a COLMAP scene's ``sparse/0/depth_params.json`` with the
PyTorch/CUDA port's tools (no JAX):
``python make_depth_scale_torch.py --base_dir <scene> --depths_dir <dir>``."""
from gsplat_tpu_torch.cli.make_depth_scale import main

if __name__ == "__main__":
    main()
