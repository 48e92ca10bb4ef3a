#!/usr/bin/env python
"""Run the COLMAP conversion pipeline (the PyTorch/CUDA port's copy):
``python convert_torch.py -s <scene> [--resize]``."""
from gsplat_tpu_torch.cli.convert import main

if __name__ == "__main__":
    main()
