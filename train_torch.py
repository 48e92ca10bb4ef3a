#!/usr/bin/env python
"""Train a scene with the PyTorch/CUDA port:
``python train_torch.py -s <scene> -m <model_dir> [--device cpu]``."""
from gsplat_tpu_torch.cli.train import main

if __name__ == "__main__":
    main()
