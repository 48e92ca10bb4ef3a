#!/usr/bin/env python
"""Render a trained model with the PyTorch/CUDA port:
``python render_torch.py -m <model_dir> [--device cpu]``."""
from gsplat_tpu_torch.cli.render import main

if __name__ == "__main__":
    main()
