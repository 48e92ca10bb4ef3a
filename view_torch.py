#!/usr/bin/env python
"""Serve the web viewer of a trained model with the PyTorch/CUDA port:
``python view_torch.py -m <model_dir> [--port 8090] [--device cpu]``."""
from gsplat_tpu_torch.cli.view import main

if __name__ == "__main__":
    main()
