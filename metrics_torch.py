#!/usr/bin/env python
"""Score rendered test views (SSIM, PSNR, LPIPS) with the PyTorch/CUDA port:
``python metrics_torch.py -m <model_dir> [--device cpu]``."""
from gsplat_tpu_torch.cli.metrics import main

if __name__ == "__main__":
    main()
