#!/usr/bin/env python
"""Train, render and score the standard scenes with the PyTorch/CUDA port:
``python full_eval_torch.py -m360 <dir> -tat <dir> -db <dir> [--device cpu]``."""
from gsplat_tpu_torch.cli.full_eval import main

if __name__ == "__main__":
    main()
