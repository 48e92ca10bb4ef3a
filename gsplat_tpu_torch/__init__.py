"""gsplat_tpu_torch — the PyTorch/CUDA port of gsplat_tpu for NVIDIA Hopper.

The module tree mirrors ``gsplat_tpu`` so each counterpart is easy to find:

- ``gsplat_tpu_torch.core``    — camera/projection math, SH basis.
- ``gsplat_tpu_torch.models``  — the padded-capacity Gaussian parameters.
- ``gsplat_tpu_torch.scene``   — COLMAP/Blender readers, cameras, PLY io, Scene.
- ``gsplat_tpu_torch.ops``     — preprocess, binning, entry gather and the tile
                                 compositor (hand-written CUDA kernel on the
                                 card, plain PyTorch on the CPU).
- ``gsplat_tpu_torch.train``   — the train step, densification, Adam, the
                                 host training loop and checkpoints.
- ``gsplat_tpu_torch.cli``     — the train and render entry points.

The package imports ``torch`` and never ``jax`` or ``gsplat_tpu``. Entry
points take an explicit ``device`` that defaults to ``"cuda"``; they raise
when CUDA is absent unless the caller asks for ``"cpu"``.
"""

__version__ = "0.1.0"
