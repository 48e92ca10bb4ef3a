"""Scene kinds, one module a kind, found by a configuration's
``scene.kind`` (``splatbench.spec.module("scenes", kind)``). A module has
``params(cfg, seed, device)``: the splats' six pre-activation leaves made
from the seed on the device; and may have ``images(cfg, poses, seed,
device)``: each pose's ground truth, a (n, 3, H, W) float32 host array in
[0, 1] (where it has none, the benchmark's colour blocks), ``depths(cfg,
poses, seed)``: each pose's inverse-depth map and its mask, (n, 1, H, W)
float32 host arrays, which the training step's depth loss reads, and
``masks(cfg, poses, seed)``: each pose's alpha mask, a (n, 1, H, W)
float32 host array in [0, 1] that multiplies the rendered image before
the loss (where it has none, all ones)."""
