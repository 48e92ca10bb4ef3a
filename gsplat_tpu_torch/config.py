"""Dataclass configs with CLI reflection (own copy of gsplat_tpu/config.py).

Same flag names, shorthands and defaults as the JAX package, and the same
``cfg_args.json`` snapshot format, so a model directory trained by either
package renders with the other. Only the groups and fields the render and
training paths read are kept; ``load_cfg`` skips groups and fields it does
not know.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from dataclasses import dataclass, field, fields


# Field metadata key marking a flag that also gets a one-letter shorthand.
def _sh(default, **kw):
    return field(default=default, metadata={"shorthand": True, **kw})


@dataclass(frozen=True)
class ModelConfig:
    sh_degree: int = 3
    source_path: str = _sh("")
    model_path: str = _sh("")
    images: str = _sh("images")
    depths: str = _sh("")
    resolution: int = _sh(-1)
    white_background: bool = _sh(False)
    train_test_exp: bool = False
    data_device: str = "cuda"
    eval: bool = False


@dataclass(frozen=True)
class PipelineConfig:
    convert_SHs_python: bool = False   # feed SH colors through colors_precomp
    compute_cov3D_python: bool = False # feed covariances through cov3d_precomp
    debug: bool = False
    antialiasing: bool = False


@dataclass(frozen=True)
class OptimizationConfig:
    """The reference's optimization defaults (opacity_lr is the code's
    0.025, not the 0.05 its README documents)."""
    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.025
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    exposure_lr_init: float = 0.01
    exposure_lr_final: float = 0.001
    exposure_lr_delay_steps: int = 0
    exposure_lr_delay_mult: float = 0.0
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    depth_l1_weight_init: float = 1.0
    depth_l1_weight_final: float = 0.01
    random_background: bool = False
    optimizer_type: str = "default"  # "default" | "sparse_adam"


COMPOSITORS = ("stream", "chunk")
MOMENTS = ("vpu", "mxu")


@dataclass(frozen=True)
class RasterizerConfig:
    """Rasterizer knobs. ``tile_h`` × ``tile_w`` is the binning tile and the
    compositor's block of pixels; ``chunk`` is the entry alignment of each
    tile's range in the entry list (binning pads every tile to it)."""
    tile_h: int = 32
    tile_w: int = 32
    pairs_per_gaussian: float = 12.0   # m_cap = ceil(cap * this / chunk) * chunk
    # Per-tile-row ellipse culling (ops/binning.py): each gaussian expands
    # to its level-set ellipse's exact x-interval per tile row instead of
    # its whole bounding rectangle. Conservative, since the compositor's
    # alpha_min test zeroes every dropped pair, so images agree (up to the
    # regrouping of the chunked transmittance products) while the pair
    # count shrinks. Off by default: on bench.py's 1080p / 200k scene on an
    # NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 5b) it drops 7.9%
    # of the pairs and saves 2-3% of each compositor kernel, but the culled
    # binning costs more: device busy 3.587 -> 4.100 ms a frame, 9.469 ->
    # 10.121 ms a step. Worth it only for scenes of large, anisotropic
    # splats, whose rectangles overshoot their ellipses most.
    row_cull: bool = False
    # Static slots per gaussian of the culled expansion: row_slots - 1
    # single tile rows and one tail block over the remaining rows (culled
    # jointly). Tightness against dense work; no slot overflows.
    row_slots: int = 4
    pad_cap: int = -1                  # alignment padding budget; -1 = chunk * tiles
    chunk: int = 64
    # The JAX package selects between two TPU kernel forms with these; the
    # port has one CUDA kernel with the same semantics for either, but keeps
    # the fields so saved configs and flags carry over, and rejects values
    # neither package knows.
    compositor: str = "stream"
    moments: str = "vpu"
    alpha_min: float = 1.0 / 255.0    # contribution floor
    alpha_max: float = 0.99           # alpha clamp
    transmittance_eps: float = 1e-4   # early-out threshold
    dilation: float = 0.3             # screen-space cov dilation (px^2)

    def __post_init__(self):
        if self.compositor not in COMPOSITORS:
            raise ValueError(f"compositor must be one of {COMPOSITORS}, "
                             f"got {self.compositor!r}")
        if self.moments not in MOMENTS:
            raise ValueError(f"moments must be one of {MOMENTS}, "
                             f"got {self.moments!r}")
        if self.row_slots < 1:
            raise ValueError(f"row_slots must be at least 1 (the tail "
                             f"block), got {self.row_slots}")


def _add_dataclass_args(parser: argparse.ArgumentParser, dc_type):
    group = parser.add_argument_group(dc_type.__name__)
    for f in fields(dc_type):
        args = ["--" + f.name]
        if f.metadata.get("shorthand", False):
            args.append("-" + f.name[0])
        if f.type in (bool, "bool"):
            if f.default:       # True-default bools need an off switch too
                group.add_argument(*args, default=f.default,
                                   action=argparse.BooleanOptionalAction)
            else:
                group.add_argument(*args, default=f.default,
                                   action="store_true")
        else:
            ty = {"int": int, "float": float, "str": str}.get(f.type, str)
            group.add_argument(*args, default=f.default, type=ty)


def extract(dc_type, args: argparse.Namespace):
    """Build a dataclass instance from parsed argparse flags."""
    kw = {f.name: getattr(args, f.name) for f in fields(dc_type)
          if hasattr(args, f.name)}
    out = dc_type(**kw)
    if isinstance(out, ModelConfig) and out.source_path:
        out = dataclasses.replace(out,
                                  source_path=os.path.abspath(out.source_path))
    return out


def add_model_args(parser): _add_dataclass_args(parser, ModelConfig)
def add_pipeline_args(parser): _add_dataclass_args(parser, PipelineConfig)
def add_optimization_args(parser):
    _add_dataclass_args(parser, OptimizationConfig)
def add_rasterizer_args(parser): _add_dataclass_args(parser, RasterizerConfig)


_GROUPS = {"model": ModelConfig, "pipeline": PipelineConfig,
           "optimization": OptimizationConfig, "rasterizer": RasterizerConfig}


def save_cfg(model_path: str, cfgs: dict) -> None:
    """Write the merged config snapshot ``cfg_args.json``: one object per
    group name (``model``, ``pipeline``, ``optimization``, ``rasterizer``)
    holding its dataclass's fields, as the JAX package writes it."""
    os.makedirs(model_path, exist_ok=True)
    payload = {k: dataclasses.asdict(v) for k, v in cfgs.items()}
    with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
        json.dump(payload, f, indent=2)


def load_cfg(model_path: str) -> dict:
    """Load a saved ``cfg_args.json`` snapshot into the known dataclasses."""
    with open(os.path.join(model_path, "cfg_args.json")) as f:
        payload = json.load(f)
    out = {}
    for k, v in payload.items():
        ty = _GROUPS.get(k)
        if ty is None:
            continue
        names = {f.name for f in fields(ty)}
        out[k] = ty(**{kk: vv for kk, vv in v.items() if kk in names})
    return out


def get_combined_args(parser: argparse.ArgumentParser,
                      argv=None) -> argparse.Namespace:
    """Merge the saved training config with CLI overrides: a flag given on
    the command line wins only where it differs from its default."""
    args_cmdline = parser.parse_args(sys.argv[1:] if argv is None else argv)
    merged = dict(vars(args_cmdline))
    path = os.path.join(args_cmdline.model_path or "", "cfg_args.json")
    if args_cmdline.model_path and os.path.exists(path):
        flat = {}
        for dc in load_cfg(args_cmdline.model_path).values():
            flat.update(dataclasses.asdict(dc))
        defaults = {a.dest: parser.get_default(a.dest) for a in parser._actions}
        for k, v in flat.items():
            if k in merged and merged[k] == defaults.get(k):
                merged[k] = v
    return argparse.Namespace(**merged)
