"""Camera paths, one module a kind, found by a configuration's
``camera.kind`` (``splatbench.spec.module("cameras", kind)``). A module has
``poses(cfg, count)``: ``count`` (R, T) poses in COLMAP's convention."""
