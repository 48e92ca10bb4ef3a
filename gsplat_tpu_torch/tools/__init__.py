"""The port's validation and measurement tools, counterparts of the
repo's ``tools/`` and of the root bench.py:

- ``make_synthetic_scene``: a known Gaussian scene rendered into a COLMAP
  dataset;
- ``drive_train``: training on a synthetic ring of cameras with every 4th
  view held out, asserting +3 dB of PSNR on both splits;
- ``drive_render``: one render and its gradient;
- ``soak_30k``: the reference's 30,000-iteration regime through the
  port's CLIs;
- ``debug_nan`` and ``analyze_nan``: the hunt for a first non-finite value;
- the measurement entry points: ``bench`` (the root bench.py's train-step
  pixels/s, also run as ``bench_torch.py``), ``profile_stages``,
  ``sweep_tiles``, ``bench_scatter``, ``bench_binning`` and
  ``bisect_binning``.

Each runs as ``python -m gsplat_tpu_torch.tools.<name>``, on the card
unless given ``--device cpu``; importing a module runs nothing.
"""
