"""COLMAP conversion pipeline CLI: feature extraction, exhaustive
matching, mapping and undistortion, then the sparse/* → sparse/0 move and
the optional 1/2, 1/4, 1/8 image pyramids. Own copy of
gsplat_tpu/cli/convert.py, with the same flags and ``subprocess.run``
argument lists; it runs no device code. Each stage runs through
``subprocess.run`` with an argument list (no shell), and the resize
pyramid uses PIL when ImageMagick's ``magick`` is absent.
"""
from __future__ import annotations

import argparse
import logging
import os
import shutil
import subprocess
import sys


def _run(cmd: list, stage: str) -> None:
    logging.info("[%s] %s", stage, " ".join(cmd))
    proc = subprocess.run(cmd)
    if proc.returncode != 0:
        logging.error("%s failed with code %d. Exiting.", stage,
                      proc.returncode)
        sys.exit(proc.returncode)


def _resize_pil(src: str, dst: str, frac: float) -> None:
    from PIL import Image
    with Image.open(src) as im:
        w, h = im.size
        im.resize((max(round(w * frac), 1), max(round(h * frac), 1)),
                  Image.LANCZOS).save(dst)


def main(argv=None):
    parser = argparse.ArgumentParser("Colmap converter")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--source_path", "-s", required=True, type=str)
    parser.add_argument("--camera", default="OPENCV", type=str)
    parser.add_argument("--colmap_executable", default="", type=str)
    parser.add_argument("--resize", action="store_true")
    parser.add_argument("--magick_executable", default="", type=str)
    args = parser.parse_args(argv)

    colmap = args.colmap_executable or "colmap"
    magick = args.magick_executable or shutil.which("magick")
    use_gpu = "0" if args.no_gpu else "1"
    src = args.source_path

    if not args.skip_matching:
        os.makedirs(os.path.join(src, "distorted", "sparse"), exist_ok=True)
        db = os.path.join(src, "distorted", "database.db")
        _run([colmap, "feature_extractor",
              "--database_path", db,
              "--image_path", os.path.join(src, "input"),
              "--ImageReader.single_camera", "1",
              "--ImageReader.camera_model", args.camera,
              "--SiftExtraction.use_gpu", use_gpu], "feature extraction")
        _run([colmap, "exhaustive_matcher",
              "--database_path", db,
              "--SiftMatching.use_gpu", use_gpu], "feature matching")
        # a tightened global bundle-adjustment tolerance
        _run([colmap, "mapper",
              "--database_path", db,
              "--image_path", os.path.join(src, "input"),
              "--output_path", os.path.join(src, "distorted", "sparse"),
              "--Mapper.ba_global_function_tolerance=0.000001"], "mapper")

    _run([colmap, "image_undistorter",
          "--image_path", os.path.join(src, "input"),
          "--input_path", os.path.join(src, "distorted", "sparse", "0"),
          "--output_path", src,
          "--output_type", "COLMAP"], "image undistortion")

    # COLMAP writes sparse/{files}; loaders expect sparse/0/{files}.
    sparse = os.path.join(src, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for name in os.listdir(sparse):
        if name == "0":
            continue
        shutil.move(os.path.join(sparse, name),
                    os.path.join(sparse, "0", name))

    if args.resize:
        print("Copying and resizing...")
        images = os.path.join(src, "images")
        for div, frac in ((2, 0.5), (4, 0.25), (8, 0.125)):
            os.makedirs(os.path.join(src, f"images_{div}"), exist_ok=True)
        for name in os.listdir(images):
            s = os.path.join(images, name)
            for div, frac in ((2, 0.5), (4, 0.25), (8, 0.125)):
                d = os.path.join(src, f"images_{div}", name)
                if magick:
                    shutil.copy2(s, d)
                    _run([magick, "mogrify", "-resize", f"{frac * 100:g}%",
                          d], f"resize {div}x")
                else:
                    _resize_pil(s, d, frac)

    print("Done.")


if __name__ == "__main__":
    main()
