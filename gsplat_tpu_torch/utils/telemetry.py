"""Structured training telemetry: a JSONL scalar log that always works, plus
TensorBoard when ``torch.utils.tensorboard`` imports. The port's own copy of
gsplat_tpu/utils/telemetry.py, with the same file and keys.

The scalar set is the reference trainer's report (train_loss_patches/
{l1_loss, total_loss}, iter_time, eval l1/psnr per split, total_points).
The JSONL file keeps the artifact contract dependency-free: one JSON object
per line, ``{"step": N, "t": unix time, "k": v, ...}``, written to
``<model_path>/training_log.jsonl``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional


class Telemetry:
    """Scalar logger. ``scalars(step, **kv)`` appends one JSONL record and
    mirrors each value to TensorBoard when available."""

    def __init__(self, model_path: Optional[str], enable_tb: bool = True):
        self._f = None
        self._tb = None
        if not model_path:
            return
        os.makedirs(model_path, exist_ok=True)
        self._f = open(os.path.join(model_path, "training_log.jsonl"), "a",
                       buffering=1)
        if enable_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(model_path)
            except ImportError:
                print("Tensorboard not available: not logging progress")

    def scalars(self, step: int, **kv):
        if self._f is None:
            return
        rec = {"step": int(step), "t": round(time.time(), 3)}
        for k, v in kv.items():
            rec[k] = float(v)
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in kv.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
