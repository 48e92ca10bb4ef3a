"""General host utilities: device resolution, seeding, stdout timestamps,
a wall-clock timer. Counterpart of gsplat_tpu/utils/general.py."""
from __future__ import annotations

import os
import random
import sys
import time
from datetime import datetime

import numpy as np
import torch
import torch.distributed


class Timer:
    def __init__(self):
        self.t0 = time.time()

    def elapsed(self):
        return time.time() - self.t0


def mkdir_p(folder_path):
    os.makedirs(folder_path, exist_ok=True)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``. Raises when CUDA is asked for and
    absent: the port never carries on quietly on the CPU. Under a process
    group a ``cuda`` without an index is this rank's card
    (:func:`local_card`)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    if (dev.type == "cuda" and dev.index is None
            and torch.distributed.is_available()
            and torch.distributed.is_initialized()):
        dev = local_card()
    return dev


def local_card() -> torch.device:
    """``cuda:LOCAL_RANK``, the card of this rank (one rank per card, as
    ``torchrun`` numbers them on each host). Raises when ``LOCAL_RANK`` is
    unset or not below the number of visible cards: two ranks never share
    a card by accident."""
    if "LOCAL_RANK" not in os.environ:
        raise RuntimeError("LOCAL_RANK is not set: start the ranks with "
                           "torchrun, or name the card (cuda:N)")
    local_rank = int(os.environ["LOCAL_RANK"])
    n_cards = torch.cuda.device_count()
    if not 0 <= local_rank < n_cards:
        raise RuntimeError(f"LOCAL_RANK {local_rank} has no card: "
                           f"{n_cards} visible")
    return torch.device("cuda", local_rank)


def full_f32_matmul() -> None:
    """Keep float32 products in full float32 on the card. PyTorch's default
    for matmuls is already so, but cuDNN's is TF32 (about three decimal
    digits), and the render path's tolerances against the JAX reference
    (which runs these products at HIGHEST precision) assume full f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def safe_state(silent: bool = False, seed: int = 0):
    """Seed the Python, numpy and torch RNGs and timestamp stdout lines."""
    old_f = sys.stdout

    class F:
        def __init__(self, silent):
            self.silent = silent

        def write(self, x):
            if not self.silent:
                if x.endswith("\n"):
                    old_f.write(x.replace(
                        "\n", " [{}]\n".format(
                            datetime.now().strftime("%d/%m %H:%M:%S"))))
                else:
                    old_f.write(x)

        def flush(self):
            old_f.flush()

    sys.stdout = F(silent)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
