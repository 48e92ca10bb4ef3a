"""The port's train CLI with the JAX package's densify draws: each densify
event of the port's loop gets the noise the JAX package's loop draws there
(``PRNGKey(0)``, split once an event, as tests/test_torch_loop.py hands
them), so that a run of ``train_torch.py`` and one of ``train.py`` on the
same scene stay comparable past the first densify event, where the two
packages' generators part them.

    python tests/train_with_jax_draws.py <train_torch.py arguments>

It imports both packages, as the tests do; JAX runs on the CPU.
"""
import os
import sys

import jax
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
jax.config.update("jax_platforms", "cpu")

from gsplat_tpu_torch.cli import train as train_cli  # noqa: E402
from gsplat_tpu_torch.train import trainer  # noqa: E402


def main(argv=None):
    key = [jax.random.PRNGKey(0)]
    densify = trainer.densify_step

    def with_jax_draws(state, gen, *a, **kw):
        key[0], sub = jax.random.split(key[0])
        cap = state.gaussians.capacity
        noise = (jax.random.normal(sub, (cap, 3)),
                 jax.random.normal(jax.random.fold_in(sub, 1), (cap, 3)))
        return densify(state, gen, *a, noise=tuple(
            torch.tensor(np.asarray(x)) for x in noise), **kw)

    trainer.densify_step = with_jax_draws
    train_cli.main(argv)


if __name__ == "__main__":
    main()
