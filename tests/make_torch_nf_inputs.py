"""Write ``tools/torch_port/nf_inputs.npz``: the JAX package's parameter
inits of the noise-floor trials, for the port's side of them.

    JAX_PLATFORMS=cpu python tests/make_torch_nf_inputs.py

Trial t of ``tools/parity/noise_floor.py`` starts from
``init_params(PRNGKey(1 + t), 3, cfg)``; the port has no JAX to draw them,
so they travel as a file, a list of the five trials' parameter trees in
the port's checkpoint layout (``vsrd_tpu_torch/utils/saver.py``). The
field's dimensions are the default config's, the same in the tool's strict
and production configs. ``tests/test_torch_noise_floor.py`` keeps the file
equal to what ``draw_inits`` draws. This file sits beside the tests
because it imports the JAX package.
"""

from __future__ import annotations

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

NUM_TRIALS = 5
NUM_INSTANCES = 3
OUT = os.path.join(_ROOT, "tools", "torch_port", "nf_inputs.npz")


def draw_inits(num_trials: int = NUM_TRIALS) -> list:
    """``jax.device_get(init_params(PRNGKey(1 + t), 3, OptimizationConfig()))``
    for t < ``num_trials``."""
    import jax

    from vsrd_tpu.pipeline import optimize as opt

    cfg = opt.OptimizationConfig()
    return [jax.device_get(opt.init_params(jax.random.PRNGKey(1 + t), NUM_INSTANCES, cfg))
            for t in range(num_trials)]


def main():
    from vsrd_tpu_torch.utils import saver

    saver.save_checkpoint(OUT, draw_inits())
    print(f"{OUT}: {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
