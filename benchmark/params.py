"""The initial parameters of a cell, drawn by the benchmark from its seed.

The parameters have the port's layout (``{"boxes": ..., "hyper": {"layers":
[...]}}``, a leading frame axis on every leaf when a cell co-optimizes
several frames) and are made on the device in a few large draws:

* each instance slot starts at a box near a different ground-truth car, in a
  random order: the centre moved by N(0, (1.0, 0.2, 2.0) m), the yaw by
  N(0, 0.2), the size logits N(0, 0.5). VSRD starts every instance at one
  default box and lets the matching break the tie; a tie has no unique
  answer, which a comparison with a reference cannot follow, so the draw
  gives every slot its own box;
* each instance's embedding U(0, 1) (VSRD shares one embedding);
* the hypernetwork as VSRD initializes it: weight-normed linear layers with
  ``nn.Linear``'s U(-1/sqrt(in), 1/sqrt(in)) for weight and bias, the norm
  scales at the rows' norms, LayerNorm at identity.
"""

from __future__ import annotations

import numpy as np
import torch

LOCATION_RANGE = ((-50.0, 1.55 - 1.75 / 2.0 - 5.0, 0.0), (50.0, 1.55 - 1.75 / 2.0 + 5.0, 100.0))
CENTRE_NOISE = (1.0, 0.2, 2.0)
YAW_NOISE = 0.2
SIZE_LOGIT_NOISE = 0.5


def field_weights(cfg: dict) -> int:
    """Flattened weights of one instance's residual MLP (biases included)."""
    ins = [3 * 2 * cfg["num_frequencies"], *cfg["field_channels"]]
    outs = [*cfg["field_channels"], 1]
    return sum(o * (i + 1) for i, o in zip(ins, outs))


def draw(seed: int, scenes: list[dict], cfg: dict, device) -> dict:
    """Initial parameters for the frames of ``scenes`` (see the module
    docstring); ``cfg`` is the configuration's optimization block."""
    frames = len(scenes)
    n = scenes[0]["valid"].shape[0]
    seq = np.random.SeedSequence([seed % 2**64, 0x1A17])
    rng = np.random.default_rng(seq)
    gen = torch.Generator(device=device).manual_seed(
        int(seq.generate_state(1, np.uint64)[0] >> 1))

    lo, hi = (np.asarray(r, np.float64) for r in LOCATION_RANGE)
    locations, orientations = [], []
    for scene in scenes:
        centers, yaws = scene["centers"], scene["yaws"]
        count = len(centers)
        order = rng.permutation(n) % count          # padded slots reuse a car
        centre = centers[order] + rng.normal(size=(n, 3)) * CENTRE_NOISE
        fraction = np.clip((centre - lo) / (hi - lo), 1e-4, 1 - 1e-4)
        locations.append(np.log(fraction / (1 - fraction)))
        yaw = yaws[order] + rng.normal(size=n) * YAW_NOISE
        orientations.append(np.stack([np.cos(yaw), np.sin(yaw)], -1))
    dims = rng.normal(size=(frames, n, 3)) * SIZE_LOGIT_NOISE

    def t(x):
        x = torch.as_tensor(np.asarray(x, np.float32), device=device)
        return x if frames > 1 else x[0]

    lead = (frames,) if frames > 1 else ()
    boxes = {
        "locations": t(locations),
        "dimensions": t(dims),
        "orientations": t(orientations),
        "embeddings": torch.rand(*lead, n, cfg["num_features"], generator=gen, device=device),
    }
    widths = [cfg["num_features"], *cfg["hyper_channels"], field_weights(cfg)]
    layers = []
    for index, (c_in, c_out) in enumerate(zip(widths, widths[1:])):
        bound = 1.0 / np.sqrt(c_in)
        v = (torch.rand(*lead, c_out, c_in, generator=gen, device=device) * 2 - 1) * bound
        b = (torch.rand(*lead, c_out, generator=gen, device=device) * 2 - 1) * bound
        layer = {"v": v, "g": torch.linalg.vector_norm(v, dim=-1), "b": b}
        if index < len(widths) - 2:
            layer["ln_scale"] = torch.ones(*lead, c_out, device=device)
            layer["ln_bias"] = torch.zeros(*lead, c_out, device=device)
        layers.append(layer)
    return {"boxes": boxes, "hyper": {"layers": layers}}
