"""The work a step of the configuration asks of the field kernels, frozen
as functions of its shapes, and the share of the card's peaks it reaches.

The counts follow the configuration, never what the program launched:

* tensor-core multiply-adds per point and instance with the residual field:
  3,104 for the field with its spatial gradient (K1/K4a) and for the field
  with its ray tangent (K3/K4b), 9,312 for the cotangents of the parameters
  (K2/K4c, which recomputes the forward and its reverse sweep); 0 for the
  box-only calls, which are bound by their bytes;
* bytes: each input read once and each output written once, in float32;
* a step runs the coarse pass on R (S - 1) points per frame (the box union
  and its ray tangent, box-only, through the tangent kernel), the fine pass
  on R (2 S - 1) points (the field with its gradient) and its backward.

Only the configurations of this benchmark are counted: bf16 products
("default"), the tangent kernel and the box-only coarse pass; another
configuration raises, and brings its own counts with its cell.

One H100 SXM (NVIDIA's data sheet, dense rates, at 700 W): 989 TFLOP/s on
the tensor cores in bf16 with f32 sums, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
NUM_WEIGHTS = 1617          # the residual MLP 48-16-16-16-16-1, biases included
MACS_PER_POINT_INSTANCE = {"K1": 3104, "K2": 9312, "K3": 3104}


def call_bytes(kind: str, points: int, instances: int, rdf: bool, frames: int = 1) -> int:
    """Bytes of one call on ``points`` points per frame: each input read and
    each output written once (f32), the per-instance boxes left out."""
    n = instances
    weights = frames * n * NUM_WEIGHTS * 4 if rdf else 0
    if kind == "K1":         # positions in; u, w, grad_x u out
        return frames * points * (12 + 4 + 4 * n + 12) + weights
    if kind == "K2":         # positions and the cotangents of u, w, grad_x u in; a row per instance out
        return (frames * points * (12 + 12 + 4 + 4 * n) + weights
                + frames * n * 4 * (NUM_WEIGHTS + 15 if rdf else 15))
    if kind == "K3":         # positions and directions in; u, w, u_dot out
        return frames * points * (12 + 12 + 4 + 4 * n + 4) + weights
    raise ValueError(f"no kernel {kind!r}")


def call_macs(kind: str, points: int, instances: int, rdf: bool, frames: int = 1) -> int:
    return frames * points * instances * MACS_PER_POINT_INSTANCE[kind] if rdf else 0


COUNTED = {"kernel_matmul_precision": "default", "kernel_dir_coarse": True,
           "kernel_box_coarse": True}


def step_calls(config: dict, residual: bool):
    """The field calls of one step of the configuration: (kind, points per
    frame, residual field)."""
    cfg = config["optimization"]
    for key, value in COUNTED.items():
        if cfg[key] != value:
            raise ValueError(f"no counts for {key}={cfg[key]!r}, only {value!r}")
    rays, samples = cfg["num_rays"], cfg["num_samples"]
    coarse_points, fine_points = rays * (samples - 1), rays * (2 * samples - 1)
    return [("K3", coarse_points, False), ("K1", fine_points, residual),
            ("K2", fine_points, residual)]


def step_work(config: dict, frames: int, residual: bool) -> dict:
    """Multiply-adds, bytes and the least seconds of one step's field calls
    on ``frames`` frames: per call the larger of its tensor-core and its HBM
    time."""
    n = config["max_instances"]
    macs = nbytes = bound = 0.0
    for kind, points, rdf in step_calls(config, residual):
        m = call_macs(kind, points, n, rdf, frames)
        b = call_bytes(kind, points, n, rdf, frames)
        macs += m
        nbytes += b
        bound += max(2 * m / PEAK_BF16_FLOPS, b / PEAK_HBM_BYTES)
    return {"macs": macs, "bytes": nbytes, "bound_s": bound}


def mix(warmup, residual, weights=(1, 2)) -> float:
    """A quantity per step of the recipe's phase mix (1000 warmup steps to
    2000 residual ones)."""
    return (weights[0] * warmup + weights[1] * residual) / sum(weights)


def kernel_roofline(config: dict, frames: int, kernel_busy_ms: dict) -> float:
    """Per cent: the mix's least field-kernel time over the port's kernels'
    measured device time per step (``kernel_busy_ms`` by phase)."""
    bound = mix(step_work(config, frames, False)["bound_s"], step_work(config, frames, True)["bound_s"])
    busy = mix(kernel_busy_ms["warmup"], kernel_busy_ms["residual"]) / 1e3
    return 100.0 * bound / busy


def step_mfu(config: dict, frames: int, step_ms: dict) -> float:
    """Per cent: the mix's counted tensor-core FLOPs per step over what the
    bf16 peak does in the step's wall time (``step_ms`` by phase)."""
    flops = 2 * mix(step_work(config, frames, False)["macs"], step_work(config, frames, True)["macs"])
    wall = mix(step_ms["warmup"], step_ms["residual"]) / 1e3
    return 100.0 * flops / (wall * PEAK_BF16_FLOPS)
