"""The fine field alone: K1 forward, and K1 with K2 (forward and backward),
at the fine pass's point count.

Counterpart of the JAX package's ``scripts/kernelbench.py``::

    python -m vsrd_tpu_torch.scripts.kernelbench [--points 200000] [--instances 8]
    python -m vsrd_tpu_torch.scripts.kernelbench --no-rdf          # box only
    python -m vsrd_tpu_torch.scripts.kernelbench --device cpu --points 256 --instances 2 --reps 1

The JAX script's inputs, drawn in its order from
``np.random.default_rng(0)`` (``bench_common.script_inputs``): positions
N(0, 20^2), locations N(0, 10^2), identity rotations, half sizes U(0.5, 2),
every instance valid, flat field weights ``[N, 1617]`` N(0, 0.3^2),
temperature 0.5, at the default
precision (bf16 operands, f32 sums), as the JAX script hardcodes. ``fwd``
times ``field_kernels.fused_field_with_grad`` without a graph (K1);
``fwd+bwd`` the gradient of ``sum(u) + sum(w) + sum(g^2)`` with respect
to the locations, half sizes and weights (K1, then K2). Times are CUDA
events over ``--reps`` calls after one warm-up call. It prints the JAX
script's line; ``--out`` writes the report as JSON.

The JAX flags ``--fwd-tile``/``--bwd-tile`` (Pallas tile sizes) and
``--k3`` (K1's three-tangent form, not ported) have no counterpart.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..rendering import field_kernels
from . import bench_common as bc

PRECISION = "default"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--points", type=int, default=200_000)
    parser.add_argument("--instances", type=int, default=8)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--no-rdf", action="store_true")
    parser.add_argument("--out", help="write the report as JSON to this path")
    return parser.parse_args(argv)


def field(x, loc, half, weights):
    return field_kernels.fused_field_with_grad(x["pos"], loc, x["rot"], half, x["valid"],
                                               weights, x["tau"], precision=PRECISION)


def forward(x):
    with torch.no_grad():
        return field(x, x["loc"], x["half"], x["weights"])


def forward_backward(x):
    leaves = [x["loc"], x["half"]] + ([x["weights"]] if x["weights"] is not None else [])
    leaves = [t.detach().requires_grad_() for t in leaves]
    u, w, g = field(x, leaves[0], leaves[1], leaves[2] if len(leaves) > 2 else None)
    loss = u.sum() + w.sum() + g.square().sum()
    return torch.autograd.grad(loss, leaves)


def time_ms(fn, x, reps: int, device: str) -> float:
    """CUDA events on the card; on the CPU the host clock (a rehearsal)."""
    if device == "cuda":
        return bc.event_ms(lambda: fn(x), reps)
    fn(x)
    begin = time.perf_counter()
    for _ in range(reps):
        fn(x)
    return (time.perf_counter() - begin) * 1e3 / reps


def main(argv=None) -> dict:
    args = parse_args(argv)
    card = bc.prepare_device(args.device)
    rdf = not args.no_rdf
    x = bc.script_inputs(args.points, args.instances, rdf, args.device)
    f_ms = time_ms(forward, x, args.reps, args.device)
    fb_ms = time_ms(forward_backward, x, args.reps, args.device)
    print(f"P={args.points} N={args.instances} rdf={rdf} precision={PRECISION}: "
          f"fwd {f_ms:.3f} ms  fwd+bwd {fb_ms:.3f} ms  bwd {fb_ms - f_ms:.3f} ms  on {card}",
          flush=True)
    report = {
        "workload": {"points": args.points, "instances": args.instances, "rdf": rdf,
                     "precision": PRECISION, "reps": args.reps, "device": args.device},
        "card": card,
        "timer": "cuda events" if args.device == "cuda" else "host clock (cpu)",
        "fwd_ms": f_ms,
        "fwd_bwd_ms": fb_ms,
        "bwd_ms": fb_ms - f_ms,
    }
    bc.write_json(args.out, report)
    return report


if __name__ == "__main__":
    main()
