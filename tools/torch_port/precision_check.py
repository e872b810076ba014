"""Hold the field kernels K1-K3 in both precisions against their plain twins,
output by output, in three measures.

    python3 tools/torch_port/precision_check.py          # on one CUDA card
    python3 tools/torch_port/precision_check.py --device cpu --points 2000 \
        --coarse-points 1000                              # rehearsal (twin against twin)

On the inputs of ``chip_smoke.field_inputs`` (points along rays over 0-100 m,
N=8 instances of which 6 valid, random field weights; ``--valid 0`` for a
frame with no valid instance): K1 and its backward K2 at ``--points`` and K3
at ``--coarse-points``, each at ``kernel_matmul_precision`` "highest" and
"default", against the float64 twin at "highest" and at "default" (its
operands rounded to bf16 as the default mode's are) and the float32 twin at
"default". For each output it prints the largest error, the root mean
square error (both relative to the twin's scale, max(max |twin|, 1), as
``chip_smoke.err``) and the share of entries more than 2e-4 of that scale
away. A default-mode kernel that computes the default function is much
nearer the rounded twins than the unrounded one; the largest error also
shows the sparse entries where a bf16 operand rounds the other way between
two f32 (or f32 and float64) evaluations.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, _ROOT)

import torch  # noqa: E402

from vsrd_tpu_torch.rendering import field_kernels as fk, fused_field  # noqa: E402
from vsrd_tpu_torch.scripts.bench_common import (  # noqa: E402
    card_name_and_power, field_inputs)

BAR = 2e-4


def measures(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float, float]:
    """(max, rms, share beyond BAR) of |a - b| over max(max |b|, 1)."""
    scale = max(float(b.abs().max()), 1.0)
    diff = (a.double() - b.double()).abs() / scale
    return (float(diff.max()), float(diff.square().mean().sqrt()),
            float((diff > BAR).double().mean()))


def with_grad(fn, x):
    """(u, w, grad_x u) and the pullback of (du, dw, dg) to (loc, rot, half,
    weights)."""
    params = [x[k].clone().requires_grad_() for k in ("loc", "rot", "half", "weights")]
    u, w, g = fn(x["pos"], *params[:3], x["valid"], params[3], x["tau"])
    grads = torch.autograd.grad((u * x["du"]).sum() + (w * x["dw"]).sum()
                                + (g * x["dg"]).sum(), params)
    return dict(zip(("u", "w", "grad", "dloc", "drot", "dhalf", "dweights"),
                    (u.detach(), w.detach(), g.detach(), *grads)))


def dir_forward(fn, x):
    return dict(zip(("u", "w", "u_dot"), fn(x["pos"], x["dirs"], x["loc"], x["rot"], x["half"],
                                             x["valid"], x["weights"], x["tau"])))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--points", type=int, default=199_000)
    parser.add_argument("--coarse-points", type=int, default=99_000)
    parser.add_argument("--valid", type=int, default=6, help="valid instances of the 8")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu for a rehearsal)")
    print(card_name_and_power() if args.device == "cuda" else "cpu (no device metric)",
          flush=True)

    twins = (("float64 highest", torch.float64, "highest"),
             ("float64 default", torch.float64, "default"),
             ("float32 default", torch.float32, "default"))
    for label, points, run, kernel, twin in (
            ("K1/K2", args.points, with_grad, fk.fused_field_with_grad,
             fused_field.scene_eval_with_grad),
            ("K3", args.coarse_points, dir_forward, fk.fused_field_dir_forward,
             fused_field.scene_eval_dir)):
        x = field_inputs(points, num_valid=args.valid, seed=args.seed, device=args.device)
        refs = {}
        for name, dtype, precision in twins:
            xd = {k: v.to(dtype) for k, v in x.items()}
            refs[name] = run(functools.partial(twin, precision=precision), xd)
        for precision in ("highest", "default"):
            got = run(functools.partial(kernel, precision=precision), x)
            for name, ref in refs.items():
                for out, value in got.items():
                    worst, rms, share = measures(value, ref[out])
                    print(f"[precision] {label} kernel {precision} vs {name} twin, {out}: "
                          f"max {worst:.3e}, rms {rms:.3e}, beyond {BAR:g} {share:.2e}",
                          flush=True)
        del x, refs
        if args.device == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
