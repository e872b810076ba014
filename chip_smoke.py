"""Drive the PyTorch port's main path once on one CUDA card, through its
hand-written kernels, and check what comes out.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. environment: a CUDA card, its name and power limit, the toolchain;
2. build: compile the field kernels (csrc/*.cu) with nvcc for sm_90a;
3. kernels: K1/K2 at P=199,000 points and K3 at P=99,000, N=8 instances
   (6 valid), box-only and with the residual field, each against its plain
   PyTorch twin on the same inputs on the card (max error relative to the
   twin's scale <= 2e-4), with kernel and twin times (median of 20);
4. slice: ``optimize_frame`` on the 17-view 376x1408 synthetic frame with
   8 instances, 1000 rays and 100+100 samples for 40 steps (20 box-only
   warmup + 20 with the residual field); the losses and the 3D IoU must be
   finite and every kernel's launch count must rise by >= 40; then the
   median ms/step of each phase.

The second-to-last line is a JSON object with one entry per kernel of the
main path: its launches in the slice, its largest absolute error against
the twin and that error relative to the twin's scale (the pullback to the
field weights sums ~200k points, so its absolute error is large where its
relative one is not), and its time beside the twin's. The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

TOLERANCE = 2e-4          # max |kernel - twin| / max(max|twin|, 1)
REPEATS = 20


def fail(message: str):
    print(f"FAILED: {message}", flush=True)
    raise SystemExit(1)


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def err(a, b) -> float:
    scale = float(b.abs().max()) if b.numel() else 0.0
    return float((a - b).abs().max()) / max(scale, 1.0)


def median_ms(fn, repeats: int = REPEATS) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def field_inputs(num_points: int, num_instances: int = 8, num_valid: int = 6, seed: int = 0):
    """Field inputs shaped like the main path's: points along rays from a
    camera at the origin over 0-100 m, boxes 5-40 m ahead, field weights
    from a random hypernetwork-sized layer."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = num_instances
    dirs = rng.normal(size=(num_points, 3)) * [0.3, 0.1, 1.0]
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pos = dirs * rng.uniform(0.0, 100.0, size=(num_points, 1))
    loc = np.stack([rng.uniform(-6, 6, n), rng.uniform(0.3, 0.8, n), rng.uniform(5, 40, n)], -1)
    yaw = rng.uniform(-0.4, 0.4, n)
    rot = np.stack([
        [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]] for a in yaw
    ])
    half = rng.uniform([0.75, 0.75, 1.5], [1.0, 1.0, 2.5], size=(n, 3))
    valid = (np.arange(n) < num_valid).astype(np.float32)
    weights = rng.normal(size=(n, 1617)) * 0.3
    ray_dirs = np.repeat(dirs, 1, axis=0)
    cot = dict(
        du=rng.normal(size=num_points), dw=rng.normal(size=(num_points, n)),
        dg=rng.normal(size=(num_points, 3)),
    )
    t = lambda x: torch.tensor(np.asarray(x, np.float32), device="cuda")  # noqa: E731
    return dict(
        pos=t(pos), dirs=t(ray_dirs), loc=t(loc), rot=t(rot), half=t(half), valid=t(valid),
        weights=t(weights), tau=torch.tensor(0.5, device="cuda"),
        **{k: t(v) for k, v in cot.items()},
    )


def kernel_phase(rdf: bool, report: dict, errors: dict):
    import torch

    from vsrd_tpu_torch.rendering import fused_field, field_kernels as fk

    mode = "rdf" if rdf else "box"
    # ---- K1 + K2 at the fine pass's P ----
    x = field_inputs(199_000)
    weights = x["weights"] if rdf else None
    args = (x["pos"], x["loc"], x["rot"], x["half"], x["valid"])

    def forward_graph(fn):
        params = [x["loc"].clone().requires_grad_(), x["rot"].clone().requires_grad_(),
                  x["half"].clone().requires_grad_()]
        if rdf:
            params.append(weights.clone().requires_grad_())
        u, w, g = fn(x["pos"], *params[:3], x["valid"], params[3] if rdf else None, x["tau"])
        loss = (u * x["du"]).sum() + (w * x["dw"]).sum() + (g * x["dg"]).sum()
        return (u.detach(), w.detach(), g.detach()), loss, params

    (uk, wk, gk), loss_k, params_k = forward_graph(fk.fused_field_with_grad)
    grads_k = torch.autograd.grad(loss_k, params_k)
    (ut, wt, gt), loss_t, params_t = forward_graph(fused_field.scene_eval_with_grad)
    grads_t = torch.autograd.grad(loss_t, params_t, retain_graph=True)
    torch.cuda.synchronize()
    names = ["dloc", "drot", "dhalf", "dweights"]
    for name, a, b in [("u", uk, ut), ("w", wk, wt), ("grad", gk, gt)]:
        errors[f"K1_{mode}_{name}"] = err(a, b)
    for name, a, b in zip(names, grads_k, grads_t):
        errors[f"K2_{mode}_{name}"] = err(a, b)

    fwd_args = (*args, weights, x["tau"])
    k1_ms = median_ms(lambda: fk.field_forward(*fwd_args))
    twin_fwd = lambda: fused_field.scene_eval_with_grad(*fwd_args)  # noqa: E731
    k1_plain = median_ms(lambda: torch.no_grad()(twin_fwd)())
    k2_ms = median_ms(lambda: fk.field_backward(*fwd_args, x["du"], x["dw"], x["dg"]))
    k2_plain = median_ms(lambda: torch.autograd.grad(loss_t, params_t, retain_graph=True))
    report[f"K1_{mode}"] = dict(
        max_abs_err=max(float((a - b).abs().max()) for a, b in [(uk, ut), (wk, wt), (gk, gt)]),
        max_rel_err=max(v for k, v in errors.items() if k.startswith(f"K1_{mode}_")),
        ms=k1_ms, plain_ms=k1_plain)
    report[f"K2_{mode}"] = dict(
        max_abs_err=max(float((a - b).abs().max()) for a, b in zip(grads_k, grads_t)),
        max_rel_err=max(v for k, v in errors.items() if k.startswith(f"K2_{mode}_")),
        ms=k2_ms, plain_ms=k2_plain)
    del x, loss_t, params_t, grads_k, grads_t

    # ---- K3 at the coarse pass's P ----
    x = field_inputs(99_000, seed=1)
    weights = x["weights"] if rdf else None
    dir_args = (x["pos"], x["dirs"], x["loc"], x["rot"], x["half"], x["valid"], weights, x["tau"])
    uk, wk, dk = fk.fused_field_dir_forward(*dir_args)
    ut, wt, dt = fused_field.scene_eval_dir(*dir_args)
    torch.cuda.synchronize()
    for name, a, b in [("u", uk, ut), ("w", wk, wt), ("u_dot", dk, dt)]:
        errors[f"K3_{mode}_{name}"] = err(a, b)
    report[f"K3_{mode}"] = dict(
        max_abs_err=max(float((a - b).abs().max()) for a, b in [(uk, ut), (wk, wt), (dk, dt)]),
        max_rel_err=max(v for k, v in errors.items() if k.startswith(f"K3_{mode}_")),
        ms=median_ms(lambda: fk.field_dir_forward(*dir_args)),
        plain_ms=median_ms(lambda: fused_field.scene_eval_dir(*dir_args)))


def slice_phase(card: str):
    import numpy as np
    import torch

    from vsrd_tpu_torch.pipeline import frame as fm, optimize as opt
    from vsrd_tpu_torch.rendering import field_kernels as fk

    start = time.perf_counter()
    frame = fm.synthetic_frame(0, num_views=17, image_size=(376, 1408), num_instances=8,
                               max_instances=8, device="cuda")
    torch.cuda.synchronize()
    print(f"[slice] synthetic frame 17x376x1408, 8 instances: "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    cfg = opt.OptimizationConfig(num_steps=40, warmup_steps=20, num_rays=1000, num_samples=100,
                                 checkpoint_interval=20, metric_interval=20)

    fk.reset_launch_counts()
    start = time.perf_counter()
    params, scalars = opt.optimize_frame(frame, 1, cfg)
    elapsed = time.perf_counter() - start
    launches = {
        "K1": fk.field_forward.launches,
        "K2": fk.field_backward.launches,
        "K3": fk.field_dir_forward.launches,
    }
    print(f"[slice] optimize_frame 40 steps: {elapsed:.2f} s; launches {launches}", flush=True)
    loss = scalars["loss"]
    print(f"[slice] loss warmup {loss[0]:.4f} -> {loss[19]:.4f}, rdf {loss[20]:.4f} -> "
          f"{loss[39]:.4f}; eikonal {scalars['eikonal_loss'][39]:.5f}; "
          f"iou_3d @20 {scalars['iou_3d'][19]:.4f} @40 {scalars['iou_3d'][39]:.4f}", flush=True)
    for name, values in scalars.items():
        if not np.all(np.isfinite(values)):
            fail(f"non-finite {name} in the slice: {values}")
    if scalars["num_matched"][39] < 8:
        fail(f"metrics matched {scalars['num_matched'][39]} of 8 instances")
    for name, count in launches.items():
        if count < 40:
            fail(f"{name} launched {count} times in 40 steps (expected >= 40)")

    # per-step times: one step per call, each ending in a host copy
    optimizer = opt.Adam(cfg)
    state = optimizer.init(params)
    step_ms = {}
    for phase, first in (("warmup", 0), ("rdf", cfg.warmup_steps)):
        times = []
        for i in range(6):
            t0 = time.perf_counter()
            opt.optimize_chunk(params, state, frame, 1, first + i, cfg, 1, optimizer)
            times.append((time.perf_counter() - t0) * 1e3)
        step_ms[phase] = statistics.median(times[1:])
    print(f"[slice] median ms/step on {card}: warmup {step_ms['warmup']:.2f}, "
          f"rdf {step_ms['rdf']:.2f}", flush=True)
    return launches


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on a card")
    try:
        from vsrd_tpu_torch.rendering import field_kernels as fk
    except ImportError as exc:
        fail(f"the port is not importable from here ({exc}); run from the repo root")

    card = card_name_and_power()
    print(card, flush=True)
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    nvcc = subprocess.run([fk._nvcc(), "--version"], capture_output=True, text=True)
    print(f"[env] nvcc: {nvcc.stdout.strip().splitlines()[-1]}", flush=True)

    fk.build_library()
    print(f"[build] kernels built in {fk.build_info['seconds']:.1f} s", flush=True)
    for line in fk.build_info["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}", flush=True)

    report, errors = {}, {}
    for rdf in (False, True):
        kernel_phase(rdf, report, errors)
    for name, value in sorted(errors.items()):
        print(f"[kernels] {name}: rel err {value:.3e}", flush=True)
    for name, entry in sorted(report.items()):
        print(f"[kernels] {name}: {entry['ms']:.3f} ms (plain {entry['plain_ms']:.3f} ms) "
              f"on {card}", flush=True)
    bad = {k: v for k, v in errors.items() if not v <= TOLERANCE}
    if bad:
        fail(f"kernels disagree with their twins beyond {TOLERANCE}: {bad}")

    launches = slice_phase(card)

    sources = {
        "K1": ("fused_forward.cu", "vsrd_tpu/rendering/pallas_field.py:111"),
        "K2": ("fused_backward.cu", "vsrd_tpu/rendering/pallas_field.py:214"),
        "K3": ("dir_forward.cu", "vsrd_tpu/rendering/pallas_field.py:138"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        # the main path runs K1/K2 in both modes and K3 box-only
        mode = "box" if name == "K3" else "rdf"
        entry = report[f"{name}_{mode}"]
        kernels.append({
            "name": f"{name} ({mode})",
            "route": "cuda",
            "source": f"vsrd_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": entry["max_abs_err"],
            "max_rel_err": entry["max_rel_err"],
            "ms": entry["ms"],
            "plain_ms": entry["plain_ms"],
        })
    if not all(math.isfinite(k["ms"]) for k in kernels):
        fail("a kernel time is not finite")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
