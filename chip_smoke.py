"""Drive the PyTorch port's main path once on one CUDA card, through its
hand-written kernels, and check what comes out.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. environment: a CUDA card, its name and power limit, the toolchain;
2. build: compile the field kernels (csrc/*.cu) with nvcc for sm_90a, one
   nvcc per source in parallel; ptxas's registers and spills of every
   kernel, and K1's and K3's CTA size, shared memory and CTAs per SM;
3. kernels: K1/K2 at P=199,000 points and K3 at P=99,000, N=8 instances
   (6 valid), box-only and with the residual field, each against its plain
   PyTorch twin on the same inputs on the card (max error relative to the
   twin's scale <= 2e-4; the twin evaluated in float64, see kernel_phase),
   with kernel and twin times (median of 20 calls on the host clock, each
   ending in a synchronize; the twin in float32), the kernel's time on
   CUDA events over 20 launches, and its bound (kernel_bound); then
   the frame-batched launches K4a/K4c at F=8 frames x P=199,000 and K4b at
   F=8 x P=99,000, whose frames differ in boxes and validity (frame 1 has
   no valid instance, the others 6 or 8), each frame against the twin the
   same way, and a check that K4c keeps frames apart: zero cotangents in
   one frame give exactly zero there and leave the other frames' results
   bit for bit as they were. With the residual field, K3 (K4b) is also
   timed in turns with its other possible form, K1's kernel on the same
   inputs (rev_forward_kernel, whose grad_x u dotted with the direction
   in its epilogue is u_dot), 3 times each on CUDA events;
4. frames: the 17-view 376x1408 synthetic frames of seeds 0-7 with 8
   instances, built on host threads;
5. slice: ``optimize_frame`` on frame 0 with 1000 rays and 100+100 samples
   for 40 steps (20 box-only warmup + 20 with the residual field); the
   losses and the 3D IoU must be finite, all 8 instances matched at the
   metric step, and K1, K2 and K3 launched exactly once per step; then the
   median ms/step of each phase;
6. batched slice: ``optimize_frames_batched`` on the 8 frames stacked, the
   same 40 steps; the same checks in every frame, with K4a, K4c and K4b
   launched exactly once per step for all 8 frames; then the median
   ms/step of each phase at F=8 beside F=1, and ms per frame-step;
7. residual coarse pass: frame 0 and the 8 stacked frames again with
   ``kernel_box_coarse=False`` for 20 steps (10 box-only + 10 with the
   residual field), so that the coarse pass runs K3 (K4b) with the field:
   finite scalars, one launch of each kernel per step, and 10 of K3's
   (K4b's) with the residual field.

The second-to-last line is a JSON object with one entry per kernel and
mode of the paths: its launches in its path (K3 and K4b with the residual
field: with the field in phase 7), its largest absolute error against the
twin and that error relative to the twin's scale (the pullback to the field
weights sums ~200k points, so its absolute error is large where its
relative one is not), its time (``ms``, host clock; ``event_ms``, CUDA
events) beside the twin's, its bound and what sets it, ``library_ms``
null: no single PyTorch call computes these functions (the softmin union of
per-instance box SDFs plus a per-instance MLP with LayerNorm and GELU, with
tangents or its reverse sweep), and for K3/K4b with the residual field
``epilogue_form_event_ms``, the other form's time in turns. The last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

TOLERANCE = 2e-4          # max |kernel - twin| / max(max|twin|, 1)
REPEATS = 20
FRAMES = 8                # the batched path's frames (seeds 0-7)
BATCH_VALID = (6, 0, 8, 6, 8, 6, 8, 6)   # valid instances per frame, kernel phase
PALLAS = "vsrd_tpu/rendering/pallas_field.py"
# the H100's published peaks (SXM, dense): HBM bytes/s, f32 FLOP/s outside
# the tensor cores, TF32 tensor-core FLOP/s
PEAK_BYTES, PEAK_F32, PEAK_TF32 = 3.35e12, 67e12, 495e12
# 3xTF32 runs three TF32 products for each f32 multiply-add: 2 FLOP at a
# third of the TF32 rate
RATE_3XTF32 = PEAK_TF32 / 3
# The least work of each function per point and active instance, whatever
# implements it, counted from csrc/field_common.cuh. MAC_TENSOR: the
# residual MLP's layer products (48-16-16-16-16-1, 1,552 multiply-adds for a
# value), which the tensor cores can run in 3xTF32: K1, the value and one
# reverse sweep with respect to the position (three forward tangents would
# do the same function with twice the products); K3, the value and one
# tangent; K2, the value with one tangent (3,104), the reverse of both
# (3,104) and the weight-gradient sums (3,169). FLOP_F32: the rest, at the
# f32 peak (an FMA is 2 FLOP, a transcendental 1; rounded down): K1, box
# SDF and its gradient 58, encoding 76 (24 sincos), 4 x LayerNorm + GELU
# 660, sigmoid 22, their first-order reverses 904, the encoding's reverse
# 126, the rotation back 18, the union 24; K3, the same forward with one
# tangent; K2, that forward, the union's reverse and the second-order
# reverse sweep. Box-only: the box SDF with its gradient or tangent and the
# union (those kernels are bound by bytes).
MAC_TENSOR = {"K1": 3104, "K2": 9377, "K3": 3104}
FLOP_F32 = {"K1": 1888, "K2": 4770, "K3": 1816}
FLOP_F32_BOX = {"K1": 100, "K2": 280, "K3": 92}


def fail(message: str):
    print(f"FAILED: {message}", flush=True)
    raise SystemExit(1)


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def synthetic_frames(seeds, device: str, **kwargs):
    """Full-width synthetic frames (17 views at 376x1408, 8 instances) of
    ``seeds``, built on host threads: the frame build is numpy, which
    releases the interpreter lock in its array work."""
    from vsrd_tpu_torch.pipeline import frame as fm

    kwargs = dict(dict(num_views=17, image_size=(376, 1408), num_instances=8,
                       max_instances=8), **kwargs)
    workers = max(1, min(len(seeds), os.cpu_count() or 1))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(lambda s: fm.synthetic_frame(s, device=device, **kwargs), seeds))


def err(a, b) -> float:
    scale = float(b.abs().max()) if b.numel() else 0.0
    return float((a - b).abs().max()) / max(scale, 1.0)


def event_ms(fn, repeats: int = REPEATS) -> float:
    """Mean ms per call on CUDA events over ``repeats`` back-to-back calls,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def kernel_bound(kind: str, rdf: bool, x: dict) -> tuple[float, str]:
    """The least time (ms) the card could take for one call of kernel
    ``kind`` (K1, K2 or K3 and their frame-batched launches) on the inputs
    ``x``, and whether bytes or operations set it: each input read once and
    each output written once at the HBM rate, against this run's active
    point-instances (valid ones, or all N in a frame with none valid) with
    the layer products at the 3xTF32 rate and the rest at the f32 rate, the
    two overlapped."""
    valid = x["valid"].reshape(-1, x["valid"].shape[-1])
    n = valid.shape[-1]
    active = sum(int(c) if c > 0 else n for c in (valid > 0.5).sum(-1).tolist())
    frames, p = valid.shape[0], x["pos"].shape[-2]
    pairs = active * p
    weights = frames * n * 1617 * 4 if rdf else 0
    if kind == "K1":         # pos in; u, w, grad_x u out
        nbytes = frames * p * (12 + 4 + 4 * n + 12) + weights
    elif kind == "K2":       # pos, dg, du, dw in; one row per instance out
        nbytes = frames * p * (12 + 12 + 4 + 4 * n) + weights
        nbytes += frames * n * 4 * (1632 if rdf else 15)
    else:                    # pos, dirs in; u, w, u_dot out
        nbytes = frames * p * (12 + 12 + 4 + 4 * n + 4) + weights
    times = {
        "bytes": nbytes / PEAK_BYTES,
        "operations": max(pairs * (FLOP_F32[kind] if rdf else FLOP_F32_BOX[kind]) / PEAK_F32,
                          pairs * 2 * MAC_TENSOR[kind] * rdf / RATE_3XTF32),
    }
    bound_by = max(times, key=times.get)
    return times[bound_by] * 1e3, bound_by


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


def field_inputs(num_points: int, num_instances: int = 8, num_valid: int = 6, seed: int = 0,
                 device: str = "cuda"):
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
    cot = dict(
        du=rng.normal(size=num_points), dw=rng.normal(size=(num_points, n)),
        dg=rng.normal(size=(num_points, 3)),
    )
    t = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
    return dict(
        pos=t(pos), dirs=t(dirs), loc=t(loc), rot=t(rot), half=t(half), valid=t(valid),
        weights=t(weights), tau=torch.tensor(0.5, device=device),
        **{k: t(v) for k, v in cot.items()},
    )


def batched_field_inputs(num_points: int, seed: int):
    """``field_inputs`` of FRAMES frames (their own boxes, weights, points
    and validity, BATCH_VALID) stacked on a leading frame axis."""
    import torch

    frames = [field_inputs(num_points, num_valid=c, seed=seed + 100 * f)
              for f, c in enumerate(BATCH_VALID)]
    out = {k: torch.stack([x[k] for x in frames]) for k in frames[0] if k != "tau"}
    out["tau"] = frames[0]["tau"]
    return out


def kernel_phase(rdf: bool, batched: bool, report: dict, errors: dict):
    """Each kernel of one mode (box-only or residual) against its twin:
    K1/K2/K3, or with ``batched`` K4a/K4c/K4b at FRAMES frames. The twin
    runs frame by frame (the batched twin's loop; its autograd graph for
    all frames at once saves ~53 GB of tensors, counted from their shapes),
    and every frame is held to the tolerance.

    The twin that decides the error runs in float64 on the same inputs (in
    float32 for its time). In a frame with no valid instance the union is
    uniform and its gradient weighs each instance's by (1 + (u - d_i) /
    tau), up to +-30 at the main path's distances; that turns a float32
    twin's own rounding (the encoding's phases at 100 m) into 3e-3 of
    grad_x u, while the kernels stay within 1.3e-4 of float64 (NVIDIA H100
    80GB HBM3, 700.00 W)."""
    import torch

    from vsrd_tpu_torch.rendering import fused_field, field_kernels as fk

    mode = "rdf" if rdf else "box"
    names = ("K4a", "K4c", "K4b") if batched else ("K1", "K2", "K3")
    frames = FRAMES if batched else 1
    make = ((lambda p, seed: batched_field_inputs(p, seed)) if batched
            else (lambda p, seed: field_inputs(p, seed=seed)))

    def frame_of(t, f):
        return t[f] if batched else t

    def frame_inputs(x, f, dtype):
        return {k: (v if k == "tau" else frame_of(v, f)).to(dtype) for k, v in x.items()}

    arbiter = torch.float64

    def forward_graph(fn, x):
        params = [x["loc"].clone().requires_grad_(), x["rot"].clone().requires_grad_(),
                  x["half"].clone().requires_grad_()]
        if rdf:
            params.append(x["weights"].clone().requires_grad_())
        u, w, g = fn(x["pos"], *params[:3], x["valid"], params[3] if rdf else None, x["tau"])
        loss = (u * x["du"]).sum() + (w * x["dw"]).sum() + (g * x["dg"]).sum()
        return (u.detach(), w.detach(), g.detach()), loss, params

    # ---- K1 + K2 (K4a + K4c) at the fine pass's P ----
    x = make(199_000, 0)
    weights = x["weights"] if rdf else None
    fwd_args = (x["pos"], x["loc"], x["rot"], x["half"], x["valid"], weights, x["tau"])
    outs_k, loss_k, params_k = forward_graph(fk.fused_field_with_grad, x)
    grads_k = torch.autograd.grad(loss_k, params_k)
    del loss_k, params_k
    fwd_abs, bwd_abs, bwd_plain = 0.0, 0.0, 0.0
    for f in range(frames):
        outs_t, loss_t, params_t = forward_graph(fused_field.scene_eval_with_grad,
                                                 frame_inputs(x, f, arbiter))
        grads_t = torch.autograd.grad(loss_t, params_t)
        del loss_t, params_t
        for name, a, b in zip(("u", "w", "grad"), outs_k, outs_t):
            key = f"{names[0]}_{mode}_{name}"
            errors[key] = max(errors.get(key, 0.0), err(frame_of(a, f).to(arbiter), b))
            fwd_abs = max(fwd_abs, float((frame_of(a, f).to(arbiter) - b).abs().max()))
        for name, a, b in zip(("dloc", "drot", "dhalf", "dweights"), grads_k, grads_t):
            key = f"{names[1]}_{mode}_{name}"
            errors[key] = max(errors.get(key, 0.0), err(frame_of(a, f).to(arbiter), b))
            bwd_abs = max(bwd_abs, float((frame_of(a, f).to(arbiter) - b).abs().max()))
        del outs_t, grads_t
        # the float32 twin's backward for all frames: the sum of each frame's
        _, loss_t, params_t = forward_graph(fused_field.scene_eval_with_grad,
                                            frame_inputs(x, f, torch.float32))
        bwd_plain += median_ms(lambda: torch.autograd.grad(loss_t, params_t, retain_graph=True))
        del loss_t, params_t
    torch.cuda.synchronize()
    twin_fwd = (fused_field.scene_eval_with_grad_batched if batched
                else fused_field.scene_eval_with_grad)
    fwd = lambda: fk.field_forward(*fwd_args)  # noqa: E731
    bwd = lambda: fk.field_backward(*fwd_args, x["du"], x["dw"], x["dg"])  # noqa: E731
    report[f"{names[0]}_{mode}"] = dict(
        frames=frames, max_abs_err=fwd_abs,
        max_rel_err=max(v for k, v in errors.items() if k.startswith(f"{names[0]}_{mode}_")),
        ms=median_ms(fwd), event_ms=event_ms(fwd),
        plain_ms=median_ms(lambda: torch.no_grad()(twin_fwd)(*fwd_args)),
        bound=kernel_bound("K1", rdf, x))
    report[f"{names[1]}_{mode}"] = dict(
        frames=frames, max_abs_err=bwd_abs,
        max_rel_err=max(v for k, v in errors.items() if k.startswith(f"{names[1]}_{mode}_")),
        ms=median_ms(bwd), event_ms=event_ms(bwd), plain_ms=bwd_plain,
        bound=kernel_bound("K2", rdf, x))
    if batched and rdf:
        isolation_check(fk, fwd_args, x)
    del x, outs_k, grads_k

    # ---- K3 (K4b) at the coarse pass's P ----
    x = make(99_000, 1)
    weights = x["weights"] if rdf else None
    dir_args = (x["pos"], x["dirs"], x["loc"], x["rot"], x["half"], x["valid"], weights, x["tau"])
    outs_k = fk.fused_field_dir_forward(*dir_args)
    dir_abs = 0.0
    for f in range(frames):
        outs_t = fused_field.scene_eval_dir(
            *(frame_of(t, f).to(arbiter) for t in dir_args[:6]),
            None if weights is None else frame_of(weights, f).to(arbiter), x["tau"].to(arbiter))
        for name, a, b in zip(("u", "w", "u_dot"), outs_k, outs_t):
            key = f"{names[2]}_{mode}_{name}"
            errors[key] = max(errors.get(key, 0.0), err(frame_of(a, f).to(arbiter), b))
            dir_abs = max(dir_abs, float((frame_of(a, f).to(arbiter) - b).abs().max()))
    twin_dir = fused_field.scene_eval_dir_batched if batched else fused_field.scene_eval_dir
    dirf = lambda: fk.field_dir_forward(*dir_args)  # noqa: E731
    report[f"{names[2]}_{mode}"] = dict(
        frames=frames, max_abs_err=dir_abs,
        max_rel_err=max(v for k, v in errors.items() if k.startswith(f"{names[2]}_{mode}_")),
        ms=median_ms(dirf), event_ms=event_ms(dirf),
        plain_ms=median_ms(lambda: twin_dir(*dir_args)), bound=kernel_bound("K3", rdf, x))
    if rdf:
        # the other form: K1's kernel on the same inputs, in turns with K3
        epilogue = lambda: fk.field_forward(  # noqa: E731
            x["pos"], x["loc"], x["rot"], x["half"], x["valid"], weights, x["tau"])
        turns = {"kernel": [], "epilogue": []}
        for _ in range(3):
            turns["kernel"].append(event_ms(dirf))
            turns["epilogue"].append(event_ms(epilogue))
        report[f"{names[2]}_{mode}"]["forms"] = {k: statistics.median(v) for k, v in turns.items()}


def isolation_check(fk, fwd_args, x):
    """K4c: zero cotangents in frame 2 give exactly zero there, and every
    other frame's cotangents stay bit for bit as they were."""
    import torch

    base = fk.field_backward(*fwd_args, x["du"], x["dw"], x["dg"])
    zeroed = [x[k].clone() for k in ("du", "dw", "dg")]
    for t in zeroed:
        t[2] = 0.0
    again = fk.field_backward(*fwd_args, *zeroed)
    keep = [f for f in range(FRAMES) if f != 2]
    for a, b in zip(again, base):
        if a[2].any():
            fail("K4c: a frame with zero cotangents got non-zero parameter cotangents")
        if not torch.equal(a[keep], b[keep]):
            fail("K4c: zeroing one frame's cotangents changed another frame's result")
    print("[kernels] K4c frame isolation: zero cotangents in frame 2 give exactly 0 there; "
          "the other 7 frames are bit for bit unchanged", flush=True)


def run_path(label: str, frame, cfg, batched: bool):
    """Drive one path (``optimize_frame`` on one frame, or
    ``optimize_frames_batched`` on stacked frames) for cfg.num_steps steps
    with the launch counts set to 0 just before; check its scalars, that
    each field kernel ran exactly once per step, and that K1 and K2 ran
    with the residual field after warmup, K3 too with
    ``kernel_box_coarse=False``. Returns the params, the launches and the
    launches with the residual field."""
    import numpy as np

    from vsrd_tpu_torch.pipeline import optimize as opt
    from vsrd_tpu_torch.rendering import field_kernels as fk

    kernels = (("K4a", "K4c", "K4b") if batched else ("K1", "K2", "K3"))
    launchers = (fk.field_forward, fk.field_backward, fk.field_dir_forward)
    fk.reset_launch_counts()
    start = time.perf_counter()
    run = opt.optimize_frames_batched if batched else opt.optimize_frame
    params, scalars = run(frame, 1, cfg)
    elapsed = time.perf_counter() - start
    counts = {name: (fn.batched_launches if batched else fn.launches - fn.batched_launches)
              for name, fn in zip(kernels, launchers)}
    total = {name: fn.launches for name, fn in zip(kernels, launchers)}
    rdf = {name: fn.rdf_launches for name, fn in zip(kernels, launchers)}
    steps, last, warm = cfg.num_steps, cfg.num_steps - 1, cfg.warmup_steps
    print(f"[{label}] {steps} steps: {elapsed:.2f} s; launches {counts}, with the residual "
          f"field {rdf}", flush=True)
    loss = np.atleast_2d(scalars["loss"].T)
    iou = np.atleast_2d(scalars["iou_3d"].T)
    for f in range(loss.shape[0]):
        print(f"[{label}] frame {f}: loss warmup {loss[f, 0]:.4f} -> {loss[f, warm - 1]:.4f}, "
              f"rdf {loss[f, warm]:.4f} -> {loss[f, last]:.4f}; "
              f"iou_3d @{warm} {iou[f, warm - 1]:.4f} @{steps} {iou[f, last]:.4f}", flush=True)
    for name, values in scalars.items():
        if not np.all(np.isfinite(values)):
            fail(f"non-finite {name} in the {label}: {values}")
    for step in range(cfg.metric_interval - 1, steps, cfg.metric_interval):
        matched = np.atleast_1d(scalars["num_matched"][step])
        if not np.all(matched == 8):
            fail(f"{label}: metrics at step {step + 1} matched {matched.tolist()} of 8 instances")
    expected_rdf = dict(zip(kernels, (steps - warm, steps - warm,
                                      0 if cfg.kernel_box_coarse else steps - warm)))
    for name in kernels:
        if counts[name] != steps or total[name] != steps:
            fail(f"{label}: {name} launched {counts[name]} times ({total[name]} in all) in "
                 f"{steps} steps (expected exactly {steps})")
        if rdf[name] != expected_rdf[name]:
            fail(f"{label}: {name} launched {rdf[name]} times with the residual field "
                 f"(expected {expected_rdf[name]})")
    return params, counts, rdf


def step_times(frame, params, cfg) -> dict:
    """Median ms/step of each phase: one step per call, each ending in a
    host copy, 6 calls per phase, the first dropped."""
    from vsrd_tpu_torch.pipeline import optimize as opt

    optimizer = opt.Adam(cfg)
    state = optimizer.init(params)
    result = {}
    for phase, first in (("warmup", 0), ("rdf", cfg.warmup_steps)):
        times = []
        for i in range(6):
            t0 = time.perf_counter()
            opt.optimize_chunk(params, state, frame, 1, first + i, cfg, 1, optimizer)
            times.append((time.perf_counter() - t0) * 1e3)
        result[phase] = statistics.median(times[1:])
    return result


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on a card")
    try:
        from vsrd_tpu_torch.pipeline import optimize as opt, sharded
        from vsrd_tpu_torch.rendering import field_kernels as fk
    except ImportError as exc:
        fail(f"the port is not importable from here ({exc}); run from the repo root")

    script_start = time.perf_counter()
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
    for name, info in (("rev_forward_kernel", fk.rev_forward_info),
                       ("tangent_forward_kernel", fk.dir_forward_info)):
        for rdf in (True, False):
            threads, smem, ctas = info(8, rdf)
            print(f"[build] {name}<{str(rdf).lower()}, {threads}> at N=8: {smem} bytes of "
                  f"dynamic shared memory, {ctas} CTAs of {threads} threads per SM", flush=True)

    report, errors = {}, {}
    for batched in (False, True):
        for rdf in (False, True):
            kernel_phase(rdf, batched, report, errors)
            torch.cuda.empty_cache()
    for name, value in sorted(errors.items()):
        print(f"[kernels] {name}: rel err {value:.3e}", flush=True)
    for name, entry in sorted(report.items()):
        print(f"[kernels] {name} (F={entry['frames']}): {entry['ms']:.3f} ms host, "
              f"{entry['event_ms']:.3f} ms events (plain {entry['plain_ms']:.3f} ms; bound "
              f"{entry['bound'][0]:.3f} ms by {entry['bound'][1]}) on {card}", flush=True)
        if "forms" in entry:
            forms = entry["forms"]
            print(f"[kernels] {name} forms, events in turns (median of 3): "
                  f"tangent_forward_kernel {forms['kernel']:.4f} ms, the epilogue form "
                  f"(rev_forward_kernel) {forms['epilogue']:.4f} ms: "
                  f"{1 - forms['kernel'] / forms['epilogue']:.1%} less time", flush=True)
    bad = {k: v for k, v in errors.items() if not v <= TOLERANCE}
    if bad:
        fail(f"kernels disagree with their twins beyond {TOLERANCE}: {bad}")
    print(f"[time] through the kernel phase: {time.perf_counter() - script_start:.1f} s",
          flush=True)

    start = time.perf_counter()
    frames = synthetic_frames(list(range(FRAMES)), "cuda")
    torch.cuda.synchronize()
    print(f"[frames] {FRAMES} synthetic frames 17x376x1408, 8 instances: "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    cfg = opt.OptimizationConfig(num_steps=40, warmup_steps=20, num_rays=1000, num_samples=100,
                                 checkpoint_interval=20, metric_interval=20)

    # the coarse pass with the residual field (phase 7)
    coarse_cfg = dataclasses.replace(cfg, num_steps=20, warmup_steps=10, checkpoint_interval=10,
                                     metric_interval=10, kernel_box_coarse=False)

    params, launches, _ = run_path("slice", frames[0], cfg, batched=False)
    single_ms = step_times(frames[0], params, cfg)
    del params
    _, _, coarse_launches = run_path("slice, residual coarse pass", frames[0], coarse_cfg,
                                     batched=False)
    batch = sharded.stack_frames(frames)
    del frames
    params, batched_launches, _ = run_path("batched slice", batch, cfg, batched=True)
    launches.update(batched_launches)
    batch_ms = step_times(batch, params, cfg)
    for phase in ("warmup", "rdf"):
        print(f"[step] {phase}: median ms/step F=1 {single_ms[phase]:.2f}, F={FRAMES} "
              f"{batch_ms[phase]:.2f} ({batch_ms[phase] / FRAMES:.2f} per frame-step) "
              f"on {card}", flush=True)
    del params
    _, _, batched_coarse = run_path("batched slice, residual coarse pass", batch, coarse_cfg,
                                    batched=True)
    coarse_launches.update(batched_coarse)
    del batch

    sources = {
        "K1": ("fused_forward.cu", f"{PALLAS}:111"),
        "K2": ("fused_backward.cu", f"{PALLAS}:214"),
        "K3": ("dir_forward.cu", f"{PALLAS}:138"),
        "K4a": ("fused_forward.cu", f"{PALLAS}:408"),
        "K4c": ("fused_backward.cu", f"{PALLAS}:757"),
        "K4b": ("dir_forward.cu", f"{PALLAS}:542"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        # the main path runs the fine pass and its backward in both modes
        # and the coarse pass box-only; kernel_box_coarse=False runs the
        # coarse pass with the residual field (its launches from phase 7)
        coarse = name in ("K3", "K4b")
        for mode in ("box", "rdf") if coarse else ("rdf",):
            entry = report[f"{name}_{mode}"]
            kernels.append({
                "name": f"{name} ({mode})",
                "route": "cuda",
                "source": f"vsrd_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "frames": entry["frames"],
                "launches": coarse_launches[name] if coarse and mode == "rdf" else launches[name],
                "max_abs_err": entry["max_abs_err"],
                "max_rel_err": entry["max_rel_err"],
                "ms": entry["ms"],
                "event_ms": entry["event_ms"],
                "plain_ms": entry["plain_ms"],
                "bound_ms": entry["bound"][0],
                "bound_by": entry["bound"][1],
                "library_ms": None,
                **({"epilogue_form_event_ms": entry["forms"]["epilogue"]} if "forms" in entry
                   else {}),
            })
    if not all(math.isfinite(k["ms"]) and math.isfinite(k["event_ms"]) for k in kernels):
        fail("a kernel time is not finite")
    print(f"[time] whole run: {time.perf_counter() - script_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
