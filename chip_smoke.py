"""Drive the PyTorch port's main path once on one CUDA card, through its
hand-written kernels, and check what comes out.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. environment: a CUDA card, its name and power limit, the toolchain;
2. build: compile the kernels (csrc/*.cu) with nvcc for sm_90a, one
   nvcc per source in parallel; ptxas's registers and spills of every
   kernel, and K1's and K3's CTA size, shared memory and CTAs per SM;
3. kernels: K1/K2 at P=199,000 points and K3 at P=99,000, N=8 instances
   (6 valid), box-only and with the residual field, each against its plain
   PyTorch twin on the same inputs on the card (max error relative to the
   twin's scale <= 2e-4; the twin evaluated in float64, see kernel_phase),
   with kernel and twin times (median of 20 calls on the host clock, each
   ending in a synchronize; the twin in float32, median of 5), the kernel's time on
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
4. matching: the JV kernel (csrc/matching.cu) against its twin at n = 9,
   16, 24, 32 and 50 for F = 1 and F = 8 frames of padded costs (valid
   counts below n): row_to_col equal entry for entry, and each frame's
   valid block at scipy's total cost; then its time per call at n = 16 and
   32 for F = 1, 2 and 8;
5. frames: the 17-view 376x1408 synthetic frames of seeds 0-7 with 8
   instances, built on host threads;
6. slice: ``optimize_frame`` on frame 0 with 1000 rays and 100+100 samples
   for 40 steps (20 box-only warmup + 20 with the residual field); the
   losses and the 3D IoU must be finite, all 8 instances matched at the
   metric step, and K1, K2 and K3 launched exactly once per step; then the
   median ms/step of each phase;
7. batched slice: ``optimize_frames_batched`` on the 8 frames stacked, the
   same 40 steps; the same checks in every frame, with K4a, K4c and K4b
   launched exactly once per step for all 8 frames; then the median
   ms/step of each phase at F=8 beside F=1, and ms per frame-step;
8. residual coarse pass: frame 0 and the 8 stacked frames again with
   ``kernel_box_coarse=False`` for 20 steps (10 box-only + 10 with the
   residual field), so that the coarse pass runs K3 (K4b) with the field:
   finite scalars, one launch of each kernel per step, and 10 of K3's
   (K4b's) with the residual field;
9. driver: a synthetic KITTI-360 drive written to a temporary directory
   (PNGs by zlib and struct, annotation JSONs with the RLE masks of 12 cars
   projected from their boxes, 17 views of 376x1408 per target, two
   targets), then the labeling driver (``vsrd_tpu_torch.scripts.main``,
   what ``python -m vsrd_tpu_torch.scripts.main --train`` runs, here in
   this process so that the launch counters can be read) on the shipped
   config cut to 40 steps (20 warmup), checkpoints every 20 and
   ``frames_per_batch`` 2: both frames in bucket 16, so that JV and the
   field kernels at N = 16 run, with the native data-path library loaded;
   two final checkpoints in the JAX package's layout, JV and K4a/K4c/K4b
   launched exactly once per step; a second run skips both frames and
   launches nothing; with one final checkpoint deleted, a third run
   resumes that frame from step_19 (20 single-frame steps); a fourth run
   with the photometric weight at 1.0 decodes the textured PNGs and
   launches the sphere-trace kernel once per residual step for both frames.
   Prints the data-load seconds per frame (host) and the seconds per frame;
10. sphere trace: the sphere-trace kernel (csrc/sphere_trace.cu) against its
   eager twin at R = 100 rays for F = 1 and 8 frames and over every pixel of
   one 376x1408 view, box-only and with the residual field (trace_check);
11. photometric slices: phases 6 and 7 again with the photometric weight at
   1.0: one sphere-trace launch per residual step for all frames, a nonzero
   photometric loss after warmup, and the residual step's ms/step at weight
   0 and 1;
12. renders: render_surface_mask (one sphere-trace launch over a view) and
   render_instance_probabilities on frame 0, timed once each;
13. detector (its own ``[time]`` line): the JV kernel at the DETR loss's
   shapes, [8, 50, 50] and [24, 50, 50] (8 images, 1 and 3 decoder levels),
   against its twin entry for entry, on events and the host clock; DETR3D
   and DeformableDETR3D at the JAX class defaults (hidden 256, 3+3 layers, 8
   heads, 50 queries) on a 192x704 batch of 8 with aux outputs, the forward,
   the loss and the gradients on the card against the same weights on the
   CPU in float64, that run's assignment injected (outputs and loss within
   2e-5 of their scale and gradients within 5e-4 for DETR3D, 2e-4 and 2e-3
   for DeformableDETR3D; see DETR_TOLERANCE); the
   pseudo-label lifecycle on the
   driver's drive and final checkpoints: ``make_predictions``, then
   ``train_detector`` at the CLI defaults (hidden 128, 2+2 layers, batch 8
   at 192x704) for 20 steps with the AP|R40 eval at the end, for DETR3D and
   --deformable (loss finite and falling, one JV launch per step, the eval
   keys, a checkpoint; ms/step as the median after the first step), then
   ``convert_predictions`` (KITTI txt of 16 fields); and
   ``diagnostic_panels`` on the slice's frame 0 and params at 376x1408 (the
   names, shapes, values in [0, 1], a ray's red dot and the white wireframe
   at ground-truth corners; its two renders timed again alone, and its cost
   per frame at the shipped config's image_intervals);
14. group skip (its own ``[time]`` line): the masked K1/K2 at P=199,000
   and K3 at P=99,000 (K4a-c at FRAMES frames, frame 1 with no valid
   instance), box-only and with the residual field, at N = 16 and 32, on
   main-path geometry (1000 azimuth-sorted rays, boxes spread as
   ``layout="kitti"``), against their float64 twins with the same keep mask
   (TOLERANCE), each timed with and without the mask, with the mask's kept
   share of (group, tile) pairs; with the residual field and one frame the
   masked launches again at each mask tile of SKIP_TILES, and on a
   clustered scene (groups 60 m apart) masked against unmasked; then the
   slice on a 24-instance kitti-layout frame with ``kernel_group_skip`` off
   and on (every field launch of the run masked, finite losses, all
   instances matched), the median ms/step of each phase off, on at tile 128
   and on at 256, in turns, with the kept shares; then FRAMES stacked
   16-instance frames with the skip on, and their ms/step off and on;
15. sharded step and library (its own ``[time]`` line): (a) four gloo
   processes (this script again, ``--sharded-child RANK PORT DIR``) share the
   card as dp=2 x sp=2 (``pipeline/sharded.py``), two stacked full-width
   frames per dp rank, 500 of the 1000 rays per sp rank, ``deterministic=True``
   and one ray schedule; from states this process pre-ran (steps 0-2 of
   the single-process step) each rank takes its sp-averaged gradients and
   one step in each phase, which must agree with the single-process F=2
   step on the same two frames (SHARDED_SCALAR_BAR, SHARDED_PARAM_BAR,
   SHARDED_GRAD_BAR), the sp ranks of a group
   bit for bit, with K4a, K4c and K4b launched once a step in every rank;
   then SHARDED_TIMED timed steps per phase beside the single-process step
   on all four frames (a record: the ranks share the SMs). A child that
   fails, or hangs past its ``deadline`` (exit 124), fails the phase. (b)
   the library on the card against the port's own functions in float64
   on the CPU (LIBRARY_BARS), each timed on events: ``PlaneSweepStereo``
   (a target and 2 sources of [1, 32, 94, 352], 64 hypotheses over 1-100
   m), ``SpatialPropagation2d`` (k=3, 10 steps, [1, 1, 376, 1408]),
   ``forward_warping`` ([1, 3, 376, 1408]), ``sinkhorn_knopp`` ([50, 8400]),
   ``PackingBlock`` / ``UnpackingBlock`` (64 channels on [1, 64, 188, 704])
   and six losses on [8, 1, 376, 1408] maps.

The second-to-last line is a JSON object with one entry per kernel and
mode of the paths: its launches in its path (K3 and K4b with the residual
field: with the field in phase 8; JV at n = 16: in the driver's first run;
JV at n = 50: in the detector phase's two training runs; the sphere
trace: by mode from its counters in the photometric slices for R = 100 and
in render_surface_mask for the view), its
largest absolute error against the twin and that error relative to the
twin's scale (the pullback to the field weights sums ~200k points, so its
absolute error is large where its relative one is not), its time (``ms``,
host clock; ``event_ms``, CUDA events) beside the twin's, its bound and
what sets it, ``library_ms`` null: no single PyTorch call computes these
functions (the softmin union of per-instance box SDFs plus a per-instance
MLP with LayerNorm and GELU, with tangents or its reverse sweep; a linear
assignment), and for K3/K4b with the residual field
``epilogue_form_event_ms``, the other form's time in turns. The masked
launches of phase 14 have entries of their own ("group skip, N=16/32"):
their launches and ``skip_launches`` are the masked launches of their mode
in the skip slice (K1-K3, 24 instances) or the batched skip slice (K4a-c,
16 instances), beside their time unmasked and the mask's kept share; their
bound counts the kept point-instances only. The entries of K4a, K4c
(residual) and K4b (box-only) also hold phase 15's launches by rank
(``sharded_launches``, ``sharded_rdf_launches``). The last line is ``{"ok":
true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

TOLERANCE = 2e-4          # max |kernel - twin| / max(max|twin|, 1)
REPEATS = 20
# the eager twins' timings, tens to hundreds of ms a call, steady to a few %
PLAIN_REPEATS = 5
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


def kernel_bound(kind: str, rdf: bool, x: dict, pairs: int | None = None) -> tuple[float, str]:
    """The least time (ms) the card could take for one call of kernel
    ``kind`` (K1, K2 or K3 and their frame-batched launches) on the inputs
    ``x``, and whether bytes or operations set it: each input read once and
    each output written once at the HBM rate, against this run's active
    point-instances (valid ones, or all N in a frame with none valid; with
    a group-skip mask, ``pairs``: those a kept group holds) with the layer
    products at the 3xTF32 rate and the rest at the f32 rate, the two
    overlapped."""
    valid = x["valid"].reshape(-1, x["valid"].shape[-1])
    n = valid.shape[-1]
    active = sum(int(c) if c > 0 else n for c in (valid > 0.5).sum(-1).tolist())
    frames, p = valid.shape[0], x["pos"].shape[-2]
    pairs = active * p if pairs is None else pairs
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
        bwd_plain += median_ms(lambda: torch.autograd.grad(loss_t, params_t, retain_graph=True),
                               PLAIN_REPEATS)
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
        plain_ms=median_ms(lambda: torch.no_grad()(twin_fwd)(*fwd_args), PLAIN_REPEATS),
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
        plain_ms=median_ms(lambda: twin_dir(*dir_args), PLAIN_REPEATS),
        bound=kernel_bound("K3", rdf, x))
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


# the value forward's least work per point and active instance, as counted
# for FLOP_F32: the residual field's MLP (1,552 multiply-adds at 2 FLOP), its
# encoding, LayerNorms, GELUs and sigmoid, the box SDF; box only, the box SDF
# and the union's compare (rounded down)
TRACE_FLOP = {"rdf": 3100, "box": 40}
TRACE_ITERATIONS, TRACE_CRITERION, TRACE_RADIUS = 1000, 0.01, 100.0
# an unconverged ray's end off the twin's ray: 2e-4 of the 100 m scale, the
# card tests' bar for every position
TRACE_ACROSS = 2e-4 * TRACE_RADIUS


def trace_scene(frames: int, seed: int, valid_counts, device: str = "cuda"):
    """Scene inputs of the sphere-trace kernel shaped like the main path's:
    ``frames`` frames of 8 boxes 5-40 m ahead with their own validity and
    residual-field weights, ``[F, N, ...]``."""
    import torch

    xs = [field_inputs(1, num_valid=c, seed=seed + 100 * f, device=device)
          for f, c in enumerate(valid_counts[:frames])]
    return {k: torch.stack([x[k] for x in xs]) for k in ("loc", "rot", "half", "valid",
                                                         "weights")}


def trace_rays(scene: dict, rays: int, seed: int):
    """``rays`` rays per frame from a camera at the origin: half aimed at a
    box centre (valid or not) with a jitter of a few tenths of a metre, half
    spread over the view as the fine pass's are."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    frames, n = scene["valid"].shape
    loc = scene["loc"].cpu().numpy()
    aimed = rays // 2
    dirs = np.empty((frames, rays, 3))
    for f in range(frames):
        targets = loc[f, rng.integers(0, n, aimed)] + rng.normal(size=(aimed, 3)) * 0.3
        dirs[f, :aimed] = targets
        dirs[f, aimed:] = rng.normal(size=(rays - aimed, 3)) * [0.3, 0.1, 1.0]
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    t = lambda x: torch.tensor(np.asarray(x, np.float32), device="cuda")  # noqa: E731
    return t(np.zeros((frames, rays, 3))), t(dirs)


def trace_check(label: str, scene: dict, origins, dirs, rdf: bool, temperature, card: str):
    """The sphere-trace kernel against the eager loop (f32, on the card),
    frame by frame: equal trip counts; ``converged`` equal except where the
    deciding |sd| lies within 1e-5 of the criterion (counted); of the rays
    that agree, the converged ones (the surfels, the march's only output
    that the loss and the mask read) within 1e-4 m, except (counted) a
    surfel whose stop the twin reproduces within 1e-4 m with the criterion
    moved by 1e-5 (its deciding |sd| lay at the criterion, so it stopped a
    trip sooner or later, up to 1 cm along its ray), and the others on the
    same side of the bounding sphere and on the twin's ray, within
    TRACE_ACROSS of it. An unconverged ray's distance along its ray is not
    bounded: one that grazed a box and left took steps whose f32 rounding
    the grazing amplifies (the card's fused multiply-adds against the eager
    loop's ops), and its last step out of the sphere is tens of metres long
    (PERF.md, section 7). Then the kernel's time (host median and events),
    the twin's, and the bound. Returns the entry for the kernels line."""
    import torch

    from vsrd_tpu_torch.rendering import field_kernels as fk, renderer, scene as scene_mod

    weights = scene["weights"] if rdf else None
    args = (origins, dirs, torch.ones(origins.shape[:-1], dtype=torch.bool, device="cuda"),
            scene["loc"], scene["rot"], scene["half"], scene["valid"], weights,
            TRACE_ITERATIONS, TRACE_CRITERION, TRACE_RADIUS, temperature)
    pos, conv, trips, evals = fk.sphere_trace(*args)
    frames = origins.shape[0]
    near, at_criterion, worst, across_worst, surfel_worst = 0, 0, 0.0, 0.0, 0.0
    shifted_worst = 0.0
    twin_s = 0.0
    for f in range(frames):
        sp = scene_mod.SceneParams(scene["loc"][f], scene["rot"][f], scene["half"][f],
                                   scene["valid"][f] > 0.5, None if weights is None else weights[f])
        field = (scene_mod.hard_scene_field(sp) if temperature is None
                 else scene_mod.soft_scene_field(sp, temperature))
        torch.cuda.synchronize()
        start = time.perf_counter()
        tpos, tconv, ttrips, tsd = renderer.march_loop(
            lambda p: scene_mod.batched_sdf(field, p), origins[f], dirs[f],
            torch.ones_like(origins[f][..., :1], dtype=torch.bool), TRACE_ITERATIONS,
            TRACE_CRITERION, TRACE_RADIUS)
        torch.cuda.synchronize()
        twin_s += time.perf_counter() - start
        if int(trips[f]) != ttrips:
            fail(f"sphere trace {label}, frame {f}: {int(trips[f])} trips, the twin {ttrips}")
        differ = conv[f] != tconv[..., 0]
        if differ.any():
            at_edge = (tsd[..., 0].abs() - TRACE_CRITERION).abs() <= 1e-5
            if (differ & ~at_edge).any():
                fail(f"sphere trace {label}, frame {f}: converged differs on "
                     f"{int(differ.sum())} rays, {int((differ & ~at_edge).sum())} of them with "
                     f"|sd| farther than 1e-5 from the criterion")
            near += int(differ.sum())
        same = ~differ
        gap = (pos[f] - tpos).abs().max(dim=-1).values
        finite = torch.isfinite(tpos).all(-1)
        if not torch.equal(torch.isfinite(pos[f]).all(-1), finite):
            fail(f"sphere trace {label}, frame {f}: non-finite positions differ from the twin's")
        surfels = same & finite & conv[f]
        off = surfels & (gap > 1e-4)
        if off.any():
            # a surfel that stopped a trip sooner or later than the twin's:
            # the twin's march of that ray with the criterion moved by 1e-5
            # either way must end within 1e-4 m of the kernel's surfel
            idx = off.nonzero()[:, 0]
            explained = torch.zeros_like(idx, dtype=torch.bool)
            for shift in (-1e-5, 1e-5):
                spos, sconv, _, _ = renderer.march_loop(
                    lambda p: scene_mod.batched_sdf(field, p), origins[f][idx], dirs[f][idx],
                    torch.ones_like(idx[:, None], dtype=torch.bool), TRACE_ITERATIONS,
                    TRACE_CRITERION + shift, TRACE_RADIUS)
                explained |= sconv[..., 0] & (
                    (pos[f][idx] - spos).abs().max(dim=-1).values <= 1e-4)
            if not explained.all():
                fail(f"sphere trace {label}, frame {f}: {int((~explained).sum())} surfels "
                     f"differ by up to {float(gap[idx[~explained]].max()):.3e} m, and the "
                     f"criterion moved by 1e-5 does not reproduce them")
            at_criterion += int(off.sum())
            shifted_worst = max(shifted_worst, float(gap[off].max()))
        if (surfels & ~off).any():
            surfel_worst = max(surfel_worst, float(gap[surfels & ~off].max()))
        others = same & finite & ~conv[f]
        if others.any():
            inside = pos[f].norm(dim=-1) < TRACE_RADIUS
            if not torch.equal(inside[others], (tpos.norm(dim=-1) < TRACE_RADIUS)[others]):
                fail(f"sphere trace {label}, frame {f}: an unconverged ray ends on the other "
                     f"side of the bounding sphere than the twin's")
            delta = pos[f] - tpos
            along = (delta * dirs[f]).sum(-1, keepdim=True)
            across = (delta - along * dirs[f]).norm(dim=-1)
            worst = max(worst, float(gap[others].max()))
            across_worst = max(across_worst, float(across[others].max()))
    if surfel_worst > 1e-4 or across_worst > TRACE_ACROSS:
        fail(f"sphere trace {label}: surfels within {surfel_worst:.3e} m (bound 1e-4), the "
             f"other rays' ends {across_worst:.3e} m off the twin's ray (bound {TRACE_ACROSS})")
    run = lambda: fk.sphere_trace(*args)  # noqa: E731
    valid = scene["valid"] > 0.5
    active = torch.where(valid.any(-1), valid.sum(-1), valid.shape[-1]).to(torch.int64)
    evaluations = int((evals.to(torch.int64) * active[:, None]).sum())
    flop = evaluations * TRACE_FLOP["rdf" if rdf else "box"]
    n = valid.shape[-1]
    nbytes = origins.numel() * 4 * 2 + origins.shape[0] * origins.shape[1] * 2
    nbytes += origins.numel() * 4 + frames * n * 16 * 4 + (weights.numel() * 4 if rdf else 0)
    times = {"bytes": nbytes / PEAK_BYTES, "operations": flop / PEAK_F32}
    bound_by = max(times, key=times.get)
    entry = dict(frames=frames, rays=origins.shape[1], max_abs_err=surfel_worst,
                 unconverged_max_abs_err=worst, unconverged_across=across_worst,
                 near_criterion=near, stop_at_criterion=at_criterion,
                 ms=median_ms(run, repeats=5), event_ms=event_ms(run, repeats=5),
                 plain_ms=twin_s * 1e3, bound=(times[bound_by] * 1e3, bound_by),
                 trips=trips.tolist(), converged_share=float(conv.float().mean()),
                 mean_evaluations=float(evals.float().mean()))
    print(f"[trace] {label}: trips {entry['trips']}, converged share "
          f"{entry['converged_share']:.3f}, mean evaluations per ray "
          f"{entry['mean_evaluations']:.1f}; = twin (trips, converged except {near} rays at the "
          f"criterion, surfels within {surfel_worst:.2e} m except {at_criterion} (up to "
          f"{shifted_worst:.2e} m) that the twin reproduces with the criterion moved by 1e-5, "
          f"the other rays' ends within {across_worst:.2e} m of the twin's ray and "
          f"{worst:.2e} m of its end); "
          f"{entry['ms']:.3f} ms host, "
          f"{entry['event_ms']:.3f} ms events (twin {entry['plain_ms']:.1f} ms; bound "
          f"{entry['bound'][0]:.5f} ms by {bound_by}) on {card}", flush=True)
    return entry


def trace_phase(view_frame, card: str) -> dict:
    """Phase 10: the sphere-trace kernel against its twin at the
    photometric shapes (R = 100 rays, F = 1 and 8 frames, frame 1 of 8 with
    no valid instance) and over every pixel of one 376x1408 view of the
    slice's frame 0 (the hard union, and the softmin union at tau 0.5 of
    render_surface_mask), box-only and with the residual field."""
    import torch

    from vsrd_tpu_torch.pipeline.frame import ray_directions_at

    entries = {}
    for frames in (1, FRAMES):
        scene = trace_scene(frames, 7, BATCH_VALID)
        origins, dirs = trace_rays(scene, 100, 8)
        for rdf in (False, True):
            entries[(frames, rdf)] = trace_check(
                f"R=100 F={frames} {'rdf' if rdf else 'box'}", scene, origins, dirs, rdf, None,
                card)
    scene = trace_scene(1, 7, BATCH_VALID)
    h, w = view_frame.image_size
    origins, dirs = ray_directions_at(view_frame, torch.arange(h * w, device="cuda"))
    origins, dirs = origins[None].contiguous(), dirs[None].contiguous()
    for rdf in (False, True):
        for temperature in (None, 0.5):
            union = "hard" if temperature is None else "soft"
            entries[("view", rdf, union)] = trace_check(
                f"one {h}x{w} view, {union} union, {'rdf' if rdf else 'box'}", scene, origins,
                dirs, rdf, temperature, card)
    return entries


def trace_modes(label: str) -> dict:
    """The sphere-trace kernel's launches since the counts were set to 0,
    by mode ("box hard", "rdf hard", "box soft", "rdf soft"), from its
    counters: ``launches``, ``rdf_launches`` and ``soft_launches``. A run
    that mixes the two unions fails, since the counters would not split
    it."""
    from vsrd_tpu_torch.rendering import field_kernels as fk

    st = fk.sphere_trace
    if st.soft_launches not in (0, st.launches):
        fail(f"{label}: {st.soft_launches} of {st.launches} sphere-trace launches with the "
             f"softmin union; the counters split only a run of one union")
    union, other = ("soft", "hard") if st.launches and st.soft_launches else ("hard", "soft")
    return {f"box {union}": st.launches - st.rdf_launches, f"rdf {union}": st.rdf_launches,
            f"box {other}": 0, f"rdf {other}": 0}


def render_phase(params, frame, cfg, card: str) -> dict:
    """Phase 12: render_surface_mask (one launch of the sphere-trace kernel
    over every pixel of view 0) and render_instance_probabilities (K1 in
    row chunks) on the slice's frame 0 with its trained params at the last
    step, timed once each."""
    import torch

    from vsrd_tpu_torch.pipeline import render_image
    from vsrd_tpu_torch.rendering import field_kernels as fk

    step = cfg.num_steps - 1
    fk.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    mask = render_image.render_surface_mask(params, frame, step, cfg)
    torch.cuda.synchronize()
    mask_s = time.perf_counter() - start
    if fk.sphere_trace.launches != 1 or mask.shape != frame.image_size:
        fail(f"render_surface_mask: {fk.sphere_trace.launches} launches, shape {mask.shape}")
    modes = trace_modes("render_surface_mask")
    fk.reset_launch_counts()
    start = time.perf_counter()
    probs = render_image.render_instance_probabilities(params, frame, step, cfg)
    torch.cuda.synchronize()
    probs_s = time.perf_counter() - start
    chunks = frame.image_size[0] // 8
    if (probs.shape != (*frame.image_size, frame.max_instances)
            or not torch.isfinite(probs).all() or fk.field_forward.launches != 2 * chunks):
        fail(f"render_instance_probabilities: shape {tuple(probs.shape)}, "
             f"{fk.field_forward.launches} K1 launches (expected {2 * chunks})")
    share = float(mask.float().mean())
    print(f"[render] render_surface_mask {mask_s * 1e3:.1f} ms (one sphere-trace launch, "
          f"converged share {share:.4f}); render_instance_probabilities {probs_s * 1e3:.1f} ms "
          f"({2 * chunks} K1 launches; max probability {float(probs.max()):.3f}) on {card}",
          flush=True)
    return {"mask_ms": mask_s * 1e3, "probs_ms": probs_s * 1e3, "converged_share": share,
            "sphere_trace": modes}


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
    valid_counts = frame.valid.sum(-1).reshape(-1).tolist()
    fk.reset_launch_counts()
    start = time.perf_counter()
    run = opt.optimize_frames_batched if batched else opt.optimize_frame
    params, scalars = run(frame, 1, cfg)
    elapsed = time.perf_counter() - start
    counts = {name: (fn.batched_launches if batched else fn.launches - fn.batched_launches)
              for name, fn in zip(kernels, launchers)}
    counts["sphere_trace"] = fk.sphere_trace.launches
    counts["sphere_trace modes"] = trace_modes(label)
    skipped = {name: fn.skip_launches for name, fn in zip(kernels, launchers)}
    counts.update({f"{name} skip": c for name, c in skipped.items()})
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
        if matched.tolist() != valid_counts:
            fail(f"{label}: metrics at step {step + 1} matched {matched.tolist()} of "
                 f"{valid_counts} instances")
    photometric = cfg.photometric_weight > 0.0 and frame.gray_images is not None
    if counts["sphere_trace"] != (steps - warm if photometric else 0):
        fail(f"{label}: the sphere-trace kernel launched {counts['sphere_trace']} times in "
             f"{steps} steps (expected {steps - warm if photometric else 0})")
    # the loss is 0 in warmup, and after it 0 only in a step where none of a
    # frame's 100 surfels converged: every step has a frame with surfels and
    # every frame has surfels in some step
    photo = np.atleast_2d(scalars["photometric_loss"].T)
    nonzero = photo[:, warm:] != 0
    if photometric and ((photo[:, :warm] != 0).any() or not nonzero.any(0).all()
                        or not nonzero.any(1).all()):
        fail(f"{label}: photometric_loss {photo.tolist()} (0 in warmup, nonzero after)")
    if photometric:
        print(f"[{label}] photometric_loss per frame, residual steps: "
              f"{[f'{v:.4f}' for v in photo[:, warm:].mean(-1)]} (mean); steps with "
              f"converged surfels {nonzero.sum(1).tolist()} of {steps - warm}", flush=True)
    expected_rdf = dict(zip(kernels, (steps - warm, steps - warm,
                                      0 if cfg.kernel_box_coarse else steps - warm)))
    # with the skip mode above 8 instances every field launch takes a mask
    masked = steps if cfg.kernel_group_skip and frame.max_instances > 8 else 0
    for name in kernels:
        if counts[name] != steps or total[name] != steps:
            fail(f"{label}: {name} launched {counts[name]} times ({total[name]} in all) in "
                 f"{steps} steps (expected exactly {steps})")
        if skipped[name] != masked:
            fail(f"{label}: {name} launched {skipped[name]} times with a group-skip mask "
                 f"(expected {masked})")
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


# KITTI-360's rectified perspective camera image_00 at 376x1408
KITTI_K = ((552.554261, 0.0, 682.049453), (0.0, 552.554261, 238.769549), (0.0, 0.0, 1.0))
DRIVE = "2013_05_28_drive_0000_sync"
DRIVER_CARS = 12
DRIVER_STEPS, DRIVER_WARMUP, DRIVER_CKPT = 40, 20, 20
UNIT_CORNERS = ((-1, -1, 1), (1, -1, 1), (1, -1, -1), (-1, -1, -1),
                (-1, 1, 1), (1, 1, 1), (1, 1, -1), (-1, 1, -1))


def matching_phase(card: str) -> dict:
    """The JV kernel against its twin (phase 4); returns the timings at the
    driver's shape (n = 16, F = 2) for the kernels line."""
    import numpy as np
    import scipy.optimize
    import torch

    from vsrd_tpu_torch.ops import matching

    rng = np.random.default_rng(0)
    worst = 0
    for n in (9, 16, 24, 32, 50):
        for frames in (1, 8):
            cost = rng.normal(size=(frames, n, n)).astype(np.float32)
            counts = [n - 2] if frames == 1 else rng.integers(1, n, size=frames).tolist()
            valid = torch.from_numpy(np.arange(n)[None, :] < np.asarray(counts)[:, None])
            got = matching.masked_linear_sum_assignment(
                torch.from_numpy(cost).cuda(), valid.cuda(), valid.cuda()).cpu()
            want = matching.masked_linear_sum_assignment(torch.from_numpy(cost), valid, valid)
            worst = max(worst, int((got - want).abs().max()))
            if not torch.equal(got, want):
                fail(f"JV at n={n}, F={frames}: the kernel's row_to_col differs from its twin's")
            for f, m in enumerate(counts):
                rows, cols = scipy.optimize.linear_sum_assignment(cost[f, :m, :m])
                total = float(cost[f, np.arange(m), got[f, :m].numpy()].sum())
                if not math.isclose(total, float(cost[f, rows, cols].sum()), rel_tol=1e-5):
                    fail(f"JV at n={n}, F={frames}, frame {f}: total cost {total} is not "
                         f"scipy's {float(cost[f, rows, cols].sum())}")
    print("[matching] JV kernel = its twin entry for entry at n = 9, 16, 24, 32, 50 for F = 1 "
          "and 8 frames with padded rows; every valid block at scipy's total cost", flush=True)

    timings = {}
    for n, frames in ((16, 1), (16, 2), (16, 8), (32, 1), (32, 8)):
        cost = torch.from_numpy(rng.normal(size=(frames, n, n)).astype(np.float32)).cuda()
        valid = torch.arange(n, device="cuda")[None, :] < torch.tensor(
            [n - 2] * frames, device="cuda")[:, None]
        padded = torch.where(valid[..., :, None] & valid[..., None, :], cost, matching.PAD_COST)
        entry = dict(
            frames=frames, n=n, max_abs_err=float(worst),
            ms=median_ms(lambda: matching.jv_assignment(padded)),
            event_ms=event_ms(lambda: matching.jv_assignment(padded)),
            plain_ms=median_ms(lambda: matching.linear_sum_assignment_twin(padded), repeats=5),
            # the cost read once and row_to_col written once; the work is n
            # sequential Dijkstra runs, so the kernel is bound by latency
            bound=(frames * n * (4 * n + 8) / PEAK_BYTES * 1e3, "bytes"))
        timings[(n, frames)] = entry
        print(f"[matching] JV n={n} F={frames}: {entry['ms']:.4f} ms host, "
              f"{entry['event_ms']:.4f} ms events (plain twin on the host {entry['plain_ms']:.2f}"
              f" ms; bound {entry['bound'][0]:.6f} ms by bytes) on {card}", flush=True)
    return timings[(16, 2)]


def png_bytes(pixels) -> bytes:
    """An 8-bit RGB PNG of ``pixels [H, W, 3]`` (uint8), written with zlib and
    struct: rows filtered by Sub and Up in turn, as an encoder would."""
    import struct
    import zlib

    import numpy as np

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    height, width = pixels.shape[:2]
    flat = pixels.reshape(height, -1).astype(np.int16)
    sub, up = flat.copy(), flat.copy()
    sub[:, 3:] -= flat[:, :-3]
    up[1:] -= flat[:-1]
    rows = (np.where((np.arange(height) % 2 == 0)[:, None], sub, up) & 0xFF).astype(np.uint8)
    kinds = np.where(np.arange(height) % 2 == 0, 1, 2).astype(np.uint8)[:, None]
    raw = np.concatenate([kinds, rows], axis=1).tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def synthetic_kitti360(root: str, targets=(8, 9), step: float = 0.5, seed: int = 0) -> str:
    """A KITTI-360 drive of 376x1408 frames 0-17 under ``root``: a camera
    moving ``step`` m per frame along +z, 12 cars on the ground (the camera
    1.65 m above it) on rays 8 degrees apart from the first target's
    camera, alternately 12 and 24 m ahead, each turned along its ray; each
    frame's annotation holds the RLE masks of the cars' visible pixels (by
    slab tests along the pixel rays and a depth test) and their camera-frame
    corners. Returns the sampled-frames file: each target with its 16
    neighbours as sources."""
    import numpy as np

    from vsrd_tpu_torch.data import rle

    rng = np.random.default_rng(seed)
    h, w = 376, 1408
    k = np.asarray(KITTI_K)
    image_dir = os.path.join(root, "data_2d_raw", DRIVE, "image_00", "data_rect")
    os.makedirs(image_dir)
    angles = np.deg2rad(np.arange(-44.0, 45.0, 8.0))
    depths = np.where(np.arange(DRIVER_CARS) % 2 == 0, 12.0, 24.0)
    half = np.array([0.9, 0.75, 2.2])
    centers = np.stack([depths * np.tan(angles), np.full(DRIVER_CARS, 1.65 - half[1]),
                        targets[0] * step + depths], axis=-1)
    rots = []
    for yaw in angles + rng.uniform(-0.1, 0.1, DRIVER_CARS):
        c, s = np.cos(yaw), np.sin(yaw)
        rots.append(np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]))
    corners = [(np.asarray(UNIT_CORNERS) * half) @ r.T + c for r, c in zip(rots, centers)]
    ys, xs = np.mgrid[0:h, 0:w]
    rays = np.stack([(xs - k[0, 2]) / k[0, 0], (ys - k[1, 2]) / k[1, 1], np.ones((h, w))], -1)
    background = ((xs * 7 + ys * 3) % 96 + 64).astype(np.uint8)
    for frame in range(2 * targets[-1]):
        cam = np.array([0.0, 0.0, frame * step])
        depth = np.full((h, w), np.inf)
        owner = np.full((h, w), -1)
        for i in range(DRIVER_CARS):
            cam_corners = corners[i] - cam
            if cam_corners[:, 2].min() < 0.5:
                continue
            pix = cam_corners @ k.T
            pix = pix[:, :2] / pix[:, 2:]
            x0, y0 = np.maximum(np.floor(pix.min(axis=0)).astype(int), 0)
            x1, y1 = np.minimum(np.ceil(pix.max(axis=0)).astype(int), [w - 1, h - 1])
            if x0 > x1 or y0 > y1:
                continue
            box = (slice(y0, y1 + 1), slice(x0, x1 + 1))
            d = rays[box] @ rots[i]                      # rays with z = 1: t is the depth
            o = (cam - centers[i]) @ rots[i]
            with np.errstate(divide="ignore", invalid="ignore"):
                t1, t2 = (-half - o) / d, (half - o) / d
            near = np.nanmax(np.minimum(t1, t2), axis=-1)
            far = np.nanmin(np.maximum(t1, t2), axis=-1)
            closer = (far >= near) & (near > 0) & (near < depth[box])
            depth[box][closer] = near[closer]
            owner[box][closer] = i
        extrinsic = np.eye(4)
        extrinsic[2, 3] = -cam[2]
        annotation = {"intrinsic_matrix": k.tolist(), "extrinsic_matrix": extrinsic.tolist(),
                      "masks": {"car": {}}, "boxes_3d": {"car": {}}}
        for i in range(DRIVER_CARS):
            mask = owner == i
            if mask.sum() >= 8:
                annotation["masks"]["car"][str(26000 + i)] = rle.encode(mask)
                annotation["boxes_3d"]["car"][str(26000 + i)] = (corners[i] - cam).tolist()
        # textured: a ramp behind, each car a shade of its own with a stripe
        # pattern along its image rows
        gray = np.where(owner >= 0, 40 + 12 * owner + (ys % 8) * 4, background).astype(np.uint8)
        image = os.path.join(image_dir, f"{frame:010d}.png")
        with open(image, "wb") as file:
            file.write(png_bytes(np.repeat(gray[..., None], 3, axis=-1)))
        label = image.replace("data_2d_raw", "annotations").replace(".png", ".json")
        os.makedirs(os.path.dirname(label), exist_ok=True)
        with open(label, "w") as file:
            json.dump(annotation, file)
    split = os.path.join(root, "filenames", "smoke", DRIVE)
    os.makedirs(split)
    sampled = os.path.join(split, "sampled_image_filenames.txt")
    relative = ",".join(str(r) for r in range(-8, 9) if r)
    ids = ",".join(str(26000 + i) for i in range(DRIVER_CARS))
    with open(sampled, "w") as file:
        for target in targets:
            file.write(f"{ids} {os.path.join(image_dir, f'{target:010d}.png')} {relative}\n")
    return sampled


def driver_phase(card: str, root: str) -> dict:
    """Phase 9: the labeling driver four times on a synthetic drive written
    under ``root`` (see the module docstring). Returns the JV launches of
    the first run and the drive's sampled-frames file."""
    import glob
    import logging
    import re

    import numpy as np
    import torch

    from vsrd_tpu_torch.data import native
    from vsrd_tpu_torch.ops import matching
    from vsrd_tpu_torch.parallel import distributed as parallel
    from vsrd_tpu_torch.pipeline import optimize as opt
    from vsrd_tpu_torch.rendering import field_kernels as fk
    from vsrd_tpu_torch.scripts import main as driver
    from vsrd_tpu_torch.utils import convert, saver

    if native.load() is None:
        fail(f"the native data-path library (native/vsrd_native.cpp) did not load: "
             f"{native.build_error}")
    launchers = {"K1/K4a": fk.field_forward, "K2/K4c": fk.field_backward,
                 "K3/K4b": fk.field_dir_forward}
    messages = []

    class Collect(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    # the driver's logger, set up as the driver sets it up, and read here too
    parallel.get_logger("vsrd_tpu_torch.main", rank_zero_only=False).addHandler(Collect())
    start = time.perf_counter()
    sampled = synthetic_kitti360(root)
    print(f"[driver] synthetic drive: 18 frames of 376x1408, {DRIVER_CARS} cars, in "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    shipped = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                           "kitti_360", "vsrd", "config.json")
    with open(shipped) as file:
        config = json.load(file)
    config["datasets"]["train"]["kwargs"]["filenames"] = [sampled]
    config["optimization"].update(num_steps=DRIVER_STEPS, warmup_steps=DRIVER_WARMUP,
                                  frames_per_batch=2)
    config["logging"]["ckpt_intervals"] = DRIVER_CKPT
    config_path = os.path.join(root, "configs", "smoke", DRIVE, "config.json")
    os.makedirs(os.path.dirname(config_path))
    with open(config_path, "w") as file:
        json.dump(config, file)
    ckpt_root = os.path.join(root, "ckpts", "smoke", DRIVE)

    def drive(label, path=config_path):
        messages.clear()
        fk.reset_launch_counts()
        matching.reset_launch_counts()
        start = time.perf_counter()
        driver.main(["--config", path, "--train"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        counts = {"JV": matching.jv_assignment.launches,
                  "sphere_trace": fk.sphere_trace.launches}
        for name, fn in launchers.items():
            counts[name] = (fn.launches, fn.batched_launches)
        print(f"[driver] {label}: {wall:.2f} s; launches {counts} (all, with F > 1)",
              flush=True)
        return wall, counts

    def finals():
        return sorted(glob.glob(os.path.join(ckpt_root, "**", f"step_{DRIVER_STEPS - 1}.npz"),
                                recursive=True))

    wall, counts = drive("first run, 2 frames co-optimized")
    loads = [float(m) for m in re.findall(
        r"17 views at 376x1408, 12 instances in bucket 16: ([\d.]+) s", "\n".join(messages))]
    if len(loads) != 2:
        fail(f"driver: expected 2 frames of 17 views with 12 cars in bucket 16, got {messages}")
    steps = DRIVER_STEPS
    expected = {"JV": steps, "sphere_trace": 0, **{name: (steps, steps) for name in launchers}}
    if counts != expected:
        fail(f"driver: launches {counts}, expected {expected} (once per step for the batch)")
    done = finals()
    layout = opt.tree_map(lambda t: tuple(t.shape), opt.init_params(
        torch.Generator().manual_seed(0), 16, opt.OptimizationConfig()))
    layout = {"detector": layout["boxes"], "hyper_distance_field": layout["hyper"]}
    if len(done) != 2:
        fail(f"driver: {len(done)} final checkpoints, expected 2")
    for path in done + [p.replace(f"step_{steps - 1}", f"step_{DRIVER_CKPT - 1}")
                        for p in done]:
        ckpt = saver.load_checkpoint(path)
        final = path in done
        keys = {"step", "models", "metrics", "valid"} | (set() if final else {"opt_state"})
        shapes = opt.tree_map(lambda a: tuple(a.shape), ckpt["models"])
        if set(ckpt) != keys or shapes != layout or int(ckpt["valid"].sum()) != DRIVER_CARS:
            fail(f"driver: {path} is not in the JAX layout: keys {sorted(ckpt)}")
        if not all(np.isfinite(v).all() for v in ckpt["metrics"].values()):
            fail(f"driver: non-finite metrics in {path}: {ckpt['metrics']}")
        if not final and int(ckpt["opt_state"]["count"]) != DRIVER_CKPT:
            fail(f"driver: {path} holds the Adam count {ckpt['opt_state']['count']}")
        convert.params_from_jax({"boxes": ckpt["models"]["detector"],
                                 "hyper": ckpt["models"]["hyper_distance_field"]}, "cuda")
    metrics = saver.load_checkpoint(done[0])["metrics"]
    print(f"[driver] 2 final checkpoints in the JAX layout at bucket 16; frame 0 step "
          f"{steps}: loss {float(metrics['loss']):.4f}; data load per frame (host) "
          f"{', '.join(f'{t:.2f}' for t in loads)} s; {wall / 2:.2f} s per frame for "
          f"{steps} steps with the load, {(wall - sum(loads)) / 2:.2f} without, on {card}",
          flush=True)

    _, again = drive("second run")
    idle = {"JV": 0, "sphere_trace": 0, **{name: (0, 0) for name in launchers}}
    if sum("already optimized" in m for m in messages) != 2 or again != idle:
        fail(f"driver: the second run did not skip both frames: {messages}, {again}")

    os.remove(done[0])
    _, resumed = drive("third run, one final checkpoint deleted")
    rest = DRIVER_STEPS - DRIVER_CKPT
    if not any(f"resuming from step_{DRIVER_CKPT - 1}" in m for m in messages):
        fail(f"driver: the third run did not resume from step_{DRIVER_CKPT - 1}: {messages}")
    if (sum("already optimized" in m for m in messages) != 1 or finals() != done
            or resumed != {"JV": rest, "sphere_trace": 0,
                           **{name: (rest, 0) for name in launchers}}):
        fail(f"driver: the resumed run: {messages}, launches {resumed}")
    print(f"[driver] second run skipped both frames with no launch; third run resumed "
          f"frame 0 from step_{DRIVER_CKPT - 1} for {rest} single-frame steps", flush=True)

    # the photometric branch: the driver decodes the textured PNGs
    config["loss_weights"] = dict(config.get("loss_weights", {}), photometric_loss=1.0)
    photo_path = config_path.replace(os.sep + "smoke" + os.sep,
                                     os.sep + "smoke_photometric" + os.sep)
    os.makedirs(os.path.dirname(photo_path))
    with open(photo_path, "w") as file:
        json.dump(config, file)
    photo_wall, photo_counts = drive("fourth run, photometric weight 1.0", photo_path)
    photo_loads = [float(m) for m in re.findall(
        r"17 views at 376x1408, 12 instances in bucket 16: ([\d.]+) s", "\n".join(messages))]
    photo_done = sorted(glob.glob(os.path.join(
        root, "ckpts", "smoke_photometric", "**", f"step_{steps - 1}.npz"), recursive=True))
    want = {"JV": steps, "sphere_trace": steps - DRIVER_WARMUP,
            **{name: (steps, steps) for name in launchers}}
    if photo_counts != want or len(photo_done) != 2 or len(photo_loads) != 2:
        fail(f"driver, photometric run: launches {photo_counts} (expected {want}), "
             f"{len(photo_done)} final checkpoints, {messages}")
    photo_metrics = saver.load_checkpoint(photo_done[0])["metrics"]
    if not all(np.isfinite(v).all() for v in photo_metrics.values()):
        fail(f"driver, photometric run: non-finite metrics {photo_metrics}")
    print(f"[driver] photometric run: 2 frames, sphere trace launched "
          f"{photo_counts['sphere_trace']} times; data load with the pixels decoded "
          f"{', '.join(f'{t:.2f}' for t in photo_loads)} s per frame; {photo_wall / 2:.2f} s "
          f"per frame with it on {card}", flush=True)
    return {"launches": counts, "load_s": loads, "wall_s": wall,
            "photometric_load_s": photo_loads, "photometric_wall_s": photo_wall,
            "sampled": sampled}


DETR_SHAPES = (8, 24)                  # [B * L, 50, 50]: 8 images, 1 and 3 decoder levels
DETR_QUERIES = 50
DETR_STEPS = 20
# the detector on the card against the same weights on the CPU in float64:
# (outputs and loss, gradients) within these shares of each one's and each
# leaf's scale. On an NVIDIA H100 80GB HBM3 this phase read DETR3D at 2.30e-6
# and 7.77e-5, DeformableDETR3D at 6.14e-5 and 3.81e-4: the deformable
# decoder amplifies f32 rounding layer by layer, on any device (the CPU's own
# f32 run read 1.33e-4 and 4.60e-3 there), so f32 on the CPU is no reference
# and each variant has bars of its own.
DETR_TOLERANCE = {"DETR3D": (2e-5, 5e-4), "DeformableDETR3D": (2e-4, 2e-3)}


def detr_costs(frames: int, seed: int):
    """``[frames, 50, 50]`` DETR matching costs (``detr3d.matching_cost``)
    of random head outputs against up to 16 targets, PAD_COST elsewhere."""
    import torch

    from vsrd_tpu_torch.models import detr3d

    gen = torch.Generator().manual_seed(seed)
    n = 16
    corner = torch.rand(frames, n, 2, generator=gen) * 0.6
    valid = torch.arange(n)[None] < torch.randint(1, n + 1, (frames, 1), generator=gen)
    return detr3d.matching_cost(
        {"logits": torch.randn(frames, DETR_QUERIES, 2, generator=gen),
         "boxes_2d": torch.rand(frames, DETR_QUERIES, 4, generator=gen)},
        torch.zeros(frames, n, dtype=torch.int32), torch.cat([corner, corner + 0.2], -1), valid)


def detr_jv_phase(card: str) -> dict:
    """JV at the DETR loss's shapes against its twin, timed on events and on
    the host; returns the [8, 50, 50] entry for the kernels line."""
    from vsrd_tpu_torch.ops import matching

    out = {}
    for frames in DETR_SHAPES:
        cost = detr_costs(frames, frames)
        start = time.perf_counter()
        want = matching.linear_sum_assignment_twin(cost)
        plain = (time.perf_counter() - start) * 1e3
        padded = cost.cuda()
        got = matching.jv_assignment(padded).cpu()
        if not (got == want).all():
            fail(f"JV at [{frames}, 50, 50]: the kernel's row_to_col differs from its twin's")
        entry = dict(frames=frames, n=DETR_QUERIES, max_abs_err=0.0,
                     ms=median_ms(lambda: matching.jv_assignment(padded)),
                     event_ms=event_ms(lambda: matching.jv_assignment(padded)), plain_ms=plain,
                     bound=(frames * DETR_QUERIES * (4 * DETR_QUERIES + 8) / PEAK_BYTES * 1e3,
                            "bytes"))
        out[frames] = entry
        print(f"[detector] JV [{frames}, 50, 50] = its twin entry for entry; "
              f"{entry['ms']:.4f} ms host, {entry['event_ms']:.4f} ms events (plain twin on the "
              f"host {plain:.1f} ms; bound {entry['bound'][0]:.6f} ms by bytes) on {card}",
              flush=True)
    return out[DETR_SHAPES[0]]


def detr_model_phase(card: str) -> None:
    """DETR3D and DeformableDETR3D at the JAX class defaults (hidden 256,
    3+3 layers, 8 heads, 50 queries) on a 192x704 batch of 8 with aux
    outputs: the forward, the loss and the gradients on the card (f32)
    against the same weights on the CPU in float64, with the float64 run's
    assignment injected; the CPU's f32 run is read against the same
    reference for scale. An attention key bias's gradient is zero in exact
    arithmetic (the softmax ignores a shift shared by every key), so it is
    held to the largest gradient instead of its own scale."""
    import numpy as np
    import torch

    from vsrd_tpu_torch.models import detr3d
    from vsrd_tpu_torch.ops import matching

    rng = np.random.default_rng(0)
    b, n = 8, 16
    k = np.asarray(KITTI_K, np.float32) * np.float32([[0.5], [0.5], [1.0]])
    corner = rng.uniform(0.05, 0.7, size=(b, n, 2)).astype(np.float32)
    batch = {
        "images": torch.from_numpy(rng.random((b, 192, 704, 3)).astype(np.float32)),
        "intrinsics": torch.from_numpy(np.broadcast_to(k, (b, 3, 3)).copy()),
        "labels": torch.zeros(b, n, dtype=torch.int32),
        "boxes_2d": torch.from_numpy(np.concatenate([corner, corner + 0.2], -1)),
        "boxes_3d": torch.from_numpy((rng.normal(size=(b, n, 8, 3)) * 2 + [0, 1, 20]).astype(
            np.float32)),
        "valid": torch.from_numpy(np.arange(n)[None] < rng.integers(1, n + 1, size=(b, 1))),
    }

    def run(deformable, device, dtype, rows):
        model = detr3d.make_detector(deformable, seed=0, device="cpu").to(device, dtype)
        on = {key: value.to(device, dtype) if value.is_floating_point() else value.to(device)
              for key, value in batch.items()}
        start = time.perf_counter()
        out = model(on["images"], on["intrinsics"], aux_outputs=True)
        if rows is None:
            levels = [out] + out["aux_outputs"]
            costs = torch.cat([detr3d.matching_cost(level, on["labels"], on["boxes_2d"],
                                                    on["valid"]) for level in levels])
            rows = matching.linear_sum_assignment(costs).reshape(len(levels), b, -1)
        loss, _ = detr3d.detr_loss(out, on["labels"], on["boxes_2d"], on["boxes_3d"],
                                   on["valid"], row_to_col=rows.unbind(0))
        loss.backward()
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        outputs = {key: out[key].detach().double().cpu() for key in
                   ("logits", "boxes_2d", "boxes_3d", "locations")}
        outputs["loss"] = loss.detach().double().cpu()
        grads = {name: p.grad.double().cpu() for name, p in model.named_parameters()
                 if p.grad is not None}
        return outputs, grads, rows, seconds

    def errors(outputs, grads, ref_outputs, ref_grads):
        out = max(float((outputs[key] - v).abs().max() / v.abs().max())
                  for key, v in ref_outputs.items())
        largest = max(float(g.abs().max()) for g in ref_grads.values())
        grad = max(float((grads[name] - g).abs().max())
                   / (largest if name.endswith("key.bias") else float(g.abs().max()))
                   for name, g in ref_grads.items())
        return out, grad

    for deformable in (False, True):
        ref_out, ref_grads, rows, _ = run(deformable, "cpu", torch.float64, None)
        cpu_out, cpu_grads, _, cpu_s = run(deformable, "cpu", torch.float32, rows)
        card_out, card_grads, _, card_s = run(deformable, "cuda", torch.float32, rows)
        name = "DeformableDETR3D" if deformable else "DETR3D"
        card_err, card_grad = errors(card_out, card_grads, ref_out, ref_grads)
        cpu_err, cpu_grad = errors(cpu_out, cpu_grads, ref_out, ref_grads)
        out_bar, grad_bar = DETR_TOLERANCE[name]
        if (set(card_grads) != set(ref_grads) or not card_err <= out_bar
                or not card_grad <= grad_bar):
            fail(f"{name} on the card against float64 on the CPU: outputs and loss "
                 f"{card_err:.3e}, gradients {card_grad:.3e}")
        print(f"[detector] {name} (hidden 256, 3+3 layers, 50 queries, batch 8 at 192x704, aux "
              f"outputs) against float64 on the CPU: the card's outputs and loss {card_err:.2e} "
              f"(bar {out_bar}), gradients {card_grad:.2e} (bar {grad_bar}); "
              f"the CPU's f32 run {cpu_err:.2e} and {cpu_grad:.2e}; forward+loss+backward "
              f"{card_s * 1e3:.1f} ms on the card (first call), {cpu_s * 1e3:.1f} ms on the CPU",
              flush=True)


def lifecycle_phase(card: str, root: str, sampled: str) -> dict:
    """make_predictions on the driver's final checkpoints, train_detector at
    the CLI defaults for 20 steps with the eval at the end (DETR3D, then
    --deformable), then convert_predictions. Returns the JV launches of the
    two training runs and their step times."""
    import glob

    import numpy as np

    from vsrd_tpu_torch.ops import matching
    from vsrd_tpu_torch.scripts import train_detector
    from vsrd_tpu_torch.tools.kitti_360 import convert_predictions, make_predictions

    # make_predictions groups the frames by instance-id set: one key per target
    with open(sampled) as file:
        lines = [line.split() for line in file if line.strip()]
    split = os.path.join(root, "filenames", "smoke_groups", DRIVE)
    os.makedirs(split)

    def frames_of(target):
        index = int(os.path.basename(target)[:-4])
        return [os.path.join(os.path.dirname(target), f"{f:010d}.png")
                for f in range(index - 8, index + 9)]

    with open(os.path.join(split, "grouped_image_filenames.txt"), "w") as grouped, \
            open(os.path.join(split, "sampled_image_filenames.txt"), "w") as out:
        for index, (ids, target, relative) in enumerate(lines):
            ids = ",".join(ids.split(",")[::-1] if index % 2 else ids.split(","))
            grouped.write(f"{ids} {','.join(frames_of(target))}\n")
            out.write(f"{ids} {target} {relative}\n")
    ckpt_dirname = os.path.join(root, "ckpts", "smoke")
    start = time.perf_counter()
    make_predictions.make_predictions(DRIVE, root, ckpt_dirname, f"step_{DRIVER_STEPS - 1}.npz",
                                      "smoke_groups", ["car"])
    predictions = sorted(glob.glob(os.path.join(root, "predictions", "smoke", DRIVE, "image_00",
                                                "data_rect", "*.json")))
    expected = len({f for _, target, _ in lines for f in frames_of(target) if os.path.exists(f)})
    if len(predictions) != expected:
        fail(f"make_predictions wrote {len(predictions)} JSONs, expected {expected}")
    with open(predictions[len(predictions) // 2]) as file:
        labels = json.load(file)
    confidences = np.asarray(labels["confidences"]["car"])
    if np.asarray(labels["boxes_3d"]["car"]).shape != (DRIVER_CARS, 8, 3):
        fail(f"make_predictions: the middle frame holds {len(confidences)} boxes, not "
             f"{DRIVER_CARS}")
    print(f"[detector] make_predictions: {len(predictions)} JSONs of {DRIVER_CARS} cars in "
          f"{time.perf_counter() - start:.1f} s (host); the middle frame's confidences "
          f"{confidences.min():.3f}-{confidences.max():.3f}", flush=True)

    runs = {}
    for variant in ("DETR3D", "DeformableDETR3D"):
        matching.reset_launch_counts()
        argv = ["--root_dirname", root, "--ckpt_dirname", "ckpts/smoke",
                "--out_dirname", os.path.join(root, "detr", variant),
                "--num_steps", str(DETR_STEPS), "--confidence_threshold", "0.0"]
        history = train_detector.main(argv + (["--deformable"] if variant != "DETR3D" else []))
        launches = matching.jv_assignment.launches
        losses = history["losses"]
        metrics = history["eval"] or {}
        ms = statistics.median(history["step_seconds"][1:]) * 1e3
        if (not all(math.isfinite(v) for v in losses) or launches != DETR_STEPS
                or not np.mean(losses[-5:]) < np.mean(losses[:5])
                or not {"ap_r40_0.25", "ap_r40_0.5", "ap_r40_0.5_moderate"} <= set(metrics)
                or not os.path.exists(history["checkpoint"])):
            fail(f"train_detector {variant}: losses {losses}, {launches} JV launches (expected "
                 f"{DETR_STEPS}), eval {metrics}")
        r40 = {k: round(v, 4) for k, v in sorted(metrics.items()) if k.startswith("ap_r40")}
        print(f"[detector] train_detector {variant} (hidden 128, 2+2 layers, 50 queries, batch 8 "
              f"at 192x704): loss {losses[0]:.3f} -> {losses[-1]:.3f} in {DETR_STEPS} steps, "
              f"{ms:.1f} ms/step (median after the first; first {history['step_seconds'][0]:.2f} "
              f"s), {launches} JV launches; eval {history['eval_seconds'] * 1e3:.0f} ms: "
              f"{json.dumps(r40)} on {card}", flush=True)
        runs[variant] = {"launches": launches, "ms_per_step": ms,
                         "eval_ms": history["eval_seconds"] * 1e3}

    convert_predictions.convert_predictions(DRIVE, root, ckpt_dirname, ["car"])
    txts = glob.glob(os.path.join(root, "labels", "smoke", "**", "*.txt"), recursive=True)
    fields = [line.split(" ") for path in txts for line in open(path).read().splitlines()]
    if len(txts) != 2 * len(predictions) or not fields or any(
            len(f) != 16 or f[0] != "Car" for f in fields):
        fail(f"convert_predictions: {len(txts)} KITTI txt files, lines {fields[:2]}")
    print(f"[detector] convert_predictions: {len(txts)} KITTI txt files, {len(fields)} lines of "
          f"16 fields", flush=True)
    return runs


def panels_phase(params, frame, cfg, card: str) -> None:
    """diagnostic_panels on the slice's frame 0 (17 views at 376x1408) and
    its params at the last step: names, shapes, values in [0, 1], a ray's
    red dot and a ground-truth corner's white wireframe pixel."""
    import numpy as np
    import torch

    from vsrd_tpu_torch.ops import sampling
    from vsrd_tpu_torch.pipeline import render_image
    from vsrd_tpu_torch.visualization import panels

    h, w = frame.image_size
    target = int(frame.target_index)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rays = frame.candidate_indices[sampling.multinomial_logits(
        frame.candidate_weights, cfg.num_rays, gen)].cpu().numpy()
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = panels.diagnostic_panels(params, frame, cfg.num_steps - 1, cfg, ray_indices=rays)
    seconds = time.perf_counter() - start
    # the panels' two renders of the target view again, alone: the rest of
    # the call is the host's drawing, with the card idle
    start = time.perf_counter()
    render_image.render_instance_probabilities(params, frame, cfg.num_steps - 1, cfg,
                                               view=target)
    render_image.render_surface_mask(params, frame, cfg.num_steps - 1, cfg, view=target)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - start
    # the driver draws them at each checkpoint that falls on image_intervals,
    # once per frame of a batch, when a tensorboardX writer exists
    shipped = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                           "kitti_360", "vsrd", "config.json")
    with open(shipped) as file:
        config = json.load(file)
    steps = config["optimization"].get("num_steps", 3000)
    ckpt = config["logging"].get("ckpt_intervals", 500)
    every = config["logging"].get("image_intervals", 500)
    ends = sorted(set(range(ckpt, steps, ckpt)) | {steps})
    calls = sum(1 for end in ends if end % every == 0)
    names = {f"gt/{v - target}" for v in range(frame.num_views)} | {"pd/0", "bev/0"}
    bad = [name for name, image in out.items()
           if image.shape != ((1000, 1000, 3) if name == "bev/0" else (h, w, 3))
           or not np.isfinite(image).all() or image.min() < 0 or image.max() > 1]
    if set(out) != names or bad:
        fail(f"diagnostic_panels: names {sorted(out)}, bad panels {bad}")
    view, y, x = rays[0] // (h * w), (rays[0] % (h * w)) // w, rays[0] % w
    if out[f"gt/{view - target}"][y, x].tolist() != [1.0, 0.0, 0.0]:
        fail(f"diagnostic_panels: no red dot at ray 0 (view {view}, y {y}, x {x})")
    # a ground-truth corner in front of the target camera, away from the dots
    # projected as the panel projects them
    cam = panels._camera_boxes(frame.gt_boxes_3d[frame.valid].cpu().numpy(),
                               frame.extrinsics[target].cpu().numpy()).reshape(-1, 3)
    pix = cam @ frame.intrinsics[target].cpu().numpy().astype(np.float64).T
    dots = rays[rays // (h * w) == target]
    dot_xy = np.stack([dots % w, (dots % (h * w)) // w], -1)
    checked = 0
    for (px, py, pz), depth in zip(pix, cam[:, 2]):
        u, v = int(px / max(pz, 1e-6)), int(py / max(pz, 1e-6))
        if depth > 0.5 and 0 <= u < w and 0 <= v < h and (
                not len(dot_xy) or np.abs(dot_xy - [u, v]).max(-1).min() > 3):
            if out["gt/0"][v, u].tolist() != [1.0, 1.0, 1.0]:
                fail(f"diagnostic_panels: the wireframe corner at ({u}, {v}) is not white")
            checked += 1
    if not checked:
        fail("diagnostic_panels: no ground-truth corner inside the target view")
    print(f"[detector] diagnostic_panels: {len(out)} panels ({frame.num_views} views of "
          f"{h}x{w} and the BEV) in {seconds:.2f} s (its two renders alone {render_s:.2f} s, "
          f"the host's drawing the rest), ray 0's dot and {checked} wireframe corners where "
          f"expected; at the shipped config's {steps} steps, ckpt_intervals {ckpt} and "
          f"image_intervals {every}, {calls} calls add {calls * seconds:.1f} s to each frame "
          f"when tensorboardX is installed, on {card}", flush=True)


def detector_phase(card: str, root: str, sampled: str, params, frame, cfg) -> dict:
    """Phase 13 (see the module docstring); returns the JV entry of the
    kernels line at the DETR shape and the training runs' numbers."""
    start = time.perf_counter()
    jv = detr_jv_phase(card)
    detr_model_phase(card)
    runs = lifecycle_phase(card, root, sampled)
    panels_phase(params, frame, cfg, card)
    print(f"[time] detector phase: {time.perf_counter() - start:.1f} s", flush=True)
    return {"jv": jv, "runs": runs}


# ---- phase 14: per-tile instance-group skipping ----
SKIP_KERNEL_N = (16, 32)      # instances of the masked kernels' checks
SKIP_SLICE_N = 24             # instances of the skip slice's frame (kitti layout)
SKIP_BATCH_N = 16             # instances of each frame of the batched skip slice
SKIP_TILES = (128, 256)       # the mask tiles timed against each other
SKIP_TAU = 0.5                # the kernel phase's temperature: a keep slack of 8 m


def skip_valid_counts(n: int):
    """Valid instances per frame of the masked batched checks: frame 1 has
    none, so its mask keeps every group."""
    return (n - 2, 0, n, n - 2, n, n - 2, n, n - 2)


def skip_field_inputs(num_rays: int, num_samples: int, n: int, num_valid: int, seed: int,
                      device: str = "cuda"):
    """Field inputs shaped like a skip-mode field call of the main path:
    ``num_rays`` rays from a camera at the origin across a 376x1408 view's
    field of view, in ``optimize.ray_order``, with ``num_samples`` points
    along each at increasing depths over 0-100 m (a ray's points
    consecutive, as the renderer lays them out); ``n`` boxes spread as
    ``layout="kitti"`` spreads them (z in [5, 80] m, |x| <= 0.3 z) in
    ``optimize.instance_order`` (valid by azimuth, the other ``n -
    num_valid`` last); weights and cotangents as ``field_inputs``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    rays = np.stack([rng.uniform(-1.2, 1.2, num_rays), rng.uniform(-0.3, 0.3, num_rays),
                     np.ones(num_rays)], -1)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    rays = rays[np.argsort(np.arctan2(rays[:, 0], rays[:, 2]), kind="stable")]
    depth = np.sort(rng.uniform(0.0, 100.0, size=(num_rays, num_samples)), axis=-1)
    pos = (rays[:, None, :] * depth[..., None]).reshape(-1, 3)
    dirs = np.repeat(rays, num_samples, axis=0)
    z = rng.uniform(5.0, 80.0, n)
    loc = np.stack([rng.uniform(-0.3, 0.3, n) * z, rng.uniform(0.3, 0.8, n), z], -1)
    loc = loc[np.argsort(np.arctan2(loc[:, 0], loc[:, 2]), kind="stable")]
    yaw = rng.uniform(-0.4, 0.4, n)
    rot = np.stack([
        [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]] for a in yaw
    ])
    half = rng.uniform([0.75, 0.75, 1.5], [1.0, 1.0, 2.5], size=(n, 3))
    p = num_rays * num_samples
    t = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
    return dict(
        pos=t(pos), dirs=t(dirs), loc=t(loc), rot=t(rot), half=t(half),
        valid=t(np.arange(n) < num_valid), weights=t(rng.normal(size=(n, 1617)) * 0.3),
        tau=torch.tensor(SKIP_TAU, device=device), du=t(rng.normal(size=p)),
        dw=t(rng.normal(size=(p, n))), dg=t(rng.normal(size=(p, 3))),
    )


def clustered_field_inputs(num_points: int, n: int, seed: int, device: str = "cuda"):
    """A clustered scene, where the mask drops most groups: instance group g
    (8 instances) about a centre 60 m down +z from group g - 1, the points
    in runs of consecutive points about one group after another; weights
    and cotangents as ``field_inputs``."""
    import numpy as np
    import torch

    x = field_inputs(num_points, n, n - 2, seed, device)
    rng = np.random.default_rng(seed)
    groups = -(-n // 8)
    centre = lambda g: np.stack([np.zeros_like(g), np.full(g.shape, 0.5), 10.0 + 60.0 * g], -1)  # noqa: E731
    loc = centre(np.arange(n) // 8) + rng.normal(size=(n, 3)) * [3.0, 0.2, 3.0]
    pos = centre((np.arange(num_points) * groups) // num_points) + rng.normal(
        size=(num_points, 3)) * 4.0
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    return dict(x, loc=t(loc), pos=t(pos))


def skip_inputs(num_samples: int, n: int, batched: bool, seed: int):
    """``skip_field_inputs`` of 1000 rays, one frame or FRAMES frames
    (``skip_valid_counts``) stacked."""
    import torch

    if not batched:
        return skip_field_inputs(1000, num_samples, n, n - 2, seed)
    frames = [skip_field_inputs(1000, num_samples, n, c, seed + 100 * f)
              for f, c in enumerate(skip_valid_counts(n))]
    out = {k: torch.stack([x[k] for x in frames]) for k in frames[0] if k != "tau"}
    out["tau"] = frames[0]["tau"]
    return out


def in_turns(first, second) -> tuple[float, float]:
    """``event_ms`` of two launches in turns (first, second, second, first),
    each one's mean: a comparison that clock and power drift after other
    work cannot bias."""
    a, b = event_ms(first), event_ms(second)
    b, a = (b + event_ms(second)) / 2, (a + event_ms(first)) / 2
    return a, b


def kept_pairs(x: dict, mask) -> int:
    """The (point, instance) pairs a masked launch evaluates: active
    instances (the valid ones, or all in a frame with none valid) in a
    group that the point's tile keeps."""
    from vsrd_tpu_torch.rendering import field_kernels as fk, fused_field

    valid = x["valid"].reshape(-1, x["valid"].shape[-1]) > 0.5
    active = valid | ~valid.any(-1, keepdim=True)
    keep = fused_field.point_keep(mask.reshape(valid.shape[0], *mask.shape[-2:]),
                                  x["pos"].shape[-2], valid.shape[-1], fk.MASK_TILE)
    return int((keep & active[:, None, :]).sum())


def skip_kernel_phase(n: int, batched: bool, report: dict, errors: dict):
    """Phase 14a: the masked K1/K2 at P=199,000 and K3 at P=99,000 (K4a-c at
    FRAMES frames), box-only and with the residual field, against their
    float64 twins with the same mask, frame by frame (tolerance TOLERANCE);
    their times with and without the mask, the mask's kept share of (group,
    tile) pairs, and the bound from the kept pairs; with the residual field
    and one frame, the masked launches again at every tile of SKIP_TILES."""
    import torch

    from vsrd_tpu_torch.rendering import field_kernels as fk, fused_field

    names = ("K4a", "K4c", "K4b") if batched else ("K1", "K2", "K3")
    frames = FRAMES if batched else 1
    arbiter = torch.float64

    def frame_of(t, f):
        return t[f] if batched else t

    def twin_graph(x, f, dtype, mask, rdf):
        c = {k: (v if k == "tau" else frame_of(v, f)).to(dtype) for k, v in x.items()}
        params = [c[k].clone().requires_grad_() for k in ("loc", "rot", "half", "weights")]
        params = params if rdf else params[:3]
        u, w, g = fused_field.scene_eval_with_grad(
            c["pos"], *params[:3], c["valid"], params[3] if rdf else None, c["tau"],
            group_mask=frame_of(mask, f), mask_tile=fk.MASK_TILE)
        loss = (u * c["du"]).sum() + (w * c["dw"]).sum() + (g * c["dg"]).sum()
        return (u.detach(), w.detach(), g.detach()), loss, params

    x = skip_inputs(199, n, batched, 10 + n)
    x3 = skip_inputs(99, n, batched, 20 + n)
    mask = fk.group_mask_for(x["pos"], x["loc"], x["half"], x["valid"], x["tau"])
    mask3 = fk.group_mask_for(x3["pos"], x3["loc"], x3["half"], x3["valid"], x3["tau"])
    kept, kept3 = float(mask.float().mean()), float(mask3.float().mean())
    for rdf in (False, True):
        mode = "rdf" if rdf else "box"
        weights = x["weights"] if rdf else None
        fwd_args = (x["pos"], x["loc"], x["rot"], x["half"], x["valid"], weights, x["tau"])
        params = [x[k].clone().requires_grad_() for k in ("loc", "rot", "half", "weights")]
        params = params if rdf else params[:3]
        u, w, g = fk.fused_field_with_grad(x["pos"], *params[:3], x["valid"],
                                           params[3] if rdf else None, x["tau"],
                                           group_mask=mask)
        grads = torch.autograd.grad(
            (u * x["du"]).sum() + (w * x["dw"]).sum() + (g * x["dg"]).sum(), params)
        outs = (u.detach(), w.detach(), g.detach())
        del u, w, g, params
        fwd_abs = bwd_abs = 0.0
        for f in range(frames):
            outs_t, loss_t, params_t = twin_graph(x, f, arbiter, mask, rdf)
            grads_t = torch.autograd.grad(loss_t, params_t)
            del loss_t, params_t
            for name, a, b in zip(("u", "w", "grad"), outs, outs_t):
                key = f"{names[0]}_{mode}_skip{n}_{name}"
                errors[key] = max(errors.get(key, 0.0), err(frame_of(a, f).to(arbiter), b))
                fwd_abs = max(fwd_abs, float((frame_of(a, f).to(arbiter) - b).abs().max()))
            for name, a, b in zip(("dloc", "drot", "dhalf", "dweights"), grads, grads_t):
                key = f"{names[1]}_{mode}_skip{n}_{name}"
                errors[key] = max(errors.get(key, 0.0), err(frame_of(a, f).to(arbiter), b))
                bwd_abs = max(bwd_abs, float((frame_of(a, f).to(arbiter) - b).abs().max()))
            del outs_t, grads_t
        del outs, grads
        torch.cuda.synchronize()
        cot = (x["du"], x["dw"], x["dg"])
        fwd = lambda m=mask: fk.field_forward(*fwd_args, group_mask=m)  # noqa: E731
        bwd = lambda m=mask: fk.field_backward(*fwd_args, *cot, group_mask=m)  # noqa: E731

        def twin_fwd():
            with torch.no_grad():
                for f in range(frames):
                    fused_field.scene_eval_with_grad(
                        *(frame_of(t, f) if t is not None and t.ndim else t for t in fwd_args),
                        group_mask=frame_of(mask, f), mask_tile=fk.MASK_TILE)

        def twin_bwd():
            for f in range(frames):
                _, loss_t, params_t = twin_graph(x, f, torch.float32, mask, rdf)
                torch.autograd.grad(loss_t, params_t)

        pairs = kept_pairs(x, mask)
        for name, kind, run, plain, abs_err in ((names[0], "K1", fwd, twin_fwd, fwd_abs),
                                                (names[1], "K2", bwd, twin_bwd, bwd_abs)):
            unmasked_ev, masked_ev = in_turns(lambda: run(None), run)
            report[f"{name}_{mode}_skip{n}"] = dict(
                frames=frames, instances=n, kept=kept, max_abs_err=abs_err,
                max_rel_err=max(v for k, v in errors.items()
                                if k.startswith(f"{name}_{mode}_skip{n}_")),
                ms=median_ms(run), event_ms=masked_ev,
                unmasked_ms=median_ms(lambda: run(None)), unmasked_event_ms=unmasked_ev,
                plain_ms=median_ms(plain, 3), bound=kernel_bound(kind, rdf, x, pairs))
        if rdf and not batched:
            # the tiles in turns (128, 256, 256, 128); MASK_TILE is read at each launch
            tiles = {tile: dict(K1=0.0, K2=0.0, K3=0.0) for tile in SKIP_TILES}
            dir_args3 = (x3["pos"], x3["dirs"], x3["loc"], x3["rot"], x3["half"], x3["valid"],
                         x3["weights"], x3["tau"])
            for tile in (*SKIP_TILES, *SKIP_TILES[::-1]):
                fk.MASK_TILE = tile
                m = fk.group_mask_for(x["pos"], x["loc"], x["half"], x["valid"], x["tau"])
                m3 = fk.group_mask_for(x3["pos"], x3["loc"], x3["half"], x3["valid"], x3["tau"])
                t = tiles[tile]
                t["kept"] = float(m.float().mean())
                t["K1"] += event_ms(lambda: fwd(m)) / 2
                t["K2"] += event_ms(lambda: bwd(m)) / 2
                t["K3"] += event_ms(lambda: fk.field_dir_forward(*dir_args3, group_mask=m3)) / 2
            fk.MASK_TILE = SKIP_TILES[0]
            report[f"{names[0]}_{mode}_skip{n}"]["tiles"] = tiles
            # what the skip saves where the mask can drop most groups
            c = clustered_field_inputs(199_000, n, 30 + n)
            m = fk.group_mask_for(c["pos"], c["loc"], c["half"], c["valid"], c["tau"])
            c_args = (c["pos"], c["loc"], c["rot"], c["half"], c["valid"], c["weights"], c["tau"])
            c_dir = (c["pos"], c["dirs"], *c_args[1:])
            clustered = dict(kept=float(m.float().mean()))
            for k, fn, a in (("K1", fk.field_forward, c_args),
                             ("K2", lambda *a, group_mask: fk.field_backward(
                                 *a, c["du"], c["dw"], c["dg"], group_mask=group_mask), c_args),
                             ("K3", fk.field_dir_forward, c_dir)):
                clustered[f"{k} unmasked"], clustered[k] = in_turns(
                    lambda: fn(*a, group_mask=None), lambda: fn(*a, group_mask=m))
            report[f"{names[0]}_{mode}_skip{n}"]["clustered"] = clustered
            del c

        # K3 (K4b) at the coarse pass's P, with its own mask
        w3 = x3["weights"] if rdf else None
        dir_args = (x3["pos"], x3["dirs"], x3["loc"], x3["rot"], x3["half"], x3["valid"], w3,
                    x3["tau"])
        outs = fk.fused_field_dir_forward(*dir_args, group_mask=mask3)
        dir_abs = 0.0
        for f in range(frames):
            outs_t = fused_field.scene_eval_dir(
                *(frame_of(t, f).to(arbiter) for t in dir_args[:6]),
                None if w3 is None else frame_of(w3, f).to(arbiter), x3["tau"].to(arbiter),
                group_mask=frame_of(mask3, f), mask_tile=fk.MASK_TILE)
            for name, a, b in zip(("u", "w", "u_dot"), outs, outs_t):
                key = f"{names[2]}_{mode}_skip{n}_{name}"
                errors[key] = max(errors.get(key, 0.0), err(frame_of(a, f).to(arbiter), b))
                dir_abs = max(dir_abs, float((frame_of(a, f).to(arbiter) - b).abs().max()))
        del outs
        dirf = lambda m=mask3: fk.field_dir_forward(*dir_args, group_mask=m)  # noqa: E731
        twin_dir = (fused_field.scene_eval_dir_batched if batched
                    else fused_field.scene_eval_dir)
        unmasked_ev, masked_ev = in_turns(lambda: dirf(None), dirf)
        report[f"{names[2]}_{mode}_skip{n}"] = dict(
            frames=frames, instances=n, kept=kept3, max_abs_err=dir_abs,
            max_rel_err=max(v for k, v in errors.items()
                            if k.startswith(f"{names[2]}_{mode}_skip{n}_")),
            ms=median_ms(dirf), event_ms=masked_ev, unmasked_ms=median_ms(lambda: dirf(None)),
            unmasked_event_ms=unmasked_ev,
            plain_ms=median_ms(lambda: twin_dir(*dir_args, group_mask=mask3,
                                                mask_tile=fk.MASK_TILE), 3),
            bound=kernel_bound("K3", rdf, x3, kept_pairs(x3, mask3)))
    del x, x3


def skip_slice_phase(card: str, cfg) -> dict:
    """Phase 14b: the slice at full width with 24 instances (kitti layout)
    with ``kernel_group_skip`` off, then on (40 steps, 20 warmup; every
    field launch masked), each then its median ms/step per phase; with the
    skip on also at every tile of SKIP_TILES, in turns; then FRAMES stacked
    frames of 16 instances with the skip on, the same checks, and their
    ms/step off and on in turns. Returns the launches and the times."""
    import torch

    from vsrd_tpu_torch.pipeline import sharded
    from vsrd_tpu_torch.rendering import field_kernels as fk

    record = []
    mask_for = fk.group_mask_for

    def recording(*args):
        mask = mask_for(*args)
        record.append((mask.sum(), mask.numel()))
        return mask

    def kept_share() -> float:
        share = float(sum(s for s, _ in record)) / sum(c for _, c in record)
        record.clear()
        return share

    result = {}
    fk.group_mask_for = recording
    try:
        frame = synthetic_frames([0], "cuda", num_instances=SKIP_SLICE_N,
                                 max_instances=SKIP_SLICE_N, layout="kitti")[0]
        for skip in (False, True):
            run_cfg = dataclasses.replace(cfg, kernel_group_skip=skip)
            label = f"skip slice N={SKIP_SLICE_N}, skip {'on' if skip else 'off'}"
            params, counts, rdf = run_path(label, frame, run_cfg, batched=False)
            result[f"slice {'on' if skip else 'off'}"] = (counts, rdf)
            if skip:
                result["slice kept"] = kept_share()
                print(f"[skip] {label}: kept share of (group, tile) pairs "
                      f"{result['slice kept']:.4f} (tile {fk.MASK_TILE})", flush=True)
        # the two modes and the tiles in turns on the last params
        off_cfg = dataclasses.replace(cfg, kernel_group_skip=False)
        on_cfg = dataclasses.replace(cfg, kernel_group_skip=True)
        times = {"off": [], **{t: [] for t in SKIP_TILES}}
        kept = {t: [] for t in SKIP_TILES}
        for _ in range(2):
            times["off"].append(step_times(frame, params, off_cfg))
            for tile in SKIP_TILES:
                fk.MASK_TILE = tile
                record.clear()
                times[tile].append(step_times(frame, params, on_cfg))
                kept[tile].append(kept_share())
            fk.MASK_TILE = SKIP_TILES[0]
        result["slice ms"] = {k: {ph: statistics.median(t[ph] for t in v)
                                  for ph in ("warmup", "rdf")} for k, v in times.items()}
        result["slice kept by tile"] = {t: statistics.mean(v) for t, v in kept.items()}
        for key, ms in result["slice ms"].items():
            what = "skip off" if key == "off" else f"skip on, tile {key}"
            extra = ("" if key == "off"
                     else f", kept share {result['slice kept by tile'][key]:.4f}")
            print(f"[skip] slice N={SKIP_SLICE_N} {what}: median ms/step warmup "
                  f"{ms['warmup']:.2f}, residual {ms['rdf']:.2f}{extra} on {card}", flush=True)
        del frame, params
        torch.cuda.empty_cache()

        batch = sharded.stack_frames(synthetic_frames(
            list(range(FRAMES)), "cuda", num_instances=SKIP_BATCH_N, max_instances=SKIP_BATCH_N,
            layout="kitti"))
        label = f"batched skip slice F={FRAMES} N={SKIP_BATCH_N}, skip on"
        record.clear()
        params, counts, rdf = run_path(label, batch, on_cfg, batched=True)
        result["batched on"] = (counts, rdf)
        result["batched kept"] = kept_share()
        times = {"off": [], "on": []}
        for _ in range(2):
            times["off"].append(step_times(batch, params, off_cfg))
            times["on"].append(step_times(batch, params, on_cfg))
        record.clear()
        result["batched ms"] = {k: {ph: statistics.median(t[ph] for t in v)
                                    for ph in ("warmup", "rdf")} for k, v in times.items()}
        for key, ms in result["batched ms"].items():
            print(f"[skip] {label.split(',')[0]} skip {key}: median ms/step warmup "
                  f"{ms['warmup']:.2f}, residual {ms['rdf']:.2f} "
                  f"({ms['rdf'] / FRAMES:.2f} per frame-step); kept share with the skip "
                  f"{result['batched kept']:.4f} on {card}", flush=True)
        del batch, params
    finally:
        fk.group_mask_for = mask_for
        fk.MASK_TILE = SKIP_TILES[0]
    torch.cuda.empty_cache()
    return result


def skip_phase(card: str, cfg) -> dict:
    """Phase 14 (see the module docstring)."""
    import torch

    start = time.perf_counter()
    report, errors = {}, {}
    for n in SKIP_KERNEL_N:
        for batched in (False, True):
            skip_kernel_phase(n, batched, report, errors)
            torch.cuda.empty_cache()
    for name, value in sorted(errors.items()):
        print(f"[skip] {name}: rel err {value:.3e}", flush=True)
    for name, entry in sorted(report.items()):
        print(f"[skip] {name} (F={entry['frames']}, kept share {entry['kept']:.4f}): "
              f"{entry['ms']:.3f} ms host, {entry['event_ms']:.3f} ms events; without the "
              f"mask {entry['unmasked_ms']:.3f} ms host, {entry['unmasked_event_ms']:.3f} ms "
              f"events (plain {entry['plain_ms']:.3f} ms; bound {entry['bound'][0]:.4f} ms by "
              f"{entry['bound'][1]}) on {card}", flush=True)
        for tile, t in entry.get("tiles", {}).items():
            print(f"[skip] {name} mask tile {tile}: kept share {t['kept']:.4f}, events "
                  f"K1 {t['K1']:.3f} ms, K2 {t['K2']:.3f} ms, K3 (residual) {t['K3']:.3f} ms "
                  f"on {card}", flush=True)
        if "clustered" in entry:
            c = entry["clustered"]
            print(f"[skip] clustered scene N={entry['instances']} P=199,000 (residual): kept "
                  f"share {c['kept']:.4f}, events masked / unmasked: K1 {c['K1']:.3f} / "
                  f"{c['K1 unmasked']:.3f} ms, K2 {c['K2']:.3f} / {c['K2 unmasked']:.3f} ms, "
                  f"K3 {c['K3']:.3f} / {c['K3 unmasked']:.3f} ms on {card}", flush=True)
    bad = {k: v for k, v in errors.items() if not v <= TOLERANCE}
    if bad:
        fail(f"masked kernels disagree with their masked twins beyond {TOLERANCE}: {bad}")
    slices = skip_slice_phase(card, cfg)
    print(f"[time] skip phase: {time.perf_counter() - start:.1f} s", flush=True)
    return {"report": report, "slices": slices}


# ---- phase 15: the dp x sp sharded step, and the library on the card ----
SHARDED_DP, SHARDED_SP = 2, 2
SHARDED_FRAMES = 4                # two stacked frames per dp rank
SHARDED_WARMUP = 2
SHARDED_PHASES = {"warmup": 1, "residual": SHARDED_WARMUP + 1}   # the compared steps
SHARDED_TIMED = 6                 # timed steps per phase, the first dropped
SHARDED_SEED = 7
SHARDED_DEADLINE = 300.0          # s for a child's rendezvous, frames and first step
# sharded against single-process on the same stacked frames: per-frame
# scalars, relative; params after the step, over max(leaf scale, 1); the
# sp-averaged gradients relative to each leaf's own scale, which holds
# every leaf whatever its learning rate (the embeddings' 1e-3 and the
# hypernetwork's 1e-4 move their params by less than the params' bar).
# All are the same per-ray arithmetic; only the sums over rays (two
# partial sums and an all-reduce) and the weight-gradient sums of K4c (over
# 500 points per ray slice instead of 1000) take another order. A
# collective that does not carry the cotangent back gives half the
# ray-local terms' gradient, an error of order 1.
SHARDED_SCALAR_BAR = 1e-4
SHARDED_PARAM_BAR = 1e-4
SHARDED_GRAD_BAR = 1e-4
SHARDED_NAMES = ("loss", "silhouette_loss", "eikonal_loss", "iou_projection_loss",
                 "l1_projection_loss")


def sharded_cfg():
    from vsrd_tpu_torch.pipeline import optimize as opt

    return opt.OptimizationConfig(num_steps=40, warmup_steps=SHARDED_WARMUP, num_rays=1000,
                                  num_samples=100, deterministic=True, checkpoint_interval=40,
                                  metric_interval=40)


def _tree_to(tree, device):
    from vsrd_tpu_torch.pipeline import optimize as opt

    return opt.tree_map(lambda t: t.to(device).clone(), tree)


def _tree_slice(tree, frames):
    from vsrd_tpu_torch.pipeline import optimize as opt

    return opt.tree_map(lambda t: t[frames.start:frames.stop].clone(), tree)


def sharded_gradients(params, frames, step: int, cfg, rays, sp_group=None) -> list:
    """The step's gradients from ``params`` (averaged over ``sp_group``
    where given, as ``train_step`` averages them), on the host."""
    import torch

    from vsrd_tpu_torch.pipeline import optimize as opt

    leaves = [t.requires_grad_() for _, t in opt.tree_leaves(params)]
    total, _ = opt.compute_loss(params, frames, step, cfg, step >= cfg.warmup_steps,
                                ray_indices=rays, sp_group=sp_group)
    grads = torch.autograd.grad(total.sum(), leaves, allow_unused=True)
    for leaf in leaves:
        leaf.requires_grad_(False)
    if sp_group is not None:
        grads = opt.sp_mean_gradients(grads, sp_group)
    return [None if g is None else g.cpu() for g in grads]


def grad_err(got, want) -> float:
    """max |got - want| over max |want| of one leaf's gradient (0 where both
    are absent; 1 where only one is)."""
    if got is None or want is None:
        return 0.0 if got is None and want is None else 1.0
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / scale if scale > 0 else float(got.abs().max())


def sharded_child(rank: int, port: int, workdir: str) -> None:
    """One process of the dp x sp world on the shared card (started by
    ``sharded_phase`` as ``chip_smoke.py --sharded-child RANK PORT DIR``):
    its two frames, the parent's states, the sp-averaged gradients and one
    sharded step of each phase from them, then the timed steps; writes
    ``rank<R>.pt``."""
    import torch
    import torch.distributed as dist

    from vsrd_tpu_torch.pipeline import optimize as opt, sharded
    from vsrd_tpu_torch.rendering import field_kernels as fk
    from vsrd_tpu_torch.utils.watchdog import deadline

    torch.cuda.set_device(0)
    cfg = sharded_cfg()
    out = {}
    launchers = {"K4a": fk.field_forward, "K4c": fk.field_backward, "K4b": fk.field_dir_forward}

    def state_of(phase):
        state = data["states"][phase]
        params = _tree_to(_tree_slice(state["params"], local), "cuda")
        opt_state = {k: _tree_to(_tree_slice(state[k], local), "cuda") for k in ("mu", "nu")}
        opt_state["count"] = state["count"]
        return params, opt_state

    with deadline(SHARDED_DEADLINE, f"sharded rank {rank}"):
        fk.build_library()        # built by the parent: this loads it
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=SHARDED_DP * SHARDED_SP, rank=rank)
        groups = sharded.make_groups(SHARDED_DP, SHARDED_SP)
        local = groups.frame_range(SHARDED_FRAMES)
        frames = sharded.stack_frames(synthetic_frames(list(local), "cuda"))
        states_path = os.path.join(workdir, "states.pt")
        while not os.path.exists(states_path):
            time.sleep(0.2)
        data = torch.load(states_path)
        rays = data["schedule"][local.start:local.stop].cuda()
        step_fn = sharded.make_sharded_train_step(groups, cfg)
        for phase, step in SHARDED_PHASES.items():
            out[f"grads {phase}"] = sharded_gradients(state_of(phase)[0], frames, step, cfg,
                                                      rays, groups.sp_group)
        fk.reset_launch_counts()
        for phase, step in SHARDED_PHASES.items():
            params, opt_state = state_of(phase)
            scalars = step_fn(params, opt_state, frames, step, SHARDED_SEED, ray_indices=rays)
            out[f"scalars {phase}"] = {k: scalars[k].cpu() for k in SHARDED_NAMES}
            out[f"params {phase}"] = _tree_to(params, "cpu")
        out["launches"] = {name: (fn.batched_launches, fn.rdf_launches)
                           for name, fn in launchers.items()}
        times = {}
        for phase, step in SHARDED_PHASES.items():
            params, opt_state = state_of(phase)
            samples = []
            for _ in range(SHARDED_TIMED):
                dist.barrier()
                start = time.perf_counter()
                step_fn(params, opt_state, frames, step, SHARDED_SEED,
                        ray_indices=rays)["loss"].cpu()
                samples.append((time.perf_counter() - start) * 1e3)
            times[phase] = statistics.median(samples[1:])
        out["launches all"] = {name: (fn.batched_launches, fn.rdf_launches)
                               for name, fn in launchers.items()}
        out["times"] = times
        out["layout"] = (groups.dp_index, groups.sp_index,
                         dist.get_process_group_ranks(groups.sp_group))
        torch.save(out, os.path.join(workdir, f"rank{rank}.tmp"))
        os.replace(os.path.join(workdir, f"rank{rank}.tmp"),
                   os.path.join(workdir, f"rank{rank}.pt"))
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sharded_phase(card: str) -> dict:
    """Phase 15(a): the dp=2 x sp=2 sharded step at full width, four gloo
    processes on this one card, against the single-process batched step
    (see the module docstring). Returns each rank's launches and the
    timings."""
    import numpy as np
    import torch

    from vsrd_tpu_torch.pipeline import optimize as opt, sharded

    cfg = sharded_cfg()
    world = SHARDED_DP * SHARDED_SP
    workdir = tempfile.mkdtemp(prefix="vsrd_sharded_")
    port = _free_port()
    # the children start first: their CUDA start-up and frame builds
    # overlap the parent's frames and pre-run steps
    logs = [open(os.path.join(workdir, f"rank{rank}.log"), "w") for rank in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sharded-child",
                               str(rank), str(port), workdir], stdout=log, stderr=log)
             for rank, log in enumerate(logs)]
    try:
        frames = synthetic_frames(list(range(SHARDED_FRAMES)), "cuda")
        rng = np.random.default_rng(SHARDED_SEED)
        schedule = torch.stack([f.candidate_indices[torch.from_numpy(rng.choice(
            f.candidate_indices.shape[0], cfg.num_rays, replace=False)).cuda()] for f in frames])
        batch = sharded.stack_frames(frames)
        # pre-run single-process steps 0..2 on all four frames: the compared
        # steps start from distinct boxes (no step-0 tie), in each phase
        optimizer = opt.Adam(cfg)
        params = opt.init_params_batched(SHARDED_SEED, SHARDED_FRAMES, 8, cfg, device="cuda")
        opt_state = optimizer.init(params)
        snapshots = {}
        for step in range(max(SHARDED_PHASES.values())):
            opt.train_step(params, opt_state, batch, step, cfg, optimizer, ray_indices=schedule)
            for phase, at in SHARDED_PHASES.items():
                if at == step + 1:
                    snapshots[phase] = {"params": _tree_to(params, "cpu"),
                                        "mu": _tree_to(opt_state["mu"], "cpu"),
                                        "nu": _tree_to(opt_state["nu"], "cpu"),
                                        "count": opt_state["count"]}
        torch.save({"schedule": schedule.cpu(), "states": snapshots},
                   os.path.join(workdir, "states.tmp"))
        os.replace(os.path.join(workdir, "states.tmp"), os.path.join(workdir, "states.pt"))
        # the single-process reference: each dp rank's two frames stacked
        reference = {}
        for index in range(SHARDED_DP):
            local = range(index * 2, index * 2 + 2)
            sub = sharded.stack_frames(frames[local.start:local.stop])
            for phase, step in SHARDED_PHASES.items():
                state = snapshots[phase]
                p = _tree_to(_tree_slice(state["params"], local), "cuda")
                s = {k: _tree_to(_tree_slice(state[k], local), "cuda") for k in ("mu", "nu")}
                s["count"] = state["count"]
                rays = schedule[local.start:local.stop]
                grads = sharded_gradients(p, sub, step, cfg, rays)
                scalars = opt.train_step(p, s, sub, step, cfg, optimizer, ray_indices=rays)
                reference[index, phase] = ({k: scalars[k].cpu() for k in SHARDED_NAMES},
                                           _tree_to(p, "cpu"), grads)
        # a child that fails or hangs (cut by its deadline, exit 124) fails
        # the phase at once; the others are killed below
        while any(proc.poll() is None for proc in procs):
            if any(proc.poll() not in (None, 0) for proc in procs):
                break
            time.sleep(0.2)
        for rank, (proc, log) in enumerate(zip(procs, logs)):
            log.close()
            if proc.poll() not in (None, 0):
                with open(os.path.join(workdir, f"rank{rank}.log")) as f:
                    for line in f.read().splitlines()[-30:]:
                        print(f"[sharded] rank {rank}: {line}", flush=True)
                fail(f"sharded rank {rank} exited with {proc.returncode}")
        outputs = [torch.load(os.path.join(workdir, f"rank{rank}.pt")) for rank in range(world)]
        # the single-process step's time on all four frames, in each phase
        single_ms = {}
        for phase, step in SHARDED_PHASES.items():
            state = snapshots[phase]
            p = _tree_to(state["params"], "cuda")
            s = {k: _tree_to(state[k], "cuda") for k in ("mu", "nu")}
            s["count"] = state["count"]
            samples = []
            for _ in range(SHARDED_TIMED):
                start = time.perf_counter()
                opt.train_step(p, s, batch, step, cfg, optimizer,
                               ray_indices=schedule)["loss"].cpu()
                samples.append((time.perf_counter() - start) * 1e3)
            single_ms[phase] = statistics.median(samples[1:])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(workdir, ignore_errors=True)

    worst = {"scalars": 0.0, "params": 0.0, "grads": 0.0}
    for rank, out in enumerate(outputs):
        dp_index, sp_index, members = out["layout"]
        if (dp_index, sp_index) != (rank // SHARDED_SP, rank % SHARDED_SP) or members != [
                dp_index * SHARDED_SP + i for i in range(SHARDED_SP)]:
            fail(f"sharded rank {rank}: layout {out['layout']}")
        for phase in SHARDED_PHASES:
            want_scalars, want_params, want_grads = reference[dp_index, phase]
            rels = {}
            for name in SHARDED_NAMES:
                got, want = out[f"scalars {phase}"][name], want_scalars[name]
                if not torch.isfinite(got).all():
                    fail(f"sharded rank {rank} {phase}: non-finite {name} {got.tolist()}")
                rels[name] = float(((got - want).abs() / want.abs().clamp(min=1e-6)).max())
            want_leaves = dict(opt.tree_leaves(want_params))
            param_rel = max(err(value, want_leaves[path])
                            for path, value in opt.tree_leaves(out[f"params {phase}"]))
            grad_rel = max(grad_err(got, want)
                           for got, want in zip(out[f"grads {phase}"], want_grads))
            worst["scalars"] = max(worst["scalars"], *rels.values())
            worst["params"] = max(worst["params"], param_rel)
            worst["grads"] = max(worst["grads"], grad_rel)
            print(f"[sharded] rank {rank} {phase}: loss {out[f'scalars {phase}']['loss'].tolist()}"
                  f" (single process {want_scalars['loss'].tolist()}); rel err of the scalars "
                  f"{max(rels.values()):.3e} (worst {max(rels, key=rels.get)}), of the params "
                  f"{param_rel:.3e}, of the sp-averaged gradients {grad_rel:.3e}", flush=True)
            if sp_index:
                # the sp ranks of a group take the same update, bit for bit
                for (path, a), (_, b) in zip(opt.tree_leaves(out[f"params {phase}"]),
                                             opt.tree_leaves(outputs[rank - 1][f"params {phase}"])):
                    if not torch.equal(a, b):
                        fail(f"sharded ranks {rank - 1} and {rank} {phase}: params {path} differ")
        for name, (launched, rdf) in out["launches"].items():
            if (launched, rdf) != (2, 0 if name == "K4b" else 1):
                fail(f"sharded rank {rank}: {name} launched {launched} times ({rdf} with the "
                     f"residual field) in the two compared steps (expected 2, "
                     f"{0 if name == 'K4b' else 1})")
    print(f"[sharded] worst rel err against the single-process step: scalars "
          f"{worst['scalars']:.3e} (bar {SHARDED_SCALAR_BAR}), params {worst['params']:.3e} "
          f"(bar {SHARDED_PARAM_BAR}), gradients {worst['grads']:.3e} (bar {SHARDED_GRAD_BAR})",
          flush=True)
    if not (worst["scalars"] <= SHARDED_SCALAR_BAR and worst["params"] <= SHARDED_PARAM_BAR
            and worst["grads"] <= SHARDED_GRAD_BAR):
        fail(f"the sharded step disagrees with the single-process step: {worst}")
    times = {phase: [out["times"][phase] for out in outputs] for phase in SHARDED_PHASES}
    for phase in SHARDED_PHASES:
        print(f"[sharded] {phase}: median ms/step dp={SHARDED_DP} x sp={SHARDED_SP} (4 gloo "
              f"processes sharing one card, 2 frames x 500 rays each) "
              f"{[round(t, 2) for t in times[phase]]} by rank; single process, all "
              f"{SHARDED_FRAMES} frames x 1000 rays, {single_ms[phase]:.2f}; the ranks share "
              f"the card's SMs, so this is a record, not a scaling number; on {card}",
              flush=True)
    return {"launches": [out["launches all"] for out in outputs], "times": times,
            "single_ms": single_ms, "worst": worst}


# the library on the card against the port's own functions in float64 on
# the CPU: max |card - cpu64| over max(max |cpu64|, 1e-6). Warps sample at
# f32 pixel coordinates (about 2e-4 px at x = 1408), which moves a bilinear
# sample by that much of the features' local slope; the forward warp's
# normalized splat divides by each pixel's summed weight, so it is read
# away from the image's border (LIBRARY_CROP), where that sum can be
# small; a mean over 4.2M pixels or a 50-step Sinkhorn keeps ~1e-6; the
# blocks' convolutions run in f32 (TF32 off, as the port sets it) over sums
# of 27-18,432 products.
LIBRARY_BARS = {"PlaneSweepStereo": 1e-3, "SpatialPropagation2d": 1e-4,
                "forward_warping": 1e-3, "sinkhorn_knopp": 1e-4, "PackingBlock": 1e-4,
                "UnpackingBlock": 1e-4, "losses": 1e-4}
LIBRARY_REPEATS = 5
LIBRARY_CROP = {"forward_warping": 8}      # border pixels left out of the error


def library_cases():
    """name -> (function of (inputs, module), inputs on the CPU in float32,
    module factory or None): the shapes of phase 15(b)."""
    import numpy as np
    import torch

    from vsrd_tpu_torch import losses, modules
    from vsrd_tpu_torch.ops import warping

    rng = np.random.default_rng(15)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    k = np.asarray(KITTI_K, np.float32)[None]

    def camera(x, z):
        e = np.eye(4, dtype=np.float32)[None].copy()
        e[0, 0, 3], e[0, 2, 3] = x, z
        return t(e)

    # feature maps at a quarter of 376x1408 (pyramid level 2), smooth at a
    # few pixels as a network's are
    def smooth(shape):
        noise = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return torch.nn.functional.avg_pool2d(noise, 5, 1, 2) * 2.0

    views = [{"feature_maps": smooth((1, 32, 94, 352)), "intrinsic_matrices": t(k),
              "extrinsic_matrices": camera(x, z), "scale": 2}
             for x, z in ((0.0, 0.0), (-0.54, 0.0), (0.0, -1.0))]
    sweep = modules.PlaneSweepStereo(depth_range=(1.0, 100.0), num_hypotheses=64)
    # a smooth image and depth (a ground plane from 60 m at the top to 5 m
    # at the bottom, rippled): the forward warp is then one to one
    image = smooth((1, 3, 376, 1408)) * 0.1 + 0.5
    rows = np.linspace(0.0, 1.0, 376)[:, None]
    cols = np.linspace(0.0, 1.0, 1408)[None, :]
    depth = t((60.0 - 55.0 * rows + 2.0 * np.sin(6.0 * cols) * rows)[None, None])
    maps = t(rng.uniform(0.02, 0.98, size=(8, 1, 376, 1408)))
    targets = t(rng.uniform(0.0, 1.0, size=(8, 1, 376, 1408)))
    refs = t(rng.random((8, 3, 376, 1408)))

    def loss_sum(x):
        m, tg, r = x
        return torch.stack([
            losses.binary_cross_entropy(m, tg), losses.focal_loss(m, tg),
            losses.tversky_loss(m, tg), losses.smoothness_loss(m, r),
            losses.motion_smoothness_loss(m), losses.gaussian_nll(m, tg + 0.5, r[:, :1])])

    return {
        "PlaneSweepStereo": (lambda x, _: sweep(*x), views, None),
        "SpatialPropagation2d": (
            lambda x, _: modules.SpatialPropagation2d(3, 10)(*x),
            [t(rng.random((1, 1, 376, 1408))), t(rng.random((1, 1, 3, 3, 376, 1408)))], None),
        "forward_warping": (
            lambda x, _: warping.forward_warping(x[0], x[1], x[2], x[2], x[3], x[4]),
            [image, depth, t(k), camera(0.0, 0.0), camera(0.3, -1.0)], None),
        "sinkhorn_knopp": (lambda x, _: modules.sinkhorn_knopp(*x, gamma=0.1, num_steps=50),
                           [t(rng.random((50, 8400))), t(np.full(50, 168.0)),
                            t(np.ones(8400))], None),
        "PackingBlock": (lambda x, m: m(x[0]), [t(rng.normal(size=(1, 64, 188, 704)))],
                         lambda: modules.PackingBlock(64, 64)),
        "UnpackingBlock": (lambda x, m: m(x[0]), [t(rng.normal(size=(1, 64, 188, 704)))],
                           lambda: modules.UnpackingBlock(64, 64)),
        "losses": (lambda x, _: loss_sum(x), [maps, targets, refs], None),
    }


def _to(tree, device, dtype):
    import torch

    if isinstance(tree, dict):
        return {k: _to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device, dtype) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device, dtype)
    return tree


def library_phase(card: str) -> dict:
    """Phase 15(b): each library function on the card (f32) against the
    port's own function on the CPU in float64 on the same inputs, with its
    time on CUDA events."""
    import torch

    report = {}
    for name, (fn, inputs, make_module) in library_cases().items():
        torch.manual_seed(0)
        module = make_module() if make_module else None
        with torch.no_grad():
            if module is not None:
                for p in module.parameters():      # off the identity init
                    p.add_(torch.randn_like(p) * 0.05)
            cpu = fn(_to(inputs, "cpu", torch.float64),
                     module.to(torch.float64) if module is not None else None)
            card_inputs = _to(inputs, "cuda", torch.float32)
            card_module = module.to("cuda", torch.float32) if module is not None else None
            out = fn(card_inputs, card_module)
            torch.cuda.synchronize()
            crop = LIBRARY_CROP.get(name, 0)
            inner = (..., slice(crop, -crop or None), slice(crop, -crop or None))
            got, want = out.double().cpu(), cpu
            if crop:
                got, want = got[inner], want[inner]
            rel = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-6)
            ms = event_ms(lambda: fn(card_inputs, card_module), LIBRARY_REPEATS)
        if not torch.isfinite(out).all():
            fail(f"library {name}: non-finite output on the card")
        report[name] = {"shape": list(out.shape), "rel_err": rel, "event_ms": ms}
        print(f"[library] {name} {list(out.shape)}: rel err {rel:.3e} against float64 on the "
              f"CPU (bar {LIBRARY_BARS[name]}), {ms:.3f} ms events on {card}", flush=True)
        del card_inputs, card_module, out
        torch.cuda.empty_cache()
    bad = {k: v["rel_err"] for k, v in report.items() if not v["rel_err"] <= LIBRARY_BARS[k]}
    if bad:
        fail(f"the library on the card disagrees with float64 beyond its bars: {bad}")
    return report


def main():
    if sys.argv[1:2] == ["--sharded-child"]:
        sharded_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return
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
    jv = matching_phase(card)
    print(f"[time] through the kernel and matching phases: "
          f"{time.perf_counter() - script_start:.1f} s", flush=True)

    start = time.perf_counter()
    frames = synthetic_frames(list(range(FRAMES)), "cuda", with_images=True)
    torch.cuda.synchronize()
    print(f"[frames] {FRAMES} synthetic frames 17x376x1408, 8 instances: "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    cfg = opt.OptimizationConfig(num_steps=40, warmup_steps=20, num_rays=1000, num_samples=100,
                                 checkpoint_interval=20, metric_interval=20)

    # the coarse pass with the residual field (phase 7)
    coarse_cfg = dataclasses.replace(cfg, num_steps=20, warmup_steps=10, checkpoint_interval=10,
                                     metric_interval=10, kernel_box_coarse=False)

    trace = trace_phase(frames[0], card)
    photo_cfg = dataclasses.replace(cfg, photometric_weight=1.0)

    params, launches, _ = run_path("slice", frames[0], cfg, batched=False)
    single_ms = step_times(frames[0], params, cfg)
    # the detector phase draws its panels from these
    slice_params, slice_frame = params, frames[0]
    params, photo_launches, _ = run_path("photometric slice", frames[0], photo_cfg,
                                         batched=False)
    photo_ms = {"weight 0": step_times(frames[0], params, cfg)["rdf"],
                "weight 1": step_times(frames[0], params, photo_cfg)["rdf"]}
    renders = render_phase(params, frames[0], cfg, card)
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
    params, batched_photo, _ = run_path("batched photometric slice", batch, photo_cfg,
                                        batched=True)
    batch_photo_ms = {"weight 0": step_times(batch, params, cfg)["rdf"],
                      "weight 1": step_times(batch, params, photo_cfg)["rdf"]}
    for label, times, f in (("F=1", photo_ms, 1), (f"F={FRAMES}", batch_photo_ms, FRAMES)):
        print(f"[step] residual phase {label}: median ms/step photometric weight 0 "
              f"{times['weight 0']:.2f}, weight 1 {times['weight 1']:.2f} "
              f"(+{times['weight 1'] - times['weight 0']:.2f} ms/step, "
              f"{times['weight 1'] / f:.2f} per frame-step) on {card}", flush=True)
    del params
    _, _, batched_coarse = run_path("batched slice, residual coarse pass", batch, coarse_cfg,
                                    batched=True)
    coarse_launches.update(batched_coarse)
    del batch
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="vsrd_smoke_")
    try:
        drive = driver_phase(card, root)
        detector = detector_phase(card, root, drive["sampled"], slice_params, slice_frame, cfg)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    skip = skip_phase(card, cfg)
    start = time.perf_counter()
    sharded_run = sharded_phase(card)
    library = library_phase(card)
    print(f"[time] sharded and library phase: {time.perf_counter() - start:.1f} s", flush=True)

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
                # phase 15: each rank's launches, all with F=2, in the sharded run
                **({"sharded_launches": [r[name][0] for r in sharded_run["launches"]],
                    "sharded_rdf_launches": [r[name][1] for r in sharded_run["launches"]]}
                   if name in ("K4a", "K4c", "K4b") and mode == ("box" if coarse else "rdf")
                   else {}),
            })
    # the masked launches (phase 14): every launch of the skip slices took a
    # mask, so a mode's masked launches are its launches there (box-only: the
    # masked ones less those with the residual field)
    for name, (source, replaces) in sources.items():
        batched = name.startswith("K4")
        counts, rdf_counts = skip["slices"]["batched on" if batched else "slice on"]
        coarse = name in ("K3", "K4b")
        for mode in ("box",) if coarse else ("box", "rdf"):
            launched = (rdf_counts[name] if mode == "rdf"
                        else counts[f"{name} skip"] - rdf_counts[name])
            for n in SKIP_KERNEL_N:
                entry = skip["report"][f"{name}_{mode}_skip{n}"]
                kernels.append({
                    "name": f"{name} ({mode}, group skip, N={n})",
                    "route": "cuda",
                    "source": f"vsrd_tpu_torch/csrc/{source}",
                    "replaces": replaces,
                    "frames": entry["frames"],
                    "launches": launched,
                    "skip_launches": counts[f"{name} skip"],
                    "max_abs_err": entry["max_abs_err"],
                    "max_rel_err": entry["max_rel_err"],
                    "ms": entry["ms"],
                    "event_ms": entry["event_ms"],
                    "unmasked_ms": entry["unmasked_ms"],
                    "unmasked_event_ms": entry["unmasked_event_ms"],
                    "kept_share": entry["kept"],
                    "plain_ms": entry["plain_ms"],
                    "bound_ms": entry["bound"][0],
                    "bound_by": entry["bound"][1],
                    "library_ms": None,
                })
    kernels.append({
        "name": "JV (n=16)",
        "route": "cuda",
        "source": "vsrd_tpu_torch/csrc/matching.cu",
        "replaces": "vsrd_tpu/ops/matching.py:27",
        "frames": jv["frames"],
        "launches": drive["launches"]["JV"],
        "max_abs_err": jv["max_abs_err"],
        "max_rel_err": jv["max_abs_err"],
        "ms": jv["ms"],
        "event_ms": jv["event_ms"],
        "plain_ms": jv["plain_ms"],
        "bound_ms": jv["bound"][0],
        "bound_by": jv["bound"][1],
        "library_ms": None,
    })
    detr_jv = detector["jv"]
    kernels.append({
        "name": f"JV (n={DETR_QUERIES}, DETR loss)",
        "route": "cuda",
        "source": "vsrd_tpu_torch/csrc/matching.cu",
        "replaces": "vsrd_tpu/ops/matching.py:27",
        "frames": detr_jv["frames"],
        "launches": sum(run["launches"] for run in detector["runs"].values()),
        "max_abs_err": detr_jv["max_abs_err"],
        "max_rel_err": detr_jv["max_abs_err"],
        "ms": detr_jv["ms"],
        "event_ms": detr_jv["event_ms"],
        "plain_ms": detr_jv["plain_ms"],
        "bound_ms": detr_jv["bound"][0],
        "bound_by": detr_jv["bound"][1],
        "library_ms": None,
    })
    # each entry's launches: the counts of its mode in the run of its shape,
    # the photometric slices (R = 100) and render_surface_mask (one view)
    trace_launches = {1: photo_launches["sphere_trace modes"],
                      FRAMES: batched_photo["sphere_trace modes"],
                      "view": renders.pop("sphere_trace")}
    for key, entry in trace.items():
        if key[0] == "view":
            mode = f"{'rdf' if key[1] else 'box'} {key[2]}"
            name, launched = f"sphere_trace ({mode}, view)", trace_launches["view"][mode]
        else:
            frames_n, rdf = key
            mode = f"{'rdf' if rdf else 'box'} hard"
            name = f"sphere_trace ({mode}, R=100, F={frames_n})"
            launched = trace_launches[frames_n][mode]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "vsrd_tpu_torch/csrc/sphere_trace.cu",
            "replaces": "vsrd_tpu/rendering/renderer.py:355",
            "frames": entry["frames"],
            "launches": launched,
            "max_abs_err": entry["max_abs_err"],
            "max_rel_err": entry["max_abs_err"] / TRACE_RADIUS,
            "ms": entry["ms"],
            "event_ms": entry["event_ms"],
            "plain_ms": entry["plain_ms"],
            "bound_ms": entry["bound"][0],
            "bound_by": entry["bound"][1],
            "library_ms": None,
            "near_criterion": entry["near_criterion"],
        })
    print(f"[render] {json.dumps(renders)}", flush=True)
    print(f"[library] {json.dumps(library)}", flush=True)
    if not all(math.isfinite(k["ms"]) and math.isfinite(k["event_ms"]) for k in kernels):
        fail("a kernel time is not finite")
    print(f"[time] whole run: {time.perf_counter() - script_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
