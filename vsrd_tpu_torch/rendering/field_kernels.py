"""The scene-field kernels K1-K4c: hand-written CUDA for Hopper, their
wrappers, launch counters and the autograd binding.

Counterpart of ``vsrd_tpu/rendering/pallas_field.py``:

* K1 ``field_forward``: u [P], w [P, N] and grad_x u [P, 3] of the union
  SDF (``csrc/fused_forward.cu``; TPU ``_fwd_kernel`` with ``rev_grad``),
  grad_x u from one reverse sweep per instance with the layer products on
  the tensor cores;
* K2 ``field_backward``: the cotangents of K1's inputs from those of its
  outputs (``csrc/fused_backward.cu``; TPU ``_bwd_kernel_manual``). One
  call launches three CUDA kernels: the union's cotangents per point, the
  per-instance reverse sweep with its weight-gradient sums on the tensor
  cores, and the ordered reduction of the CTAs' partial rows;
* K3 ``field_dir_forward``: u, w and the derivative of u along a
  per-point direction, forward only (``csrc/dir_forward.cu``; TPU
  ``_dir_fwd_kernel``), the value and its tangent as two column blocks of
  one set of layer products on the tensor cores;
* ``sphere_trace``: the gradient-stopped march of sphere tracing through
  the hard (or softmin) union of a scene, for F frames of R rays in one
  call (``csrc/sphere_trace.cu``; the JAX package runs it as a
  ``lax.while_loop``, not a Pallas kernel), a group of lanes per ray, one
  per instance; its plain twin is ``renderer.march_loop``, which
  ``scene.march`` runs on CPU tensors.

Each launcher also takes F stacked frames: positions ``[F, P, 3]`` (and
directions and cotangents with the same leading axis) with ``[F, N, ...]``
boxes, validity and weights, and one scalar temperature. That is ONE
launch with a frame grid axis, whatever F is: K4a, K4c and K4b, the
counterparts of the TPU's ``_fused_forward_batched``,
``_fused_bwd_batched`` and ``_fused_dir_forward_batched``. Each frame's
outputs come from its own points and parameters only.

Per-tile instance-group skipping (the TPU kernels' ``group_skip`` mode,
``pallas_field.py:46-85``): K1, K2 and K3 (and K4a-c) take an optional keep
mask ``group_mask [(F,) G, ceil(P / MASK_TILE)]`` (int32 or bool, from
``group_mask_for``; G = ceil(N / 8), the last group may be partial). A
dropped (group, tile) pair reads the distance ``fused_field.SKIP_DISTANCE``
with a zero gradient, as the masked twins do: K1 and K3 skip the MLP of an
instance whose group every point of the CTA drops, and K2's second stage
skips each 128-point chunk whose tile drops the CTA's instance (its
cotangents there are exactly 0, from the first stage's masked union).
``MASK_TILE`` is a multiple of 128, so a chunk lies in one mask tile and a
warp's 32 points in one tile. ``<launcher>.skip_launches`` counts the
launches with a mask.

Precision (``precision``, the TPU kernels' ``matmul_precision``): at
``"default"`` every layer product of K1-K3 (and K4a-c) takes bf16 operands,
rounded to nearest even, with f32 sums, one ``mma.sync`` bf16 product
(``csrc/mma_bf16.cuh``), as the TPU's MXU computes an f32 dot at
``Precision.DEFAULT``: the weights with their biases, the activations, the
tangents, the backward's cotangents; K1 then seeds each instance's reverse
sweep with its union cotangent, in a second pass over the instances. At
``"highest"`` (every launcher's default, as ``FieldStatics.matmul_precision``
is the JAX package's; the optimizer passes its ``kernel_matmul_precision``)
the products run in 3xTF32 (f32 accuracy). Box-only launches
have no products and are the same in both modes. ``<launcher>.bf16_launches``
counts the launches with bf16 products (the default mode with the residual
field).

``fused_field_with_grad`` binds K1 to K2 through ``torch.autograd.Function``
and ``fused_field_dir_forward`` calls K3. On CPU tensors both take the
plain twins in ``fused_field`` (autograd and ``torch.func.jvp`` of the
eager field, looped over frames for a leading frame axis); on CUDA tensors
they launch the kernels or raise — there is no fallback. Each launcher
counts its launches in ``<launcher>.launches`` and, of those, the ones
with more than one frame (K4a/K4c/K4b) in ``<launcher>.batched_launches``
and the ones with the residual field in ``<launcher>.rdf_launches``;
``sphere_trace.soft_launches`` counts its launches with the softmin union.

The kernels are compiled on first use with ``nvcc`` for ``sm_90a`` from
``csrc/`` into a plain-C shared library, loaded with ctypes; the same
library holds the JV matching kernel (``csrc/matching.cu``), which
``ops/matching.py`` launches. It goes to
``$VSRD_TORCH_BUILD_DIR`` when that is set, else to ``build/`` at the
root of a source checkout, else to ``build/`` inside the installed
package. The field's widths are fixed by the kernels: 8 encoding
frequencies and a 48-16-16-16-16-1 MLP (1617 weights per instance).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch
from ..utils.spans import span

from . import fused_field

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
NUM_WEIGHTS = 1617
_GEO = 15
_PARAMS = NUM_WEIGHTS + _GEO

# points per tile of a group-skip mask (a multiple of 128; see above)
MASK_TILE = 128

_library = None
build_info: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    return str(candidate) if candidate.exists() else "nvcc"


def build_dir() -> Path:
    """Where the library is built (see the module docstring)."""
    if os.environ.get("VSRD_TORCH_BUILD_DIR"):
        return Path(os.environ["VSRD_TORCH_BUILD_DIR"])
    if (PACKAGE.parent / "pyproject.toml").exists():
        return PACKAGE.parent / "build"
    return PACKAGE / "build"


def build_library() -> ctypes.CDLL:
    """Compile ``csrc/*.cu`` for sm_90a (once per source content: one nvcc
    per source, in parallel, then a link) and load the library. Records the
    build time and ptxas's register and spill report in ``build_info``.

    nvcc writes to a name private to this process, which is then renamed
    onto the library's name, so a process that builds at the same time
    never loads a half-written file."""
    global _library
    if _library is not None:
        return _library
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"libvsrd_field_{digest.hexdigest()[:16]}.so"
    log_path = lib_path.with_suffix(".ptxas.txt")
    start = time.perf_counter()
    if not lib_path.exists():
        # one nvcc per source, all started together, then one link
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        objects = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
        procs = [subprocess.Popen(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-c", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objects)]
        logs = [proc.communicate()[0] for proc in procs]
        tmp_lib = lib_path.with_suffix(f".{os.getpid()}.tmp")
        tmp_log = log_path.with_suffix(f".{os.getpid()}.tmp")
        try:
            failed = [(src.name, proc.returncode, log)
                      for src, proc, log in zip(sources, procs, logs) if proc.returncode != 0]
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(
                    f"{name} ({code}):\n{log}" for name, code, log in failed))
            link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp_lib), *map(str, objects)],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                                   f"{link.stdout}{link.stderr}")
        finally:
            for obj in objects:
                obj.unlink(missing_ok=True)
        tmp_log.write_text("".join(logs))
        os.replace(tmp_log, log_path)
        os.replace(tmp_lib, lib_path)
    build_info.update(
        seconds=time.perf_counter() - start,
        library=str(lib_path),
        ptxas=log_path.read_text() if log_path.exists() else "",
    )
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vsrd_fused_forward.argtypes = [i32] * 5 + [ptr] * 7 + [f32, ptr, i32] + [ptr] * 4
    lib.vsrd_dir_forward.argtypes = [i32] * 5 + [ptr] * 8 + [f32, ptr, i32] + [ptr] * 4
    lib.vsrd_fused_backward.argtypes = ([i32] * 5 + [ptr] * 10 + [f32, ptr, i32, i32]
                                        + [ptr] * 5)
    lib.vsrd_fused_backward_tiles.argtypes = [i32]
    lib.vsrd_rev_forward_info.argtypes = [i32, i32, ptr, ptr, ptr]
    lib.vsrd_dir_forward_info.argtypes = [i32, i32, ptr, ptr, ptr]
    lib.vsrd_fused_backward_info.argtypes = [i32, i32, ptr]
    lib.vsrd_jv_assignment.argtypes = [i32, i32, ptr, ptr, ptr]   # ops/matching.py
    lib.vsrd_sphere_trace.argtypes = [i32] * 4 + [ptr] * 8 + [f32] * 4 + [ptr] * 7
    for fn in (lib.vsrd_fused_forward, lib.vsrd_dir_forward, lib.vsrd_fused_backward,
               lib.vsrd_fused_backward_tiles, lib.vsrd_rev_forward_info,
               lib.vsrd_dir_forward_info, lib.vsrd_fused_backward_info,
               lib.vsrd_jv_assignment, lib.vsrd_sphere_trace):
        fn.restype = i32
    _library = lib
    return lib


def _check(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what} failed with CUDA error {code}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _prepare(positions, locations, rotations, half_dims, valid, weights, temperature,
             extra=()):
    """Validate the CUDA launch inputs. Returns the leading frame shape
    (``()`` or ``(F,)``), the frame count, contiguous f32 views of
    ``positions``, ``extra``, locations, rotations, half_dims and valid,
    the weights' view (or ``None``) and the temperature as a 1-element
    tensor (``None`` for ``temperature=None``)."""
    device = positions.device
    if device.type != "cuda":
        raise ValueError(f"the field kernels run on CUDA tensors, not {device}")
    if positions.ndim not in (2, 3):
        raise ValueError("positions [P, 3] or [F, P, 3] expected")
    lead = tuple(positions.shape[:-2])
    frames = lead[0] if lead else 1
    p = positions.shape[-2]
    n = locations.shape[-2]
    tensors = [positions, *extra, locations, rotations, half_dims, valid]
    if weights is not None:
        tensors.append(weights)
    for t in tensors:
        if t.device != device or t.dtype != torch.float32:
            raise ValueError("field kernels take float32 tensors on one CUDA device")
    if positions.shape != (*lead, p, 3) or locations.shape != (*lead, n, 3):
        raise ValueError("positions [(F,) P, 3] and locations [(F,) N, 3] expected")
    if half_dims.shape != (*lead, n, 3) or rotations.shape != (*lead, n, 3, 3):
        raise ValueError("half_dims [(F,) N, 3] and rotations [(F,) N, 3, 3] expected")
    if valid.shape != (*lead, n):
        raise ValueError("valid [(F,) N] expected")
    if weights is not None and weights.shape != (*lead, n, NUM_WEIGHTS):
        raise ValueError(f"weights [(F,) N, {NUM_WEIGHTS}] expected (48-16-16-16-16-1 MLP)")
    if p == 0 or n == 0 or n > 64 or not 1 <= frames <= 65535:
        raise ValueError("the kernels take 1 <= N <= 64 instances, P >= 1 points "
                         "and 1 <= F <= 65535 frames")
    tau = None if temperature is None else torch.as_tensor(
        temperature, dtype=torch.float32, device=device).reshape(1)
    contig = [t.detach().contiguous() for t in (
        positions, *extra, locations, rotations, half_dims, valid)]
    w = None if weights is None else weights.detach().contiguous()
    return lead, frames, contig, w, tau


def _group_mask(group_mask, lead, p: int, n: int, device):
    """Validate a launch's keep mask: ``None``, or ``[(F,) G, ceil(P /
    MASK_TILE)]`` int32 or bool on the points' device. Returns it as
    contiguous int32 (or ``None``)."""
    if group_mask is None:
        return None
    if MASK_TILE <= 0 or MASK_TILE % 128:
        raise ValueError(f"MASK_TILE must be a positive multiple of 128, not {MASK_TILE}")
    shape = (*lead, fused_field.num_groups_of(n), -(-p // MASK_TILE))
    if group_mask.dtype not in (torch.int32, torch.bool) or group_mask.device != device:
        raise ValueError("group_mask is an int32 or bool tensor on the points' device")
    if tuple(group_mask.shape) != shape:
        raise ValueError(f"group_mask {shape} (frames, groups of 8, tiles of {MASK_TILE}) "
                         f"expected, not {tuple(group_mask.shape)}")
    return group_mask.to(torch.int32).contiguous()


def group_mask_for(positions, locations, half_dims, valid, temperature):
    """The keep mask of one field call at ``MASK_TILE``:
    ``fused_field.group_tile_mask`` with the threshold 2 + 12 tau, on the
    points' device, with no host synchronisation."""
    threshold = fused_field.group_skip_threshold(temperature)
    return fused_field.group_tile_mask(positions, locations, half_dims, valid, threshold,
                                       MASK_TILE)


def _count(launcher, frames: int, rdf: bool, masked: bool = False, bf16: bool = False):
    launcher.launches += 1
    if frames > 1:
        launcher.batched_launches += 1
    if rdf:
        launcher.rdf_launches += 1
    if masked:
        launcher.skip_launches += 1
    if rdf and bf16:
        launcher.bf16_launches += 1


def field_forward(positions, locations, rotations, half_dims, valid, weights,
                  temperature, position_scale: float = 100.0, group_mask=None,
                  precision: str = "highest"):
    """Launch K1 (K4a for F > 1 frames): ``(u [(F,) P], w [(F,) P, N],
    grad_x u [(F,) P, 3])``. ``weights`` ``[(F,) N, 1617]`` or ``None``
    (box only); ``valid`` float ``[(F,) N]``; ``group_mask`` the optional
    keep mask of the skip mode; ``precision`` "default" or "highest"."""
    bf16 = fused_field.check_precision(precision)
    lead, frames, (pos, loc, rot, half, val), w, tau = _prepare(
        positions, locations, rotations, half_dims, valid, weights, temperature)
    p, n = pos.shape[-2], loc.shape[-2]
    mask = _group_mask(group_mask, lead, p, n, pos.device)
    lib = build_library()
    u = torch.empty(*lead, p, device=pos.device)
    wts = torch.empty(*lead, p, n, device=pos.device)
    grad = torch.empty(*lead, p, 3, device=pos.device)
    _check(lib.vsrd_fused_forward(
        frames, p, n, int(w is not None), int(bf16), _ptr(pos), _ptr(loc), _ptr(rot),
        _ptr(half), _ptr(val), _ptr(w), _ptr(tau), float(position_scale), _ptr(mask), MASK_TILE,
        _ptr(u), _ptr(wts), _ptr(grad), _stream()), "K1/K4a fused_forward")
    _count(field_forward, frames, w is not None, mask is not None, bf16)
    return u, wts, grad


def field_backward(positions, locations, rotations, half_dims, valid, weights,
                   temperature, du, dw, dg, position_scale: float = 100.0, group_mask=None,
                   precision: str = "highest"):
    """Launch K2 (K4c for F > 1 frames): the cotangents ``(dloc [(F,) N,
    3], drot [(F,) N, 3, 3], dhalf [(F,) N, 3], dweights [(F,) N, 1617] or
    None)`` of K1's inputs from those of its outputs ``du [(F,) P]``,
    ``dw [(F,) P, N]``, ``dg [(F,) P, 3]``. Frame f's cotangents come from
    frame f's points only. ``group_mask``: the keep mask of K1's launch;
    ``precision``: K1's."""
    bf16 = fused_field.check_precision(precision)
    lead, frames, (pos, dg_c, du_c, dw_c, loc, rot, half, val), w, tau = _prepare(
        positions, locations, rotations, half_dims, valid, weights, temperature,
        extra=(dg, du, dw))
    p, n = pos.shape[-2], loc.shape[-2]
    if dg_c.shape != (*lead, p, 3) or du_c.shape != (*lead, p) or dw_c.shape != (*lead, p, n):
        raise ValueError("cotangents du [(F,) P], dw [(F,) P, N], dg [(F,) P, 3] expected")
    mask = _group_mask(group_mask, lead, p, n, pos.device)
    lib = build_library()
    rdf = int(w is not None)
    tiles = lib.vsrd_fused_backward_tiles(p)
    row = _PARAMS if rdf else _GEO
    # scratch: d_bar and td_bar [2, F, N, P], the CTAs' partial rows [F, N, tiles, row];
    # the kernels write every element before reading it
    cot = torch.empty(2, frames, n, p, device=pos.device)
    partial = torch.empty(frames, n, tiles, row, device=pos.device)
    out = torch.empty(*lead, n, row, device=pos.device)
    _check(lib.vsrd_fused_backward(
        frames, p, n, rdf, int(bf16), _ptr(pos), _ptr(dg_c), _ptr(du_c), _ptr(dw_c), _ptr(loc),
        _ptr(rot), _ptr(half), _ptr(val), _ptr(w), _ptr(tau), float(position_scale),
        _ptr(mask), MASK_TILE, tiles, _ptr(cot[0]), _ptr(cot[1]), _ptr(partial), _ptr(out),
        _stream()), "K2/K4c fused_backward")
    _count(field_backward, frames, bool(rdf), mask is not None, bf16)
    dweights = out[..., :NUM_WEIGHTS] if rdf else None
    geo = out[..., row - _GEO:]
    return geo[..., 0:3], geo[..., 3:12].reshape(*lead, n, 3, 3), geo[..., 12:15], dweights


def field_dir_forward(positions, directions, locations, rotations, half_dims, valid,
                      weights, temperature, position_scale: float = 100.0, group_mask=None,
                      precision: str = "highest"):
    """Launch K3 (K4b for F > 1 frames): ``(u [(F,) P], w [(F,) P, N],
    <dir, grad_x u> [(F,) P])``; ``group_mask`` the optional keep mask;
    ``precision`` "default" or "highest"."""
    bf16 = fused_field.check_precision(precision)
    lead, frames, (pos, dirs, loc, rot, half, val), w, tau = _prepare(
        positions, locations, rotations, half_dims, valid, weights, temperature,
        extra=(directions,))
    p, n = pos.shape[-2], loc.shape[-2]
    if dirs.shape != (*lead, p, 3):
        raise ValueError("directions [(F,) P, 3] expected")
    mask = _group_mask(group_mask, lead, p, n, pos.device)
    lib = build_library()
    u = torch.empty(*lead, p, device=pos.device)
    wts = torch.empty(*lead, p, n, device=pos.device)
    u_dot = torch.empty(*lead, p, device=pos.device)
    _check(lib.vsrd_dir_forward(
        frames, p, n, int(w is not None), int(bf16), _ptr(pos), _ptr(dirs), _ptr(loc), _ptr(rot),
        _ptr(half), _ptr(val), _ptr(w), _ptr(tau), float(position_scale), _ptr(mask),
        MASK_TILE, _ptr(u), _ptr(wts), _ptr(u_dot), _stream()), "K3/K4b dir_forward")
    _count(field_dir_forward, frames, w is not None, mask is not None, bf16)
    return u, wts, u_dot


def sphere_trace(origins, directions, foreground, locations, rotations, half_dims, valid,
                 weights, num_iterations: int, convergence_criteria: float,
                 bounding_radius: float = 0.0, temperature=None,
                 position_scale: float = 100.0):
    """Launch the sphere-trace kernel: the march of ``[(F,) R]`` rays from
    ``origins`` along ``directions`` ``[(F,) R, 3]``, starting in the
    foreground where ``foreground [(F,) R]`` (bool) says, through the hard
    union of ``[(F,) N, ...]`` boxes and weights (``None``: box only), or
    through the softmin union at a float ``temperature``; each frame stops
    on its own. ``bounding_radius`` 0 means no bounding sphere. Returns
    ``(positions [(F,) R, 3], converged [(F,) R] bool, trips [F] int32,
    evaluations [F, R] int32)``: the trips the JAX loop makes per frame, and
    the field evaluations each ray's march made (its work)."""
    lead, frames, (pos, dirs, loc, rot, half, val), w, _ = _prepare(
        origins, locations, rotations, half_dims, valid, weights, None, extra=(directions,))
    lib = build_library()
    r, n = pos.shape[-2], loc.shape[-2]
    if dirs.shape != pos.shape or foreground.shape != (*lead, r):
        raise ValueError("directions [(F,) R, 3] and foreground [(F,) R] expected")
    if foreground.dtype != torch.bool or foreground.device != pos.device:
        raise ValueError("foreground is a bool tensor on the rays' device")
    if num_iterations < 0:
        raise ValueError("num_iterations >= 0 expected")
    tau = 0.0 if temperature is None else float(temperature)
    if temperature is not None and not tau > 0.0:
        raise ValueError("a softmin union needs a positive temperature")
    device = pos.device
    fg = foreground.contiguous()
    marked = torch.zeros(frames, max(num_iterations, 1), dtype=torch.uint8, device=device)
    t_in = torch.empty(frames, r, dtype=torch.int32, device=device)
    bits = torch.empty(frames, r, dtype=torch.uint8, device=device)
    positions = torch.empty(*lead, r, 3, device=device)
    converged = torch.empty(*lead, r, dtype=torch.bool, device=device)
    trips = torch.empty(frames, dtype=torch.int32, device=device)
    _check(lib.vsrd_sphere_trace(
        frames, r, n, int(num_iterations), _ptr(pos), _ptr(dirs), _ptr(fg), _ptr(loc),
        _ptr(rot), _ptr(half), _ptr(val), _ptr(w), float(position_scale), tau,
        float(bounding_radius), float(convergence_criteria), _ptr(marked), _ptr(t_in),
        _ptr(bits), _ptr(positions), _ptr(converged), _ptr(trips), _stream()),
        "sphere_trace")
    _count(sphere_trace, frames, w is not None)
    if temperature is not None:
        sphere_trace.soft_launches += 1
    return positions, converged, trips, torch.clamp(t_in + 1, max=num_iterations)


def _launch_info(fn, what: str, num_instances: int, rdf: bool) -> tuple[int, int, int]:
    threads, smem, ctas = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(fn(num_instances, int(rdf), ctypes.byref(threads), ctypes.byref(smem),
              ctypes.byref(ctas)), what)
    return threads.value, smem.value, ctas.value


def rev_forward_info(num_instances: int, rdf: bool = True) -> tuple[int, int, int]:
    """The K1/K4a kernel's threads per CTA, dynamic shared memory in bytes
    and CTAs per SM on the current card, for ``num_instances``."""
    return _launch_info(build_library().vsrd_rev_forward_info, "rev_forward_info",
                        num_instances, rdf)


def dir_forward_info(num_instances: int, rdf: bool = True) -> tuple[int, int, int]:
    """The K3/K4b kernel's threads per CTA, dynamic shared memory in bytes
    and CTAs per SM on the current card, for ``num_instances``."""
    return _launch_info(build_library().vsrd_dir_forward_info, "dir_forward_info",
                        num_instances, rdf)


def backward_info(rdf: bool = True, precision: str = "highest"
                  ) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
    """The K2/K4c kernels' threads per CTA, dynamic shared memory in bytes
    and CTAs per SM on the current card: (stage 1, stage 2)."""
    info = (ctypes.c_int * 6)()
    _check(build_library().vsrd_fused_backward_info(
        int(rdf), int(fused_field.check_precision(precision)), info), "fused_backward_info")
    return tuple(info[:3]), tuple(info[3:])


def reset_launch_counts():
    for fn in (field_forward, field_backward, field_dir_forward, sphere_trace):
        fn.launches = 0
        fn.batched_launches = 0
        fn.rdf_launches = 0
        fn.skip_launches = 0
        fn.bf16_launches = 0
    sphere_trace.soft_launches = 0


reset_launch_counts()


class _FusedFieldWithGrad(torch.autograd.Function):
    """K1 forward, K2 backward. Positions, validity and the temperature
    are constants, as in the JAX package's custom_vjp."""

    @staticmethod
    def forward(ctx, positions, locations, rotations, half_dims, valid, weights,
                temperature, position_scale, group_mask, precision):
        u, w, g = field_forward(positions, locations, rotations, half_dims, valid,
                                weights, temperature, position_scale, group_mask, precision)
        # K2 reads the same mask as K1
        ctx.save_for_backward(positions, locations, rotations, half_dims, valid, weights,
                              torch.as_tensor(temperature, device=positions.device),
                              group_mask)
        ctx.position_scale = position_scale
        ctx.precision = precision
        return u, w, g

    @staticmethod
    def backward(ctx, du, dw, dg):
        (positions, locations, rotations, half_dims, valid, weights, temperature,
         group_mask) = ctx.saved_tensors
        lead, n = positions.shape[:-1], locations.shape[-2]
        zeros = positions.new_zeros
        du = zeros(lead) if du is None else du
        dw = zeros(*lead, n) if dw is None else dw
        dg = zeros(*lead, 3) if dg is None else dg
        with span("field_kernels.field_backward"):
            dloc, drot, dhalf, dweights = field_backward(
                positions, locations, rotations, half_dims, valid, weights, temperature,
                du, dw, dg, ctx.position_scale, group_mask, ctx.precision)
        return None, dloc, drot, dhalf, None, dweights, None, None, None, None


def fused_field_with_grad(positions, locations, rotations, half_dims, valid, weights,
                          temperature, position_scale: float = 100.0, group_mask=None,
                          precision: str = "highest"):
    """(u [(F,) P], w [(F,) P, N], grad_x u [(F,) P, 3]) of the scene field,
    differentiable with respect to locations, rotations, half_dims and
    weights; an optional leading frame axis on positions and parameters,
    an optional keep mask ``group_mask`` at ``MASK_TILE`` (one mask for
    the forward and its backward) and the products' ``precision``.

    CUDA tensors go through K1 (K4a) and, for the backward, K2 (K4c); CPU
    tensors through the plain twins ``fused_field.scene_eval_with_grad``
    and ``scene_eval_with_grad_batched``. A profiler trace names the call
    ``field_kernels.fused_field_with_grad`` and K2's backward
    ``field_kernels.field_backward``."""
    with span("field_kernels.fused_field_with_grad"):
        if positions.device.type == "cuda":
            return _FusedFieldWithGrad.apply(positions, locations, rotations, half_dims,
                                             valid, weights, temperature, position_scale,
                                             group_mask, precision)
        if positions.device.type == "cpu":
            twin = (fused_field.scene_eval_with_grad_batched if positions.ndim == 3
                    else fused_field.scene_eval_with_grad)
            return twin(positions, locations, rotations, half_dims, valid, weights,
                        temperature, position_scale, group_mask, MASK_TILE, precision)
    raise ValueError(f"no field kernel for device {positions.device}")


def fused_field_dir_forward(positions, directions, locations, rotations, half_dims, valid,
                            weights, temperature, position_scale: float = 100.0,
                            group_mask=None, precision: str = "highest"):
    """(u [(F,) P], w [(F,) P, N], <dir, grad_x u> [(F,) P]), forward only:
    K3 (K4b) on CUDA tensors, the plain twins ``fused_field.scene_eval_dir``
    and ``scene_eval_dir_batched`` on CPU ones; ``group_mask`` and
    ``precision`` as in ``fused_field_with_grad``; a profiler trace names
    the call ``field_kernels.fused_field_dir_forward``."""
    with span("field_kernels.fused_field_dir_forward"):
        if positions.device.type == "cuda":
            return field_dir_forward(positions, directions, locations, rotations, half_dims,
                                     valid, weights, temperature, position_scale, group_mask,
                                     precision)
        if positions.device.type == "cpu":
            twin = (fused_field.scene_eval_dir_batched if positions.ndim == 3
                    else fused_field.scene_eval_dir)
            return twin(positions, directions, locations, rotations, half_dims, valid,
                        weights, temperature, position_scale, group_mask, MASK_TILE, precision)
    raise ValueError(f"no field kernel for device {positions.device}")
