"""The scene-field kernels K1-K4c: hand-written CUDA for Hopper, their
wrappers, launch counters and the autograd binding.

Counterpart of ``vsrd_tpu/rendering/pallas_field.py``:

* K1 ``field_forward``: u [P], w [P, N] and grad_x u [P, 3] of the union
  SDF (``csrc/fused_forward.cu``; TPU ``_fwd_kernel`` with ``rev_grad``),
  grad_x u from one reverse sweep per instance with the layer products on
  the tensor cores in 3xTF32;
* K2 ``field_backward``: the cotangents of K1's inputs from those of its
  outputs (``csrc/fused_backward.cu``; TPU ``_bwd_kernel_manual``). One
  call launches three CUDA kernels: the union's cotangents per point, the
  per-instance reverse sweep with its weight-gradient sums on the tensor
  cores (3xTF32), and the ordered reduction of the CTAs' partial rows;
* K3 ``field_dir_forward``: u, w and the derivative of u along a
  per-point direction, forward only (``csrc/dir_forward.cu``; TPU
  ``_dir_fwd_kernel``), the value and its tangent as two column blocks of
  one set of layer products on the tensor cores in 3xTF32.

Each launcher also takes F stacked frames: positions ``[F, P, 3]`` (and
directions and cotangents with the same leading axis) with ``[F, N, ...]``
boxes, validity and weights, and one scalar temperature. That is ONE
launch with a frame grid axis, whatever F is: K4a, K4c and K4b, the
counterparts of the TPU's ``_fused_forward_batched``,
``_fused_bwd_batched`` and ``_fused_dir_forward_batched``. Each frame's
outputs come from its own points and parameters only.

``fused_field_with_grad`` binds K1 to K2 through ``torch.autograd.Function``
and ``fused_field_dir_forward`` calls K3. On CPU tensors both take the
plain twins in ``fused_field`` (autograd and ``torch.func.jvp`` of the
eager field, looped over frames for a leading frame axis); on CUDA tensors
they launch the kernels or raise — there is no fallback. Each launcher
counts its launches in ``<launcher>.launches`` and, of those, the ones
with more than one frame (K4a/K4c/K4b) in ``<launcher>.batched_launches``
and the ones with the residual field in ``<launcher>.rdf_launches``.

The kernels are compiled on first use with ``nvcc`` for ``sm_90a`` from
``csrc/`` into a plain-C shared library, loaded with ctypes. It goes to
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

from . import fused_field

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
NUM_WEIGHTS = 1617
_GEO = 15
_PARAMS = NUM_WEIGHTS + _GEO

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
    lib.vsrd_fused_forward.argtypes = [i32] * 4 + [ptr] * 7 + [f32] + [ptr] * 4
    lib.vsrd_dir_forward.argtypes = [i32] * 4 + [ptr] * 8 + [f32] + [ptr] * 4
    lib.vsrd_fused_backward.argtypes = [i32] * 4 + [ptr] * 10 + [f32, i32] + [ptr] * 5
    lib.vsrd_fused_backward_tiles.argtypes = [i32]
    lib.vsrd_rev_forward_info.argtypes = [i32, i32, ptr, ptr, ptr]
    lib.vsrd_dir_forward_info.argtypes = [i32, i32, ptr, ptr, ptr]
    for fn in (lib.vsrd_fused_forward, lib.vsrd_dir_forward, lib.vsrd_fused_backward,
               lib.vsrd_fused_backward_tiles, lib.vsrd_rev_forward_info,
               lib.vsrd_dir_forward_info):
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
    tensor."""
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
    tau = torch.as_tensor(temperature, dtype=torch.float32, device=device).reshape(1)
    contig = [t.detach().contiguous() for t in (
        positions, *extra, locations, rotations, half_dims, valid)]
    w = None if weights is None else weights.detach().contiguous()
    return lead, frames, contig, w, tau


def _count(launcher, frames: int, rdf: bool):
    launcher.launches += 1
    if frames > 1:
        launcher.batched_launches += 1
    if rdf:
        launcher.rdf_launches += 1


def field_forward(positions, locations, rotations, half_dims, valid, weights,
                  temperature, position_scale: float = 100.0):
    """Launch K1 (K4a for F > 1 frames): ``(u [(F,) P], w [(F,) P, N],
    grad_x u [(F,) P, 3])``. ``weights`` ``[(F,) N, 1617]`` or ``None``
    (box only); ``valid`` float ``[(F,) N]``."""
    lead, frames, (pos, loc, rot, half, val), w, tau = _prepare(
        positions, locations, rotations, half_dims, valid, weights, temperature)
    lib = build_library()
    p, n = pos.shape[-2], loc.shape[-2]
    u = torch.empty(*lead, p, device=pos.device)
    wts = torch.empty(*lead, p, n, device=pos.device)
    grad = torch.empty(*lead, p, 3, device=pos.device)
    _check(lib.vsrd_fused_forward(
        frames, p, n, int(w is not None), _ptr(pos), _ptr(loc), _ptr(rot), _ptr(half),
        _ptr(val), _ptr(w), _ptr(tau), float(position_scale), _ptr(u), _ptr(wts), _ptr(grad),
        _stream()), "K1/K4a fused_forward")
    _count(field_forward, frames, w is not None)
    return u, wts, grad


def field_backward(positions, locations, rotations, half_dims, valid, weights,
                   temperature, du, dw, dg, position_scale: float = 100.0):
    """Launch K2 (K4c for F > 1 frames): the cotangents ``(dloc [(F,) N,
    3], drot [(F,) N, 3, 3], dhalf [(F,) N, 3], dweights [(F,) N, 1617] or
    None)`` of K1's inputs from those of its outputs ``du [(F,) P]``,
    ``dw [(F,) P, N]``, ``dg [(F,) P, 3]``. Frame f's cotangents come from
    frame f's points only."""
    lead, frames, (pos, dg_c, du_c, dw_c, loc, rot, half, val), w, tau = _prepare(
        positions, locations, rotations, half_dims, valid, weights, temperature,
        extra=(dg, du, dw))
    lib = build_library()
    p, n = pos.shape[-2], loc.shape[-2]
    if dg_c.shape != (*lead, p, 3) or du_c.shape != (*lead, p) or dw_c.shape != (*lead, p, n):
        raise ValueError("cotangents du [(F,) P], dw [(F,) P, N], dg [(F,) P, 3] expected")
    rdf = int(w is not None)
    tiles = lib.vsrd_fused_backward_tiles(p)
    row = _PARAMS if rdf else _GEO
    # scratch: d_bar and td_bar [2, F, N, P], the CTAs' partial rows [F, N, tiles, row];
    # the kernels write every element before reading it
    cot = torch.empty(2, frames, n, p, device=pos.device)
    partial = torch.empty(frames, n, tiles, row, device=pos.device)
    out = torch.empty(*lead, n, row, device=pos.device)
    _check(lib.vsrd_fused_backward(
        frames, p, n, rdf, _ptr(pos), _ptr(dg_c), _ptr(du_c), _ptr(dw_c), _ptr(loc),
        _ptr(rot), _ptr(half), _ptr(val), _ptr(w), _ptr(tau), float(position_scale), tiles,
        _ptr(cot[0]), _ptr(cot[1]), _ptr(partial), _ptr(out), _stream()),
        "K2/K4c fused_backward")
    _count(field_backward, frames, bool(rdf))
    dweights = out[..., :NUM_WEIGHTS] if rdf else None
    geo = out[..., row - _GEO:]
    return geo[..., 0:3], geo[..., 3:12].reshape(*lead, n, 3, 3), geo[..., 12:15], dweights


def field_dir_forward(positions, directions, locations, rotations, half_dims, valid,
                      weights, temperature, position_scale: float = 100.0):
    """Launch K3 (K4b for F > 1 frames): ``(u [(F,) P], w [(F,) P, N],
    <dir, grad_x u> [(F,) P])``."""
    lead, frames, (pos, dirs, loc, rot, half, val), w, tau = _prepare(
        positions, locations, rotations, half_dims, valid, weights, temperature,
        extra=(directions,))
    lib = build_library()
    p, n = pos.shape[-2], loc.shape[-2]
    if dirs.shape != (*lead, p, 3):
        raise ValueError("directions [(F,) P, 3] expected")
    u = torch.empty(*lead, p, device=pos.device)
    wts = torch.empty(*lead, p, n, device=pos.device)
    u_dot = torch.empty(*lead, p, device=pos.device)
    _check(lib.vsrd_dir_forward(
        frames, p, n, int(w is not None), _ptr(pos), _ptr(dirs), _ptr(loc), _ptr(rot),
        _ptr(half), _ptr(val), _ptr(w), _ptr(tau), float(position_scale), _ptr(u), _ptr(wts),
        _ptr(u_dot), _stream()), "K3/K4b dir_forward")
    _count(field_dir_forward, frames, w is not None)
    return u, wts, u_dot


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


def reset_launch_counts():
    for fn in (field_forward, field_backward, field_dir_forward):
        fn.launches = 0
        fn.batched_launches = 0
        fn.rdf_launches = 0


reset_launch_counts()


class _FusedFieldWithGrad(torch.autograd.Function):
    """K1 forward, K2 backward. Positions, validity and the temperature
    are constants, as in the JAX package's custom_vjp."""

    @staticmethod
    def forward(ctx, positions, locations, rotations, half_dims, valid, weights,
                temperature, position_scale):
        u, w, g = field_forward(positions, locations, rotations, half_dims, valid,
                                weights, temperature, position_scale)
        ctx.save_for_backward(positions, locations, rotations, half_dims, valid, weights,
                              torch.as_tensor(temperature, device=positions.device))
        ctx.position_scale = position_scale
        return u, w, g

    @staticmethod
    def backward(ctx, du, dw, dg):
        positions, locations, rotations, half_dims, valid, weights, temperature = (
            ctx.saved_tensors)
        lead, n = positions.shape[:-1], locations.shape[-2]
        zeros = positions.new_zeros
        du = zeros(lead) if du is None else du
        dw = zeros(*lead, n) if dw is None else dw
        dg = zeros(*lead, 3) if dg is None else dg
        dloc, drot, dhalf, dweights = field_backward(
            positions, locations, rotations, half_dims, valid, weights, temperature,
            du, dw, dg, ctx.position_scale)
        return None, dloc, drot, dhalf, None, dweights, None, None


def fused_field_with_grad(positions, locations, rotations, half_dims, valid, weights,
                          temperature, position_scale: float = 100.0):
    """(u [(F,) P], w [(F,) P, N], grad_x u [(F,) P, 3]) of the scene field,
    differentiable with respect to locations, rotations, half_dims and
    weights; an optional leading frame axis on positions and parameters.

    CUDA tensors go through K1 (K4a) and, for the backward, K2 (K4c); CPU
    tensors through the plain twins ``fused_field.scene_eval_with_grad``
    and ``scene_eval_with_grad_batched``."""
    if positions.device.type == "cuda":
        return _FusedFieldWithGrad.apply(positions, locations, rotations, half_dims,
                                         valid, weights, temperature, position_scale)
    if positions.device.type == "cpu":
        twin = (fused_field.scene_eval_with_grad_batched if positions.ndim == 3
                else fused_field.scene_eval_with_grad)
        return twin(positions, locations, rotations, half_dims, valid, weights, temperature,
                    position_scale)
    raise ValueError(f"no field kernel for device {positions.device}")


def fused_field_dir_forward(positions, directions, locations, rotations, half_dims, valid,
                            weights, temperature, position_scale: float = 100.0):
    """(u [(F,) P], w [(F,) P, N], <dir, grad_x u> [(F,) P]), forward only:
    K3 (K4b) on CUDA tensors, the plain twins ``fused_field.scene_eval_dir``
    and ``scene_eval_dir_batched`` on CPU ones."""
    if positions.device.type == "cuda":
        return field_dir_forward(positions, directions, locations, rotations, half_dims,
                                 valid, weights, temperature, position_scale)
    if positions.device.type == "cpu":
        twin = (fused_field.scene_eval_dir_batched if positions.ndim == 3
                else fused_field.scene_eval_dir)
        return twin(positions, directions, locations, rotations, half_dims, valid, weights,
                    temperature, position_scale)
    raise ValueError(f"no field kernel for device {positions.device}")
