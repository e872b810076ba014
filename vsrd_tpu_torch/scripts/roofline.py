"""Roofline of the field kernels on Hopper: the work each one must do,
counted from its plain twin, against the card's units.

Counterpart of the JAX package's ``scripts/roofline.py``::

    python -m vsrd_tpu_torch.scripts.roofline [--instances 8 --points 200000]
    python -m vsrd_tpu_torch.scripts.roofline --device cpu --points 512 --instances 2 --reps 1

The JAX script counts the work of the Pallas kernel body by walking its
jaxpr. Here ``count_ops`` runs the kernel's plain twin in
``rendering/fused_field.py`` on a tile of points on the CPU under a
``TorchDispatchMode`` and classifies every aten op it dispatches: matrix
products (``mm``, ``bmm``, ``addmm``, ``baddbmm``) as tensor-core
multiply-adds, ``TRANSCENDENTAL`` ops as one special-function result per
element, views, copies, concatenations, selects, indexing and the bf16
rounding casts (``FREE``) as no work, and every other op as f32 element
operations: one per element it writes, or per element of its largest
operand where it reads more (a reduction). Two rules keep the
tensor-core count the function's and the same at both precisions, where
the default twin folds each bias into its product as a column of ones: in
a product, an operand row or column that is all zeros does no work and one
that is all ones turns its multiply-adds into additions (counted as f32
operations); and a product's output elements that no later op reads (the
reverse sweep's cotangent of that column of ones) are not counted.

``tile_counts`` counts each function once: its multiply-adds and
transcendentals from the twin at the call's precision (the default
precision's encoding is the JAX package's fast form, sin and cos at 2 of
the 8 frequencies with angle doubling between, so it has fewer
transcendentals), its f32 operations from the strict ("highest") twin at
both precisions, so that the default twin's differentiable rounding
(``bf16_matmul``'s backward and its bias columns) adds nothing. The f32
and transcendental counts are still the twin's aten-level counts, one per
element of each op: they move when a twin is rewritten (a recomputation
counts again; an erf counts one operation where the kernel runs a
polynomial). So the binding unit is named among ``BINDING_UNITS``, the
tensor cores and HBM, whose counts (the MLP's multiply-adds, each input
read and each output written once) no rewrite of a twin moves; the f32
and special-function bounds are reported beside it.

``kernel_work`` scales the counts of one tile to a call, and
``bounds_ms`` turns them into the least time of each unit of one H100 (the
``Hopper`` model, its rates named below with their sources; the SM count
and maximum SM clock are read on the card). The binding unit is the one of
``BINDING_UNITS`` with the larger bound; a kernel's fraction of that bound
is the bound over its measured time. The CLI counts K1 at ``--points``
and ``--instances`` (every instance valid, the residual field, the
default precision, the JAX script's inputs and draw order), times K1 on
CUDA events over ``--reps`` calls and prints the report as JSON
(``--out`` also writes it).
On the CPU the measured time is "not measured" and the model takes the
data sheet's SM count and clock.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..rendering import field_kernels, fused_field
from . import bench_common as bc

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the 700 W limit):
PEAK_BF16 = 989e12        # FLOP/s, BF16 tensor cores with f32 sums ("default")
PEAK_TF32 = 495e12        # FLOP/s, TF32 tensor cores
RATE_3XTF32 = PEAK_TF32 / 3   # "highest": three TF32 products per f32 multiply-add
PEAK_F32 = 67e12          # FLOP/s, f32 outside the tensor cores (an FMA is 2 FLOP)
PEAK_BYTES = 3.35e12      # HBM3 bytes/s
DATA_SHEET_SMS = 132
DATA_SHEET_MAX_SM_MHZ = 1980
# CUDA C++ Programming Guide, "Arithmetic Instructions" throughput table,
# compute capability 9.0: 16 results per clock per SM for the special
# functions (reciprocal square root, base-2 exponent and logarithm, sine,
# cosine)
SFU_RESULTS_PER_CLOCK_PER_SM = 16
# The least work each counted element stands for (the report's assumptions):
# an f32 element operation is 1 FLOP, so that two of them fill one FMA slot
# of the 67 TFLOP/s peak; a transcendental element is one special-function
# result (the precise library forms add FMAs, counted nowhere: a lower bound)
F32_FLOP_PER_OP = 1.0
SFU_RESULTS_PER_TRANSCENDENTAL = 1.0

TILE = 128                # points of the tile whose work count_ops counts
# the units whose counts no rewrite of a twin moves (see the docstring)
BINDING_UNITS = ("tensor", "hbm")
NUM_WEIGHTS = field_kernels.NUM_WEIGHTS
KINDS = ("K1", "K2", "K3")

PRODUCTS = {"mm": (0, 1), "bmm": (0, 1), "addmm": (1, 2), "baddbmm": (1, 2)}
TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sin", "cos", "tan", "tanh",
    "sinh", "cosh", "asin", "acos", "atan", "atan2", "rsqrt", "sqrt", "sigmoid", "pow",
    "_softmax", "_log_softmax",   # one exp per element
    "gelu_backward",              # the normal density's exp
}
FREE = {
    "_to_copy", "clone", "copy_", "copy", "cat", "stack", "where", "masked_fill", "index",
    "_unsafe_index", "index_select", "gather", "scatter", "index_put", "index_put_",
    "select_backward", "slice_backward", "constant_pad_nd", "repeat", "flip",
    "ones_like", "zeros_like", "full_like", "empty_like", "ones", "zeros", "full", "empty",
    "new_ones", "new_zeros", "new_full", "new_empty", "empty_strided", "scalar_tensor",
    "arange", "lift_fresh", "lift_fresh_copy", "fill", "fill_", "zero_", "_unsafe_view",
    "detach", "alias", "expand", "view", "reshape", "permute", "transpose", "t",
    "unsqueeze", "squeeze", "select", "slice", "unbind", "split", "split_with_sizes",
    "narrow", "as_strided", "_local_scalar_dense", "is_nonzero",
    # forward-mode autodiff's bookkeeping
    "is_same_size", "_has_same_storage_numel", "_efficientzerotensor",
    "_new_zeros_with_same_feature_meta", "_is_zerotensor", "resolve_conj", "resolve_neg",
}


class Counts(NamedTuple):
    """Work of one call: tensor-core multiply-adds, f32 element
    operations and transcendental elements."""
    tensor_macs: float
    f32_ops: float
    transcendentals: float

    def scaled(self, factor: float) -> "Counts":
        return Counts(*(v * factor for v in self))


def _is_view(func) -> bool:
    """Whether ``func`` returns an alias of its input and reads nothing:
    a view by its schema, or ``_unsafe_view`` (an alias that autograd does
    not track as a view)."""
    return func.overloadpacket.__name__ == "_unsafe_view" or any(
        r.alias_info is not None and not r.alias_info.is_write for r in func._schema.returns)


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _trivial(x: torch.Tensor, dim: int):
    """Per slice along ``dim`` of a ``[b, r, c]`` operand: (all zeros, all
    ones and not all zeros) as ``[b, ...]`` bools."""
    zero = (x == 0).all(dim)
    return zero, (x == 1).all(dim) & ~zero


def _kept(total: int, *dropped: torch.Tensor) -> torch.Tensor:
    """Per batch, the slices of ``total`` that none of the ``dropped``
    masks marks."""
    return total - sum(d.sum(-1) for d in dropped)


class _Product:
    """A product's multiply-adds and additions, and which of its output
    elements a later op reads."""

    def __init__(self, out: torch.Tensor, macs: int, adds: int):
        self.out = out      # holds the storage, so that its address stays its own
        self.macs, self.adds = macs, adds
        self.read = torch.zeros(out.untyped_storage().nbytes() // out.element_size(),
                                dtype=torch.bool)

    def counted(self) -> tuple[float, float]:
        """(multiply-adds, additions) in the share of the output that was read."""
        read, total = int(self.read.sum()), self.read.numel()
        if not total:
            return 0.0, 0.0
        return self.macs * read / total, self.adds * read / total


class _Counter(TorchDispatchMode):
    """Counts what runs under it (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.f32 = 0
        self.transcendentals = 0
        self.products: dict[int, _Product] = {}

    def mark_read(self, t: torch.Tensor) -> None:
        if not self.products:
            return
        product = self.products.get(t.untyped_storage().data_ptr())
        if product is None:
            return
        if t.dtype != product.out.dtype:
            product.read.fill_(True)
        else:
            product.read.as_strided(t.shape, t.stride(), t.storage_offset()).fill_(True)

    def _product(self, a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> None:
        a = a.unsqueeze(0) if a.ndim == 2 else a
        b = b.unsqueeze(0) if b.ndim == 2 else b
        m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
        a_row_zero, a_row_one = _trivial(a, -1)
        a_col_zero, a_col_one = _trivial(a, -2)
        b_row_zero, b_row_one = _trivial(b, -1)
        b_col_zero, b_col_one = _trivial(b, -2)
        k_zero = a_col_zero | b_row_zero
        k_one = (a_col_one | b_row_one) & ~k_zero
        live = _kept(m, a_row_zero) * _kept(k, k_zero) * _kept(n, b_col_zero)
        macs = (_kept(m, a_row_zero, a_row_one) * _kept(k, k_zero, k_one)
                * _kept(n, b_col_zero, b_col_one))
        self.products[out.untyped_storage().data_ptr()] = _Product(
            out, int(macs.sum()), int((live - macs).sum()))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        view = _is_view(func)
        inputs = _tensors((args, kwargs))
        if not view:
            for t in inputs:
                self.mark_read(t)
        name = func.overloadpacket.__name__
        if view or name in FREE:
            return out
        outputs = _tensors(out)
        if name in PRODUCTS:
            first, second = PRODUCTS[name]
            self._product(args[first], args[second], out)
            if first:      # addmm / baddbmm: the bias's additions
                self.f32 += out.numel()
            return out
        if name == "pow" and isinstance(args[1], (int, float)) and float(args[1]).is_integer():
            name = "mul"   # an integer power is repeated multiplication; others transcendental
        if name in TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outputs)
        else:
            self.f32 += max((t.numel() for t in inputs + outputs), default=0)
        return out

    def counts(self) -> Counts:
        macs = adds = 0.0
        for product in self.products.values():
            product_macs, product_adds = product.counted()
            macs += product_macs
            adds += product_adds
        return Counts(macs, self.f32 + adds, float(self.transcendentals))


def count_ops(fn, *args) -> Counts:
    """The work of ``fn(*args)``, counted from the aten ops it dispatches
    (see the module docstring); what ``fn`` returns counts as read."""
    counter = _Counter()
    with counter:
        result = fn(*args)
    for t in _tensors(result):
        counter.mark_read(t)
    return counter.counts()


def twin(kind: str, rdf: bool, precision: str):
    """The plain twin of kernel ``kind`` as a function of
    ``bench_common.field_inputs``:
    K1 the field with its spatial gradient, K3 the field with its ray
    tangent, K2 the cotangents of K1's parameters from those of its
    outputs (the forward and its reverse sweep recomputed, as the kernel
    recomputes them)."""
    def weights(x):
        return x["weights"] if rdf else None

    if kind == "K1":
        def k1(x):
            with torch.no_grad():
                return fused_field.scene_eval_with_grad(
                    x["pos"], x["loc"], x["rot"], x["half"], x["valid"], weights(x),
                    x["tau"], precision=precision)
        return k1
    if kind == "K3":
        def k3(x):
            return fused_field.scene_eval_dir(
                x["pos"], x["dirs"], x["loc"], x["rot"], x["half"], x["valid"], weights(x),
                x["tau"], precision=precision)
        return k3
    if kind == "K2":
        def k2(x):
            leaves = [x["loc"], x["rot"], x["half"]] + ([x["weights"]] if rdf else [])
            leaves = [t.detach().requires_grad_() for t in leaves]
            with torch.enable_grad():
                outs = fused_field.scene_eval_with_grad(
                    x["pos"], *leaves[:3], x["valid"], leaves[3] if rdf else None, x["tau"],
                    precision=precision)
                return torch.autograd.grad(outs, leaves, (x["du"], x["dw"], x["dg"]))
        return k2
    raise ValueError(f"kind is one of {KINDS}, not {kind!r}")


@functools.lru_cache(maxsize=None)
def twin_counts(kind: str, instances: int, rdf: bool, precision: str) -> Counts:
    """``count_ops`` of kernel ``kind``'s twin at ``precision`` on ``TILE``
    points and ``instances`` valid instances."""
    fused_field.check_precision(precision)
    return count_ops(twin(kind, rdf, precision),
                     bc.field_inputs(TILE, instances, instances, device="cpu"))


def tile_counts(kind: str, instances: int, rdf: bool = True,
                precision: str = "default") -> Counts:
    """The work of kernel ``kind`` on ``TILE`` points and ``instances``
    valid instances: the multiply-adds and transcendentals of its twin at
    ``precision``, the f32 operations of its strict twin (see the module
    docstring)."""
    own = twin_counts(kind, instances, rdf, precision)
    strict = twin_counts(kind, instances, rdf, "highest")
    return own._replace(f32_ops=strict.f32_ops)


def call_bytes(kind: str, points: int, instances: int, rdf: bool = True,
               frames: int = 1) -> int:
    """Bytes of one call: each input read once and each output written
    once (f32), the per-instance boxes left out."""
    n = instances
    weights = frames * n * NUM_WEIGHTS * 4 if rdf else 0
    if kind == "K1":         # pos in; u, w, grad_x u out
        return frames * points * (12 + 4 + 4 * n + 12) + weights
    if kind == "K2":         # pos, dg, du, dw in; one row per instance out
        return (frames * points * (12 + 12 + 4 + 4 * n) + weights
                + frames * n * 4 * (NUM_WEIGHTS + 15 if rdf else 15))
    if kind == "K3":         # pos, dirs in; u, w, u_dot out
        return frames * points * (12 + 12 + 4 + 4 * n + 4) + weights
    raise ValueError(f"kind is one of {KINDS}, not {kind!r}")


def kernel_work(kind: str, points: int, instances: int, rdf: bool = True,
                precision: str = "default", frames: int = 1, pairs: int | None = None) -> dict:
    """The work of one call of kernel ``kind`` (K4a-c: ``frames`` > 1) on
    ``points`` points per frame and ``instances`` instances: the counts of
    one tile with every instance valid, scaled to the call, and its bytes.
    ``pairs``: the point-instance pairs the call evaluates when fewer
    instances are valid (or a skip mask drops some), which then scale the
    tile's counts per pair."""
    counts = tile_counts(kind, instances, rdf, precision)
    pairs = frames * points * instances if pairs is None else pairs
    counts = counts.scaled(pairs / (TILE * instances))
    return {**counts._asdict(), "bytes": call_bytes(kind, points, instances, rdf, frames)}


@dataclasses.dataclass(frozen=True)
class Hopper:
    """The rates of one H100: the data sheet's peaks and the special
    function units' rate from the SM count and the maximum SM clock."""
    sms: int
    max_sm_mhz: float
    source: str

    def rates(self, precision: str) -> dict:
        bf16 = fused_field.check_precision(precision)
        return {
            "tensor_flops_per_s": PEAK_BF16 if bf16 else RATE_3XTF32,
            "f32_flops_per_s": PEAK_F32,
            "sfu_results_per_s": SFU_RESULTS_PER_CLOCK_PER_SM * self.sms * self.max_sm_mhz * 1e6,
            "hbm_bytes_per_s": PEAK_BYTES,
        }


@functools.lru_cache(maxsize=None)
def hopper_model(device: str = "cuda") -> Hopper:
    """The model of the card on ``device`` (its SM count, and its maximum
    SM clock from ``nvidia-smi --query-gpu=clocks.max.sm``), or of the data
    sheet's H100 SXM for ``device="cpu"``."""
    if device == "cpu":
        return Hopper(DATA_SHEET_SMS, DATA_SHEET_MAX_SM_MHZ, "data sheet (no card)")
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return Hopper(sms, float(out.stdout.strip().splitlines()[0]), "read on the card")


def bounds_ms(work: dict, precision: str, model: Hopper) -> dict:
    """The least ms of each unit for ``work`` (``kernel_work``'s)."""
    rates = model.rates(precision)
    return {
        "tensor": 2 * work["tensor_macs"] / rates["tensor_flops_per_s"] * 1e3,
        "f32": work["f32_ops"] * F32_FLOP_PER_OP / rates["f32_flops_per_s"] * 1e3,
        "sfu": (work["transcendentals"] * SFU_RESULTS_PER_TRANSCENDENTAL
                / rates["sfu_results_per_s"] * 1e3),
        "hbm": work["bytes"] / rates["hbm_bytes_per_s"] * 1e3,
    }


def binding(bounds: dict) -> tuple[str, float]:
    """The binding unit among ``BINDING_UNITS`` and its bound."""
    unit = max(BINDING_UNITS, key=bounds.get)
    return unit, bounds[unit]


def assumptions(precision: str, model: Hopper) -> dict:
    return {**model.rates(precision), "sms": model.sms, "max_sm_mhz": model.max_sm_mhz,
            "sm_source": model.source, "f32_flop_per_op": F32_FLOP_PER_OP,
            "sfu_results_per_transcendental": SFU_RESULTS_PER_TRANSCENDENTAL,
            "sfu_results_per_clock_per_sm": SFU_RESULTS_PER_CLOCK_PER_SM,
            "tile_points": TILE, "binding_units": list(BINDING_UNITS),
            "f32_count": "the strict twin's, one operation per element of each aten op",
            "transcendental_count": "the twin's, one result per element of each op"}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--points", type=int, default=200_000)
    parser.add_argument("--instances", type=int, default=8)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--out", help="write the report as JSON to this path")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    card = bc.prepare_device(args.device)
    n, precision = args.instances, "default"
    model = hopper_model(args.device)
    work = kernel_work("K1", args.points, n, True, precision)
    bounds = bounds_ms(work, precision, model)
    unit, bound = binding(bounds)

    x = bc.script_inputs(args.points, n, True, args.device, bc.ROOFLINE_DRAWS)

    def fwd():
        with torch.no_grad():
            return field_kernels.fused_field_with_grad(
                x["pos"], x["loc"], x["rot"], x["half"], x["valid"], x["weights"], x["tau"],
                precision=precision)

    if args.device == "cuda":
        field_kernels.reset_launch_counts()
        measured = bc.event_ms(fwd, args.reps)
        launches = field_kernels.field_forward.launches
    else:
        fwd()
        measured, launches = None, 0
    report = {
        "workload": {"kernel": "K1", "points": args.points, "instances": n,
                     "precision": precision, "rdf": True, "reps": args.reps},
        "card": card,
        "counts": work,
        "counts_per_point_instance": {k: work[k] / (args.points * n)
                                      for k in Counts._fields},
        "assumptions": assumptions(precision, model),
        "bounds_ms": bounds,
        "measured_ms": measured if measured is not None else "not measured",
        "launches": launches,
        "binding_unit": unit,
        "utilization": ({u: b / measured for u, b in bounds.items()}
                        if measured else "not measured"),
        "fraction_of_binding_bound": bound / measured if measured else "not measured",
    }
    print(json.dumps(report, indent=2), flush=True)
    bc.write_json(args.out, report)
    return report


if __name__ == "__main__":
    main()
