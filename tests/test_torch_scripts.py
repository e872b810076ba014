"""The port's measuring entry points (``vsrd_tpu_torch/scripts/``:
steptime, kernelbench, roofline, photobench, profile) against the JAX
package's top-level scripts.

On the CPU, at small sizes: the bench scenes are the JAX scripts' scenes,
each script's ``OptimizationConfig`` is the JAX script's for the same flags,
each ``main`` runs with ``--device cpu`` and prints its line or JSON keys
and writes JSON only to ``--out``, and ``roofline.count_ops`` counts the
work of the kernels' plain twins (3,104 tensor-core multiply-adds per
point and instance for K1 and K3 with the residual field: the value and one
sweep or tangent of the 48-16-16-16-16-1 MLP, 2 x 1,552).
"""

import dataclasses
import importlib.util
import json
import os
import pathlib
import re
import sys
import types

import jax
import numpy as np
import pytest
import torch

from vsrd_tpu.pipeline import frame as jfm
from vsrd_tpu.pipeline import optimize as jopt
from vsrd_tpu_torch.scripts import (bench_common, kernelbench, photobench, profile, roofline,
                                    steptime)
from vsrd_tpu_torch.utils import spans

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "vsrd_tpu_torch" / "scripts"
JAX_OUTPUTS = ("KERNELBENCH.json", "PHOTOBENCH.json")
SMALL = ["--device", "cpu", "--views", "2", "--height", "32", "--width", "48",
         "--instances", "2"]
MLP_MACS = 48 * 16 + 3 * 16 * 16 + 16      # one value of the 48-16-16-16-16-1 MLP


def test_scene_seeds_are_the_jax_draws():
    draws = [int(jax.random.randint(jax.random.PRNGKey(i), (), 0, 2**31 - 1))
             for i in range(8)]
    assert list(bench_common.SCENE_SEEDS) == draws


@pytest.mark.parametrize("layout", ["compact", "kitti"])
def test_bench_frames_are_the_jax_scenes(layout):
    frames = bench_common.bench_frames(2, views=2, size=(32, 48), instances=3, layout=layout,
                                       device="cpu")
    for i, tf in enumerate(frames):
        jf = jfm.synthetic_frame(jax.random.PRNGKey(i), num_views=2, image_size=(32, 48),
                                 num_instances=3, max_instances=3, layout=layout)
        for name in ("soft_masks_flat", "gt_boxes_2d", "gt_boxes_3d", "valid", "intrinsics",
                     "extrinsics", "camera_positions"):
            want = np.asarray(getattr(jf, name)).astype(np.float32)
            np.testing.assert_array_equal(getattr(tf, name).float().numpy(), want,
                                          err_msg=f"frame {i} {name}")


# --- each script's config against the JAX script's -------------------------

def _load_jax_script(name):
    """The JAX package's scripts/<name>.py, loaded from its file (putting
    scripts/ on sys.path would shadow the standard library's profile)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Stop(Exception):
    pass


def _jax_script_config(name, argv, monkeypatch):
    """The OptimizationConfig the JAX script's main builds for ``argv``: its
    first call of synthetic_frame, which follows the config, stops it."""
    module = _load_jax_script(name)
    made = []

    def record(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    def stop(*args, **kwargs):
        raise _Stop

    real = jopt.OptimizationConfig
    monkeypatch.setattr(jopt, "OptimizationConfig", record)
    monkeypatch.setattr(jfm, "synthetic_frame", stop)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    with pytest.raises(_Stop):
        module.main()
    (cfg,) = made
    return cfg


def _jax_photobench_configs(argv, monkeypatch):
    """The OptimizationConfig of each arm that scripts/photobench.py's main
    builds for ``argv``, at 2 small views (its frame comes first): its
    parameters, optimizer and timed chunks stubbed, its second config
    stops it."""
    module = _load_jax_script("photobench")
    made = []

    def record(*args, **kwargs):
        made.append(real(*args, **kwargs))
        if len(made) == 2:
            raise _Stop
        return made[-1]

    real = jopt.OptimizationConfig
    monkeypatch.setattr(jopt, "OptimizationConfig", record)
    monkeypatch.setattr(jopt, "init_params", lambda *args, **kwargs: None)
    monkeypatch.setattr(jopt, "make_optimizer",
                        lambda *args: types.SimpleNamespace(init=lambda params: None))
    monkeypatch.setattr(module, "time_chunk", lambda *args: (1.0, {}))
    monkeypatch.setattr(sys, "argv", ["photobench"] + argv + [
        "--views", "2", "--height", "32", "--width", "48", "--instances", "2"])
    with pytest.raises(_Stop):
        module.main()
    return made


def _assert_same_config(port_cfg, jax_cfg):
    """Field by field over the shared names, ``pallas_*`` as ``kernel_*``;
    every field of the port's config has its JAX counterpart."""
    port = {f.name for f in dataclasses.fields(port_cfg)}
    shared = set()
    for field in dataclasses.fields(jax_cfg):
        name = re.sub(r"^pallas_", "kernel_", field.name)
        if name in port:
            assert getattr(port_cfg, name) == getattr(jax_cfg, field.name), name
            shared.add(name)
    assert shared == port


@pytest.mark.parametrize("argv", [
    [], ["--box-coarse"], ["--group-skip"],
    ["--no-group-skip", "--rays", "500", "--samples", "64", "--chunk", "50"],
])
def test_steptime_config_is_the_jax_scripts(argv, monkeypatch):
    port = steptime.make_config(steptime.parse_args(argv))
    jax_argv = argv + ["--views", "2"]
    _assert_same_config(port, _jax_script_config("steptime", jax_argv, monkeypatch))


@pytest.mark.parametrize("argv", [[], ["--steps", "7", "--rays", "64", "--samples", "8"]])
def test_profile_config_is_the_jax_scripts(argv, monkeypatch):
    port = profile.make_config(profile.parse_args(argv))
    _assert_same_config(port, _jax_script_config("profile", argv, monkeypatch))


@pytest.mark.parametrize("weight", [0.0, 1.0])
def test_photobench_config_is_the_jax_scripts(weight, monkeypatch):
    argv = ["--chunk", "20"]
    jax_cfgs = {cfg.photometric_weight: cfg
                for cfg in _jax_photobench_configs(argv, monkeypatch)}
    assert sorted(jax_cfgs) == list(photobench.WEIGHTS)
    _assert_same_config(photobench.make_config(photobench.parse_args(argv), weight),
                        jax_cfgs[weight])


@pytest.mark.parametrize("argv, box_coarse, weight", [
    (["--residual-coarse"], False, 0.0), (["--photometric"], True, 1.0),
])
def test_profile_switches_are_the_ports(argv, box_coarse, weight, monkeypatch):
    """The port's switches change only their fields of the JAX script's
    config."""
    port = profile.make_config(profile.parse_args(argv))
    want = dataclasses.replace(profile.make_config(profile.parse_args([])),
                               kernel_box_coarse=box_coarse, photometric_weight=weight)
    assert port == want


# --- each entry point on the CPU -------------------------------------------

def _run(module, argv, tmp_path, monkeypatch, capsys):
    """``module.main(argv + --out)`` from an empty directory; returns what it
    printed and the JSON it wrote, after checking that it wrote nothing
    else and left the JAX scripts' output files as they were."""
    before = {name: (REPO / name).read_bytes() for name in JAX_OUTPUTS
              if (REPO / name).exists()}
    work = tmp_path / "cwd"
    work.mkdir()
    monkeypatch.chdir(work)
    out = tmp_path / "report.json"
    returned = module.main(argv + ["--out", str(out)])
    printed = capsys.readouterr().out
    assert sorted(os.listdir(work)) == []
    for name in JAX_OUTPUTS:
        assert (REPO / name).exists() == (name in before), name
        if name in before:
            assert (REPO / name).read_bytes() == before[name], name
    report = json.loads(out.read_text())
    assert report["card"] == bench_common.CPU_LABEL
    assert set(report) == set(returned)
    return printed, report


@pytest.mark.parametrize("frames", [1, 2])
def test_steptime_runs_on_the_cpu(frames, tmp_path, monkeypatch, capsys):
    argv = SMALL + ["--rays", "8", "--samples", "4", "--chunk", "2", "--repeats", "2",
                    "--frames", str(frames)]
    printed, report = _run(steptime, argv, tmp_path, monkeypatch, capsys)
    line = re.search(rf"frames={frames}  warmup ([\d.]+) \([\d.]+-[\d.]+\) ms/step  "
                     r"post-warmup ([\d.]+) \([\d.]+-[\d.]+\) ms/step  batch-estimate "
                     r"([\d.]+) s  per-frame ([\d.]+) s  on cpu \(no device metric\)", printed)
    assert line, printed
    for phase in ("warmup", "residual"):
        times = report["ms_per_step"][phase]
        assert len(times["samples"]) == 2
        assert times["min"] <= times["median"] <= times["max"]
    assert report["per_frame_s"] == pytest.approx(report["batch_estimate_s"] / frames)


@pytest.mark.parametrize("rdf", [True, False])
def test_kernelbench_runs_on_the_cpu(rdf, tmp_path, monkeypatch, capsys):
    argv = ["--device", "cpu", "--points", "256", "--instances", "2", "--reps", "1"]
    printed, report = _run(kernelbench, argv + ([] if rdf else ["--no-rdf"]), tmp_path,
                           monkeypatch, capsys)
    assert re.search(rf"P=256 N=2 rdf={rdf} precision=default: fwd [\d.]+ ms  fwd\+bwd "
                     r"[\d.]+ ms  bwd -?[\d.]+ ms", printed), printed
    assert report["timer"] == "host clock (cpu)"
    assert np.isfinite([report["fwd_ms"], report["fwd_bwd_ms"]]).all()


@pytest.mark.parametrize("draws", [bench_common.KERNELBENCH_DRAWS,
                                   bench_common.ROOFLINE_DRAWS])
def test_script_inputs_are_the_jax_scripts_draws(draws):
    """The JAX scripts' draws, each in its script's order (kernelbench:
    positions, locations, half sizes, field weights; roofline: weights
    first, positions last)."""
    x = bench_common.script_inputs(64, 3, True, "cpu", draws)
    rng = np.random.default_rng(0)
    draw = {"pos": lambda: rng.normal(size=(64, 3)) * 20,
            "loc": lambda: rng.normal(size=(3, 3)) * 10,
            "half": lambda: rng.uniform(0.5, 2.0, size=(3, 3)),
            "weights": lambda: rng.normal(size=(3, 1617)) * 0.3}
    for name in draws:
        np.testing.assert_allclose(x[name].numpy(), draw[name](), rtol=1e-6, err_msg=name)
    np.testing.assert_array_equal(x["rot"].numpy(), np.broadcast_to(np.eye(3), (3, 3, 3)))
    assert x["valid"].tolist() == [1.0] * 3 and float(x["tau"]) == 0.5
    assert bench_common.script_inputs(64, 3, False, "cpu", draws)["weights"] is None


def test_roofline_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    argv = ["--device", "cpu", "--points", "512", "--instances", "2", "--reps", "1"]
    printed, report = _run(roofline, argv, tmp_path, monkeypatch, capsys)
    assert json.loads(printed) == report
    for key in ("counts", "assumptions", "bounds_ms", "binding_unit",
                "fraction_of_binding_bound"):
        assert key in report, key
    assert report["measured_ms"] == "not measured"
    assert report["fraction_of_binding_bound"] == "not measured"
    assert report["counts_per_point_instance"]["tensor_macs"] == 2 * MLP_MACS
    assert report["binding_unit"] == max(roofline.BINDING_UNITS, key=report["bounds_ms"].get)
    assert report["assumptions"]["sfu_results_per_s"] == 16 * 132 * 1980e6


def test_photobench_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    argv = ["--device", "cpu", "--views", "3", "--height", "48", "--width", "64",
            "--instances", "2", "--chunk", "2", "--rays", "16", "--samples", "6",
            "--surface-rays", "16", "--surface-iterations", "24", "--repeats", "1"]
    printed, report = _run(photobench, argv, tmp_path, monkeypatch, capsys)
    summary = json.loads(printed.strip().splitlines()[-1])
    assert set(summary) == {"photobench", "overhead_s_per_frame", "card"}
    results = report["results"]
    assert set(results) == {"w0", "w1"}
    assert results["w0"]["warmup_ms_per_step"] == results["w1"]["warmup_ms_per_step"]
    assert results["w0"]["photometric_loss_last"] == 0.0
    assert results["w1"]["photometric_loss_last"] > 0.0
    assert report["photometric_overhead_s_per_frame"] == pytest.approx(
        results["w1"]["s_per_frame_3000"] - results["w0"]["s_per_frame_3000"])


@pytest.mark.parametrize("phase, switches", [
    ("warmup", []), ("post", []),
    ("post", ["--frames", "2", "--photometric", "--residual-coarse"]),
])
def test_profile_runs_on_the_cpu(phase, switches, tmp_path, monkeypatch, capsys):
    argv = SMALL + ["--phase", phase, "--rays", "8", "--samples", "4", "--steps", "2",
                    "--top", "5"] + switches
    frames = 2 if switches else 1
    printed, report = _run(profile, argv, tmp_path, monkeypatch, capsys)
    assert re.search(rf"{phase} chunk, F={frames}: [\d.]+ ms/step wall \([\d.]+ per "
                     r"frame-step\) on cpu", printed), printed
    assert report["device_ms_per_step"] == "not measured"
    assert report["wall_ms_per_frame_step"] == pytest.approx(
        report["wall_ms_per_step"] / frames)
    assert 0 < len(report["host_ms_per_step_by_op"]) <= 5
    by_stage = report["host_ms_per_step_by_stage"]
    assert set(by_stage) == {*spans.STAGES, spans.STEP}
    assert all(ms > 0 for ms in by_stage.values())
    # the chunk's copy of its scalars is a report outside every step
    inside = sum(by_stage[stage] for stage in spans.STAGES) - by_stage["vsrd.report"]
    assert inside < by_stage[spans.STEP]


def test_profile_writes_its_trace(tmp_path, monkeypatch, capsys):
    """``--trace-dir``: the profiled chunk as a Chrome trace, its path
    printed and reported, the field wrappers' calls named in it."""
    trace_dir = tmp_path / "trace"
    argv = SMALL + ["--phase", "warmup", "--rays", "8", "--samples", "4", "--steps", "2",
                    "--trace-dir", str(trace_dir)]
    printed, report = _run(profile, argv, tmp_path, monkeypatch, capsys)
    path = trace_dir / "trace.json"
    assert report["trace"] == str(path)
    assert f"trace: {path}" in printed
    names = {event.get("name") for event in json.loads(path.read_text())["traceEvents"]}
    for wrapper in ("field_kernels.fused_field_with_grad",
                    "field_kernels.fused_field_dir_forward"):
        assert wrapper in names, wrapper


def test_profile_groups_kernels_by_name_and_category():
    key = "void vsrd::rev_forward_kernel<true, 384>(int, float const*)"
    assert profile.kernel_name(key) == "vsrd::rev_forward_kernel"
    assert profile.kernel_name("void at::native::(anonymous namespace)::cat_kernel<float>(int)"
                               ) == "at::native::cat_kernel"
    assert profile.category(profile.kernel_name(key)) == "field kernels"
    assert profile.category("vsrd::jv_assignment_kernel") == "jv"
    assert profile.category("vsrd::march_kernel") == "sphere trace"
    assert profile.category("sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n") == "gemm"
    assert profile.category("Memcpy HtoD (Pageable -> Device)") == "memcpy/memset"
    assert profile.category("at::native::vectorized_elementwise_kernel") == "elementwise/reduce"


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for module in (steptime, kernelbench, roofline, photobench, profile):
        assert module.parse_args([]).device == "cuda"
        with pytest.raises(SystemExit, match="no CUDA device"):
            module.main([])


# --- roofline.count_ops ------------------------------------------------------

@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("kind", ["K1", "K3"])
def test_count_ops_reads_the_mlp_and_one_sweep_or_tangent(kind, precision):
    n = 3
    counts = roofline.count_ops(roofline.twin(kind, True, precision),
                                bench_common.field_inputs(roofline.TILE, n, n, device="cpu"))
    assert counts.tensor_macs == 2 * MLP_MACS * roofline.TILE * n
    assert counts.f32_ops > 0 and counts.transcendentals > 0


@pytest.mark.parametrize("kind", ["K1", "K2", "K3"])
def test_count_ops_box_only_has_no_products_and_one_count(kind):
    counts = {p: roofline.count_ops(roofline.twin(kind, False, p), bench_common.field_inputs(roofline.TILE, 2, 2, device="cpu"))
              for p in ("default", "highest")}
    assert counts["default"] == counts["highest"]
    assert counts["default"].tensor_macs == 0 and counts["default"].f32_ops > 0


def test_count_ops_k2_counts_the_forward_and_both_reverses():
    """K2's cotangents from scratch: the value and its sweep (K1's work),
    then the reverse of both, each with respect to the activations and the
    weights: 6 x 1,552 per point and instance, at both precisions (the
    biases' gradients are sums, counted as f32 operations)."""
    for precision in ("default", "highest"):
        counts = roofline.count_ops(roofline.twin("K2", True, precision),
                                    bench_common.field_inputs(roofline.TILE, 2, 2, device="cpu"))
        assert counts.tensor_macs == 6 * MLP_MACS * roofline.TILE * 2, precision


def test_count_ops_rules_for_trivial_and_unread_products():
    ones = torch.ones(4, 1)
    a = torch.cat([torch.randn(4, 3), ones], dim=1)          # a bias column of ones
    b = torch.randn(4, 5)
    assert roofline.count_ops(lambda: a @ b).tensor_macs == 4 * 3 * 5
    assert roofline.count_ops(lambda: a @ b).f32_ops == 4 * 1 * 5
    zeros = torch.cat([torch.randn(4, 3), torch.zeros(4, 1)], dim=1)
    assert roofline.count_ops(lambda: zeros @ b) == (4 * 3 * 5, 0, 0)
    # only 2 of the product's 5 output columns are read
    assert roofline.count_ops(lambda: (a @ b)[:, :2].exp()).tensor_macs == 4 * 3 * 2


def test_count_ops_is_linear_in_points_and_instances():
    def count(points, n):
        return roofline.count_ops(roofline.twin("K1", True, "default"),
                                  bench_common.field_inputs(points, n, n, device="cpu"))

    base, double_p = count(128, 2), count(256, 2)
    by_n = [count(128, n) for n in (2, 3, 4)]
    assert double_p.tensor_macs == 2 * base.tensor_macs
    assert by_n[1].tensor_macs == 1.5 * by_n[0].tensor_macs
    # the f32 and transcendental counts: per point-instance and per point
    # work, plus a few per-instance and per-call operations on [N] tensors
    for field in ("f32_ops", "transcendentals"):
        assert getattr(double_p, field) == pytest.approx(2 * getattr(base, field), rel=1e-3)
        values = [getattr(c, field) for c in by_n]
        assert values[2] - values[1] == values[1] - values[0], field
    work = roofline.kernel_work("K1", 1000, 2)
    assert roofline.kernel_work("K1", 2000, 2)["tensor_macs"] == 2 * work["tensor_macs"]
    assert work["tensor_macs"] == 2 * MLP_MACS * 1000 * 2


def test_kernel_work_pairs_and_bounds():
    work = roofline.kernel_work("K2", 1000, 8, pairs=6000, precision="highest")
    assert work["tensor_macs"] == 6 * MLP_MACS * 6000
    assert work["bytes"] == roofline.call_bytes("K2", 1000, 8)
    model = roofline.hopper_model("cpu")
    bounds = roofline.bounds_ms(work, "highest", model)
    assert bounds["tensor"] == pytest.approx(2 * work["tensor_macs"] / (495e12 / 3) * 1e3)
    assert bounds["hbm"] == pytest.approx(work["bytes"] / 3.35e12 * 1e3)
    default = roofline.bounds_ms(work, "default", model)
    assert default["tensor"] == pytest.approx(2 * work["tensor_macs"] / 989e12 * 1e3)
    unit = max(roofline.BINDING_UNITS, key=bounds.get)
    assert roofline.binding(bounds) == (unit, bounds[unit])


@pytest.mark.parametrize("kind", ["K1", "K2", "K3"])
def test_tile_counts_count_each_function_once(kind):
    """The f32 count is the strict twin's at both precisions (the default
    twin's differentiable rounding adds none); the multiply-adds and the
    transcendentals are the twin's at the call's precision, and the
    default's fast encoding has fewer transcendentals."""
    strict = roofline.twin_counts(kind, 2, True, "highest")
    default = roofline.twin_counts(kind, 2, True, "default")
    counts = {p: roofline.tile_counts(kind, 2, True, p) for p in ("default", "highest")}
    assert counts["highest"] == strict
    assert counts["default"] == (default.tensor_macs, strict.f32_ops, default.transcendentals)
    assert counts["default"].tensor_macs == strict.tensor_macs
    assert counts["default"].transcendentals < strict.transcendentals


def test_scripts_import_neither_jax_nor_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|vsrd_tpu)\b", re.MULTILINE)
    files = sorted(SCRIPTS.glob("*.py"))
    assert len(files) >= 8
    for path in files:
        assert not pattern.search(path.read_text()), path
