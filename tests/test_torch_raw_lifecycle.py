"""The raw KITTI-360 lifecycle in the port, against the JAX package's tools:
the port's twin of ``tests/test_make_annotations_e2e.py`` on the same 48x64
raw tree (perspective.txt, cam0_to_world.txt, the 3D box XML in annotation
corner order with static boxes, 16-bit instance PNGs).

* ``make_annotations`` (the port's CLI, with its worker pool) against the
  JAX tool on copies of the tree: the same files, RLE strings equal, the
  numbers within 1e-12; then the JAX test's three checks on the port's
  output (intrinsics and pose, masks, the corner reorder).
* ``sample_annotations`` -> the labeling driver on the CPU for 6 steps ->
  ``make_predictions`` -> both visualizers, whose PNG pixels equal the JAX
  tools' on the same inputs (and without cv2, the PNGs and one line saying
  why no video was written) -> ``select_model``, which picks the checkpoint
  the JAX tool picks, its ``model.npz`` equal byte for byte.
* ``configure --gather``, ``--scatter``, ``--gather`` on copies of
  ``configs/kitti_360`` against the JAX CLI (the same JSON files, back at the
  start at the end), and the restore of the tree after a failure injected
  into the rewrite.
"""

import glob
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import types

import cv2
import numpy as np
import pytest
import torch

from vsrd_tpu.configuration import configure as jconfigure
from vsrd_tpu_torch.configuration import configure as tconfigure
from vsrd_tpu_torch.configuration.configurator import Configurator
from vsrd_tpu_torch.data import png, rle
from vsrd_tpu_torch.scripts import main as tmain
from vsrd_tpu_torch.tools import select_model as tselect
from vsrd_tpu_torch.tools.kitti_360 import (
    make_predictions as tpredictions, sample_annotations as tsample,
    visualize_annotations as tvis_annotations, visualize_predictions as tvis_predictions)

import test_make_annotations_e2e as raw

torch.set_num_threads(2)
REPO = os.path.join(os.path.dirname(__file__), "..")
SPLIT = "R50-N2-M8-B2"
STEPS = 6


def _jax_tool(*parts):
    """A JAX package tool (``tools/...``, not a package) loaded in process."""
    path = os.path.join(REPO, "tools", *parts)
    spec = importlib.util.spec_from_file_location(f"jax_tool_{parts[-1][:-3]}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json_close(got, want, path=""):
    """Equal structure, key order and strings; numbers within 1e-12."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for key in want:
            _json_close(got[key], want[key], f"{path}/{key}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _json_close(a, b, f"{path}/{i}")
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-12, (path, got, want)
    else:
        assert got == want, (path, got, want)


def _annotation_files(root):
    return sorted(glob.glob(os.path.join(root, "annotations", raw.SEQUENCE, "**", "*.json"),
                            recursive=True))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The raw tree, annotated by the port's CLI (``port``) and by the JAX
    tool (``jax``)."""
    base = tmp_path_factory.mktemp("raw_lifecycle")
    port = raw._make_raw_tree(str(base / "port"))
    jax_root = str(base / "jax")
    shutil.copytree(port, jax_root)
    result = subprocess.run(
        [sys.executable, "-m", "vsrd_tpu_torch.tools.kitti_360.make_annotations",
         "--root_dirname", port, "--num_workers", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-2000:]
    assert "[1/1] done" in result.stdout
    _jax_tool("kitti_360", "make_annotations.py").make_annotations(raw.SEQUENCE, jax_root)
    return {"port": port, "jax": jax_root}


def test_make_annotations_matches_the_jax_tool(trees):
    got, want = _annotation_files(trees["port"]), _annotation_files(trees["jax"])
    assert len(got) == raw.NUM_FRAMES
    assert ([os.path.relpath(p, trees["port"]) for p in got]
            == [os.path.relpath(p, trees["jax"]) for p in want])
    for a, b in zip(got, want):
        with open(a) as file:
            text = file.read()
        with open(b) as file:
            expected = file.read()
        _json_close(json.loads(text), json.loads(expected))
        assert text.startswith('{\n    "intrinsic_matrix"')          # indent=4, as the JAX tool


def test_port_annotations_pass_the_jax_checks(trees):
    """The three checks of tests/test_make_annotations_e2e.py on the port's
    output: intrinsics and pose (frame 2), the masks (frame 0), the corner
    reorder (frame 3)."""
    files = _annotation_files(trees["port"])
    with open(files[2]) as file:
        annotation = json.load(file)
    np.testing.assert_allclose(annotation["intrinsic_matrix"], raw.K, atol=1e-9)
    expected = np.eye(4)
    expected[2, 3] = -1.0
    np.testing.assert_allclose(annotation["extrinsic_matrix"], expected, atol=1e-9)
    with open(files[0]) as file:
        masks = json.load(file)["masks"]["car"]
    assert set(masks) == {"26000", "26001"}
    instance_map = png.read_png_anydepth(
        os.path.join(trees["port"], "data_2d_semantics", "train", raw.SEQUENCE, "image_00",
                     "instance", f"{0:010}.png"))
    for instance_id, encoded in masks.items():
        mask = rle.decode(encoded)
        assert mask.shape == (raw.H, raw.W) and mask.sum() >= 8
        np.testing.assert_array_equal(mask, instance_map == int(instance_id))
    with open(files[3]) as file:
        boxes = json.load(file)["boxes_3d"]["car"]
    for instance, center in enumerate(raw.CENTERS):
        np.testing.assert_allclose(boxes[str(26000 + instance)],
                                   raw._world_eval_corners(center) - [0.0, 0.0, 1.5], atol=1e-9)


def _config(root):
    chain = [("Resizer", [[raw.H, raw.W]]), ("MaskAreaFilter", [1]), ("MaskRefiner", []),
             ("MaskAreaFilter", [8]), ("BoxGenerator", []), ("BoxSizeFilter", [2]),
             ("SoftRasterizer", [])]
    chain = [{"function": f"vsrd.transforms.{name}", "args": args} for name, args in chain]
    config = {
        "datasets": {"train": {"function": "vsrd_tpu.data.KITTI360Dataset", "kwargs": {
            "filenames": [os.path.join(root, "filenames", SPLIT, raw.SEQUENCE,
                                       "sampled_image_filenames.txt")],
            "num_source_frames": 2, "num_workers": 1,
            "target_transforms": chain, "source_transforms": chain}}},
        "optimization": {"num_steps": STEPS, "warmup_steps": 3, "frames_per_batch": 1},
        "volume_rendering": {"num_rays": 32, "num_fine_samples": 8},
        "logging": {"ckpt_intervals": 3, "scalar_intervals": 2, "image_intervals": 10000},
        "random": {"global_seed": 0, "use_unique_seed": False},
    }
    path = os.path.join(root, "configs", "vsrd", raw.SEQUENCE, "config.json")
    os.makedirs(os.path.dirname(path))
    with open(path, "w") as file:
        json.dump(config, file)
    return path


def _pixels(paths):
    return [png.read_rgb(p) for p in paths]


def test_raw_tree_to_views_and_selection(trees, tmp_path, capsys):
    root = trees["port"]
    tsample.sample_annotations(raw.SEQUENCE, root, ["car"], 0.5, 2, 8, 2)
    sampled = os.path.join(root, "filenames", SPLIT, raw.SEQUENCE, "sampled_image_filenames.txt")
    with open(sampled) as file:
        targets = [line.split() for line in file if line.strip()]
    assert targets and all(ids.split(",") == ["26000", "26001"] for ids, _, _ in targets)

    tmain.main(["--config", _config(root), "--train", "--device", "cpu"])
    ckpt_dirname = os.path.join(root, "ckpts", "vsrd")
    finals = glob.glob(os.path.join(ckpt_dirname, "**", f"step_{STEPS - 1}.npz"), recursive=True)
    assert len(finals) == len(targets)
    tpredictions.make_predictions(raw.SEQUENCE, root, ckpt_dirname, f"step_{STEPS - 1}.npz",
                                  SPLIT, ["car"])
    predictions = glob.glob(os.path.join(root, "predictions", "vsrd", raw.SEQUENCE, "**",
                                         "*.json"), recursive=True)
    assert predictions

    # both visualizers against the JAX tools on the same annotations and predictions
    jax_annotations = _jax_tool("kitti_360", "visualize_annotations.py")
    jax_predictions = _jax_tool("kitti_360", "visualize_predictions.py")
    out = {side: str(tmp_path / side) for side in ("port", "jax")}
    written = tvis_annotations.visualize_sequence(raw.SEQUENCE, root, out["port"] + "/ann",
                                                  ["car"], 2)
    jax_annotations.visualize_sequence(raw.SEQUENCE, root, out["jax"] + "/ann", ["car"], 2)
    drawn = tvis_predictions.visualize_sequence(raw.SEQUENCE, root, ckpt_dirname,
                                                out["port"] + "/pred", 2)
    jax_predictions.visualize_sequence(raw.SEQUENCE, root, ckpt_dirname, out["jax"] + "/pred", 2)
    assert len(written) == raw.NUM_FRAMES and len(drawn) == len(predictions)
    for kind, paths in (("ann", written), ("pred", drawn)):
        want = [os.path.join(out["jax"], kind, os.path.relpath(p, os.path.join(out["port"], kind)))
                for p in paths]
        for got, expected in zip(_pixels(paths), want):
            np.testing.assert_array_equal(got, cv2.imread(expected)[..., ::-1])
        assert os.path.exists(os.path.join(out["port"], kind, f"{raw.SEQUENCE}.mp4"))
    frame = png.read_rgb(written[0])
    image = png.read_rgb(os.path.join(root, "data_2d_raw", raw.SEQUENCE, "image_00", "data_rect",
                                      os.path.basename(written[0])))
    assert frame.shape == (raw.H, raw.W, 3) and (frame != image).any()

    # without cv2: the PNGs, and one line saying why there is no video
    tvis_annotations.cv2, saved = None, tvis_annotations.cv2
    try:
        capsys.readouterr()
        again = tvis_annotations.visualize_sequence(raw.SEQUENCE, root, str(tmp_path / "nocv2"),
                                                    ["car"], 2)
    finally:
        tvis_annotations.cv2 = saved
    said = capsys.readouterr().out.strip().splitlines()
    assert len(again) == raw.NUM_FRAMES and len(said) == 1 and "no video written" in said[0]
    assert not os.path.exists(str(tmp_path / "nocv2" / f"{raw.SEQUENCE}.mp4"))

    # select_model: the same choice as the JAX tool, on copies of the checkpoints
    copies = {side: str(tmp_path / f"ckpts_{side}") for side in ("port", "jax")}
    for copy in copies.values():
        shutil.copytree(ckpt_dirname, copy)
    args = dict(metric="iou_3d", maximize=True, constraints=["loss<1e9"])
    chosen = tselect.main(tselect.parse_args(["--ckpt_dirname", copies["port"],
                                              "--constraints", "loss<1e9"]))
    capsys.readouterr()
    _jax_tool("select_model.py").main(types.SimpleNamespace(ckpt_dirname=copies["jax"], **args))
    jax_said = capsys.readouterr().out
    assert f"selected {os.path.join(copies['jax'], os.path.relpath(chosen, copies['port']))} " \
        in jax_said
    with open(os.path.join(copies["port"], "model.npz"), "rb") as a, \
            open(os.path.join(copies["jax"], "model.npz"), "rb") as b:
        assert a.read() == b.read()
    # the least loss (maximize=False is not reachable from either CLI, whose
    # --maximize is store_true with default True): distinct values, one choice
    os.remove(os.path.join(copies["port"], "model.npz"))
    os.remove(os.path.join(copies["jax"], "model.npz"))
    least = dict(args, metric="loss", maximize=False)
    chosen = tselect.main(types.SimpleNamespace(ckpt_dirname=copies["port"], **least))
    capsys.readouterr()
    _jax_tool("select_model.py").main(types.SimpleNamespace(ckpt_dirname=copies["jax"], **least))
    assert f"selected {os.path.join(copies['jax'], os.path.relpath(chosen, copies['port']))} " \
        in capsys.readouterr().out
    assert tselect.main(tselect.parse_args(["--ckpt_dirname", copies["port"],
                                            "--constraints", "iou_3d>2"])) is None


def _tree_json(root):
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "**", "*.json"), recursive=True)):
        with open(path) as file:
            out[os.path.relpath(path, root)] = json.load(file)
    return out


def test_configure_matches_the_jax_cli_and_restores_on_failure(tmp_path, monkeypatch):
    source = os.path.join(REPO, "configs", "kitti_360")
    trees = {side: str(tmp_path / side / "kitti_360") for side in ("port", "jax")}
    for tree in trees.values():
        shutil.copytree(source, tree)
    start = _tree_json(trees["port"])
    # the shipped tree is gathered: gather keeps it, scatter pushes the root's
    # keys into the drives' files, gather takes them back up
    for flag, changed in (("--gather", False), ("--scatter", True), ("--gather", False)):
        with pytest.raises(SystemExit) as port_exit:
            tconfigure.main([trees["port"], flag])
        monkeypatch.setattr(sys, "argv", ["configure", trees["jax"], flag])
        with pytest.raises(SystemExit) as jax_exit:
            jconfigure.main()
        assert port_exit.value.code == jax_exit.value.code == 0
        assert _tree_json(trees["port"]) == _tree_json(trees["jax"])
        assert (_tree_json(trees["port"]) != start) == changed, flag

    def broken(root, verbose=False):
        with open(os.path.join(root, "config.json"), "w") as file:
            file.write("{half")
        raise RuntimeError("injected")

    monkeypatch.setattr(Configurator, "gather", staticmethod(broken))
    assert tconfigure.run(trees["port"], gather=True) is False
    assert _tree_json(trees["port"]) == start
