"""The port's pseudo-label tools (``vsrd_tpu_torch/tools/kitti_360``) against
the JAX package's (``tools/kitti_360``) on one synthetic KITTI-360 tree (the
one of ``tests/test_tools_e2e.py``), each pair run on its own copy of it:

* ``sample_annotations``: the same split files, line for line;
* ``make_predictions`` on the same labeling checkpoints: the same JSON files,
  boxes within 1e-5 m (both decode the boxes in f32, each its own way),
  equal 2D boxes within 1e-4 px and equal confidences within 1e-6 (group
  means of 2D IoUs of those boxes);
* ``convert_predictions`` on the same prediction JSONs: the same KITTI txt
  byte for byte; and on each chain's own JSONs, the same lines within 1e-5.
"""

import glob
import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch

from vsrd_tpu_torch.models import box_parameters
from vsrd_tpu_torch.tools.kitti_360 import convert_predictions as tconvert
from vsrd_tpu_torch.tools.kitti_360 import make_predictions as tmake
from vsrd_tpu_torch.tools.kitti_360 import sample_annotations as tsample
from vsrd_tpu_torch.utils.saver import Saver

cv2 = pytest.importorskip("cv2")
import test_tools_e2e as e2e  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
SPLIT = "R50-N2-M8-B2"


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", "kitti_360", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _files(root, sub):
    base = os.path.join(root, sub)
    return sorted(os.path.relpath(p, base)
                  for p in glob.glob(os.path.join(base, "**", "*.*"), recursive=True))


def _read(path, root):
    with open(path) as file:
        return file.read().replace(root, "<root>")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Two copies of the tree: the JAX tools' and the port's."""
    jax_root = str(tmp_path_factory.mktemp("tools_jax"))
    e2e._make_synthetic_kitti360(jax_root)
    port_root = str(tmp_path_factory.mktemp("tools_port"))
    shutil.rmtree(port_root)
    shutil.copytree(jax_root, port_root)
    return jax_root, port_root


def _sample(module, root):
    module.sample_annotations(e2e.SEQUENCE, root, ["car"], 0.5, 2, 8, 2)


def test_sample_annotations_writes_the_jax_split(trees):
    jax_root, port_root = trees
    _sample(_jax_tool("sample_annotations"), jax_root)
    _sample(tsample, port_root)
    files = _files(jax_root, "filenames")
    assert files and files == _files(port_root, "filenames")
    for name in files:
        assert (_read(os.path.join(port_root, "filenames", name), port_root)
                == _read(os.path.join(jax_root, "filenames", name), jax_root)), name


def _write_checkpoints(root, ckpt_dirname):
    """A labeling checkpoint per sampled target: random boxes for 3
    instances, the last one padding."""
    sampled = os.path.join(root, "filenames", SPLIT, e2e.SEQUENCE, "sampled_image_filenames.txt")
    generator = torch.Generator().manual_seed(0)
    count = 0
    with open(sampled) as file:
        for line in map(str.strip, file):
            target = line.split(" ")[1]
            params = box_parameters.init_box_parameters(generator, 1, 3, 8)
            params["locations"] = torch.randn(1, 3, 3, generator=generator) * 0.3
            params["dimensions"] = torch.randn(1, 3, 3, generator=generator)
            params["orientations"] = torch.randn(1, 3, 2, generator=generator)
            dirname = os.path.splitext(os.path.relpath(target, root))[0]
            Saver(os.path.join(ckpt_dirname, e2e.SEQUENCE, dirname)).save(
                "step_19", step=np.asarray(19),
                models={"detector": {k: v.numpy() for k, v in params.items()}},
                valid=np.asarray([True, True, False]))
            count += 1
    return count


def _predict(module, root):
    module.make_predictions(e2e.SEQUENCE, root, os.path.join(root, "ckpts", "vsrd"),
                            "step_19.npz", SPLIT, ["car"])


def _convert(module, root):
    module.convert_predictions(e2e.SEQUENCE, root, os.path.join(root, "ckpts", "vsrd"), ["car"])


def _labels(root):
    return {name: _read(os.path.join(root, "labels", name), root)
            for name in _files(root, "labels")}


def test_make_and_convert_predictions_write_the_jax_files(trees):
    jax_root, port_root = trees
    for root in trees:
        if not os.path.exists(os.path.join(root, "filenames", SPLIT)):
            _sample(tsample, root)
        assert _write_checkpoints(root, os.path.join(root, "ckpts", "vsrd")) >= 1
    _predict(_jax_tool("make_predictions"), jax_root)
    _predict(tmake, port_root)
    files = _files(jax_root, "predictions")
    assert files and files == _files(port_root, "predictions")
    for name in files:
        with open(os.path.join(jax_root, "predictions", name)) as file:
            want = json.load(file)
        with open(os.path.join(port_root, "predictions", name)) as file:
            got = json.load(file)
        assert set(got) == set(want) == {"boxes_3d", "boxes_2d", "confidences"}
        assert np.asarray(got["boxes_3d"]["car"]).shape == (2, 8, 3)
        np.testing.assert_allclose(got["boxes_3d"]["car"], want["boxes_3d"]["car"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got["boxes_2d"]["car"], want["boxes_2d"]["car"], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(got["confidences"]["car"], want["confidences"]["car"],
                                   rtol=0, atol=1e-6)

    # each chain's own JSONs: the same txt lines within 1e-5
    jax_convert = _jax_tool("convert_predictions")
    _convert(jax_convert, jax_root)
    _convert(tconvert, port_root)
    want, got = _labels(jax_root), _labels(port_root)
    assert want and set(got) == set(want)
    for name, text in want.items():
        for line_got, line_want in zip(got[name].splitlines(), text.splitlines(), strict=True):
            a, b = line_got.split(" "), line_want.split(" ")
            assert a[0] == b[0] and len(a) == len(b) == 16
            np.testing.assert_allclose(np.asarray(a[1:], float), np.asarray(b[1:], float),
                                       rtol=0, atol=1e-5)

    # the same JSONs: the same txt byte for byte
    shutil.rmtree(os.path.join(port_root, "predictions"))
    shutil.copytree(os.path.join(jax_root, "predictions"), os.path.join(port_root, "predictions"))
    shutil.rmtree(os.path.join(port_root, "labels"))
    _convert(tconvert, port_root)
    assert _labels(port_root) == want
