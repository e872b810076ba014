"""The port's detector training (``vsrd_tpu_torch/pipeline/detector_training.py``
and ``python -m vsrd_tpu_torch.scripts.train_detector``) against the JAX
package's (``vsrd_tpu/pipeline/detector_training.py``,
``scripts/train_detector.py``):

* ``load_example`` on synthetic PNGs (RGB and grey) gives the JAX CLI's
  example exactly, images byte for byte after the x255: the port decodes
  without PIL and resizes with ``transforms.resize_pil_bilinear``, which is
  held to PIL's ``BILINEAR`` byte for byte at 376x1408 -> 192x704 (both
  axes shrink, where PIL's filter widens) and at small odd sizes;
* one data-parallel step on two gloo processes (DistributedDataParallel,
  the matched-box count averaged over processes) against the JAX step on a
  two-device ``dp`` mesh from the same weights and global batch: the loss
  within 1e-5 and the parameters within 1e-6 relative where Adam's step
  does not amplify rounding (see the test). The weights are the
  flax initialization perturbed, so that no two queries' costs lie within
  rounding of each other and both packages' JV pick the same assignment
  (the ties at initialization are held by ``test_torch_detr3d.py``);
* a few CPU steps of the CLI on a tiny tree, its eval line with the KITTI
  AP|R40 keys, and its checkpoint, which the JAX ``load_checkpoint`` reads
  and the flax model runs to the port model's outputs (1e-5 relative).
"""

import glob
import importlib.util
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from vsrd_tpu.models import detr3d as jdetr
from vsrd_tpu.pipeline import detector_training as jdt
from vsrd_tpu.utils import saver as jsaver
from vsrd_tpu_torch.data import transforms
from vsrd_tpu_torch.models import detr3d as tdetr
from vsrd_tpu_torch.scripts import train_detector as ttrain
from vsrd_tpu_torch.utils import convert

Image = pytest.importorskip("PIL.Image")
import test_tools_e2e as e2e  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.join(os.path.dirname(__file__), "..")
SMALL = dict(num_queries=8, hidden_dim=32, num_encoder_layers=1, num_decoder_layers=1,
             num_heads=4)
LOSS_TOL, STEP_TOL = 1e-5, 1e-6


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_train_detector", os.path.join(REPO, "scripts", "train_detector.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("src, dst", [((376, 1408), (192, 704)), ((13, 17), (5, 7)),
                                      ((9, 11), (23, 31))])
def test_resize_pil_bilinear_is_pil_byte_for_byte(src, dst):
    rng = np.random.default_rng(src[0])
    for shape in (src + (3,), src):
        pixels = (rng.random(shape) * 255).astype(np.uint8)
        want = np.asarray(Image.fromarray(pixels).resize(dst[::-1], Image.BILINEAR))
        got = transforms.resize_pil_bilinear(pixels, dst)
        assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("mode, src, size", [("RGB", (376, 1408), (192, 704)),
                                             ("L", (21, 33), (11, 15))])
def test_load_example_equals_the_jax_cli(tmp_path, mode, src, size):
    rng = np.random.default_rng(5)
    shape = src + ((3,) if mode == "RGB" else ())
    image = tmp_path / "0000000000.png"
    Image.fromarray((rng.random(shape) * 255).astype(np.uint8), mode).save(image)
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps({"intrinsic_matrix": [[552.5, 0, 682.0], [0, 552.5, 238.7],
                                                    [0, 0, 1]]}))
    pred = tmp_path / "pred.json"
    boxes_2d = [[[-15.0, -4.0], [75.0, 44.0]], [[10.0, 5.0], [20.0, 30.0]],
                [[1.0, 2.0], [3.0, 4.0]]]
    pred.write_text(json.dumps({
        "boxes_3d": {"car": rng.normal(size=(3, 8, 3)).tolist()},
        "boxes_2d": {"car": boxes_2d},
        "confidences": {"car": [0.9, 0.2, 0.7]},
    }))
    paths = (str(image), str(pred), str(ann))
    want = _jax_cli().load_example(paths, size, 4, ["car"], 0.5)
    got = ttrain.load_example(paths, size, 4, ["car"], 0.5)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key
    assert got["valid"].tolist() == [True, True, False, False]


WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from vsrd_tpu_torch.models import detr3d
from vsrd_tpu_torch.pipeline import detector_training as dt
from vsrd_tpu_torch.utils import convert

torch.set_num_threads(1)
rank, port, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
data = np.load(path + "/inputs.npz")
model = detr3d.make_detector(device="cpu", **{k: int(v) for k, v in np.load(path + "/small.npz").items()})
state = {k[6:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("state/")}
model.load_state_dict(state)
model, optimizer = dt.create_train_state(model, 1e-4, device="cpu")
assert isinstance(model, torch.nn.parallel.DistributedDataParallel)
step = dt.make_train_step(model, optimizer)
half = slice(2 * rank, 2 * rank + 2)
batch = {k[6:]: torch.from_numpy(data[k][half]) for k in data.files if k.startswith("batch/")}
loss, aux = step(batch)
if rank == 0:
    out = {"loss": loss.numpy(), **{"aux/" + k: v.numpy() for k, v in aux.items()}}
    out.update({"state/" + k: v.numpy() for k, v in dt.unwrap(model).state_dict().items()})
    np.savez(path + "/outputs.npz", **out)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_take_the_jax_two_device_step(tmp_path):
    if len(jax.devices()) < 2:
        pytest.skip("needs two JAX devices (tests/conftest.py gives eight)")
    rng = np.random.default_rng(0)
    b, n, hw = 4, 3, (32, 48)
    k = np.asarray([[50.0, 0, 24.0], [0, 50.0, 16.0], [0, 0, 1.0]], np.float32)
    corner = rng.uniform(0.1, 0.5, size=(b, n, 2)).astype(np.float32)
    batch = dict(
        images=rng.random((b, *hw, 3)).astype(np.float32),
        intrinsics=np.broadcast_to(k, (b, 3, 3)).copy(),
        labels=np.zeros((b, n), np.int32),
        boxes_2d=np.concatenate([corner, corner + 0.2], axis=-1),
        boxes_3d=(rng.normal(size=(b, n, 8, 3)) + 5.0).astype(np.float32),
        # 2 targets in the first process's images, 5 in the second's: the
        # box losses are normalized by the mean count, 3.5, not each own
        valid=np.asarray([[True, False, False], [True, False, False],
                          [True, True, True], [True, True, False]]))
    model = jdetr.DETR3D(**SMALL)
    params, tx, opt_state = jdt.create_train_state(jax.random.PRNGKey(0), model, hw)
    params = jax.device_get(params)
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: (np.asarray(p) + rng.normal(
            scale=1.0 if "query_embeddings" in str(path) else 0.05, size=p.shape)
        ).astype(np.float32), params)
    opt_state = tx.init(params)
    mesh = jdt.make_dp_mesh(jax.devices()[:2])
    step = jdt.make_dp_train_step(model, tx, mesh)
    new_params, _, loss, aux = step(params, opt_state, jdt.shard_batch(batch, mesh))

    state = convert.detector_params_from_jax(params, "cpu")
    np.savez(tmp_path / "inputs.npz", **{"state/" + k: v.numpy() for k, v in state.items()},
             **{"batch/" + k: v for k, v in batch.items()})
    np.savez(tmp_path / "small.npz", **SMALL)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(port), str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for proc in procs:
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
    out = np.load(tmp_path / "outputs.npz")
    assert abs(float(out["loss"]) - float(loss)) <= LOSS_TOL * abs(float(loss))
    for key, value in aux.items():
        assert abs(float(out["aux/" + key]) - float(value)) <= LOSS_TOL * max(abs(float(value)),
                                                                              1e-6), key
    assert float(out["aux/num_boxes"]) == 3.5
    # Adam's first step moves each parameter by lr g / (|g| + eps): where |g|
    # is well above eps (the direction saturates, |adam| > 0.99) it does not
    # feel rounding, and the parameters agree to STEP_TOL; where |g| is
    # within ~100 eps of 0 it amplifies the rounding of g itself, and the
    # two may differ by up to the step, 2 lr
    want = convert.detector_params_from_jax(jax.device_get(new_params), "cpu")
    lr, wd = 1e-4, 1e-4
    saturated = 0
    for name, value in want.items():
        got, value, before = out["state/" + name], value.numpy(), state[name].numpy()
        adam = (before - value) / lr - wd * before
        sure = np.abs(adam) > 0.99
        saturated += int(sure.sum())
        scale = float(np.abs(value).max())
        diff = np.abs(got - value)
        assert float(diff[sure].max(initial=0.0)) <= STEP_TOL * scale, name
        assert float(diff.max()) <= 2 * lr, name
    assert saturated > 0.95 * sum(v.numel() for v in want.values())


def _pseudo_labelled_tree(root):
    """The e2e tree with a pseudo-label JSON per frame (camera-space
    corners, pixel 2D boxes), as make_predictions writes them."""
    e2e._make_synthetic_kitti360(root)
    ann_dir = os.path.join(root, "annotations", e2e.SEQUENCE, "image_00", "data_rect")
    pred_dir = os.path.join(root, "predictions", "vsrd", e2e.SEQUENCE, "image_00", "data_rect")
    os.makedirs(pred_dir)
    for ann_path in sorted(glob.glob(os.path.join(ann_dir, "*.json"))):
        with open(ann_path) as f:
            ann = json.load(f)
        k = np.asarray(ann["intrinsic_matrix"])
        boxes_3d, boxes_2d = [], []
        for corners in ann["boxes_3d"]["car"].values():
            pix = np.asarray(corners) @ k.T
            pix = pix[:, :2] / pix[:, 2:]
            boxes_3d.append(corners)
            boxes_2d.append([[*pix.min(axis=0)], [*pix.max(axis=0)]])
        with open(os.path.join(pred_dir, os.path.basename(ann_path)), "w") as f:
            json.dump({"boxes_3d": {"car": boxes_3d}, "boxes_2d": {"car": boxes_2d},
                       "confidences": {"car": [0.9] * len(boxes_3d)}}, f)


@pytest.mark.parametrize("deformable", [False, True], ids=["detr3d", "deformable"])
def test_cli_trains_on_the_cpu_and_its_checkpoint_runs_in_flax(tmp_path, capsys, deformable):
    root = str(tmp_path / "kitti")
    _pseudo_labelled_tree(root)
    out_dir = str(tmp_path / "detr_ckpt")
    argv = ["--root_dirname", root, "--ckpt_dirname", "ckpts/vsrd", "--out_dirname", out_dir,
            "--num_steps", "3", "--batch_size", "2", "--height", "48", "--width", "64",
            "--max_boxes", "4", "--log_intervals", "1", "--eval_intervals", "3",
            "--holdout_fraction", "0", "--confidence_threshold", "0.0", "--device", "cpu",
            *[f"--{k}={v}" for k, v in SMALL.items()]] + (["--deformable"] if deformable else [])
    history = ttrain.main(argv)
    stdout = capsys.readouterr().out
    assert len(history["losses"]) == 3 and np.isfinite(history["losses"]).all()
    assert sum(line.startswith("step ") and " loss=" in line for line in stdout.splitlines()) == 3
    eval_line = [line for line in stdout.splitlines() if line.startswith("eval step 3:")]
    assert eval_line
    for key in ("ap_r40_0.25", "ap_r40_0.5_easy", "ap_r40_0.5_moderate", "ap_r40_0.5_hard",
                "mean_matched_iou_3d"):
        assert f"{key}=" in eval_line[0], key

    path = os.path.join(out_dir, "step_2.npz")
    assert history["checkpoint"] == path
    ckpt = jsaver.load_checkpoint(path)
    assert set(ckpt) == {"step", "models", "config"} and int(ckpt["step"]) == 2
    assert str(ckpt["config"]["model"]) == ("DeformableDETR3D" if deformable else "DETR3D")
    kwargs = {**SMALL, **({"num_samples": 8} if deformable else {})}
    jmodel = (jdetr.DeformableDETR3D if deformable else jdetr.DETR3D)(**kwargs)
    flax_tree = ckpt["models"]["detector"]
    images = np.random.default_rng(0).random((1, 48, 64, 3)).astype(np.float32)
    k = np.asarray([[40.0, 0, 32], [0, 40.0, 24], [0, 0, 1]], np.float32)[None]
    want = jmodel.apply(flax_tree, images, k)
    port = tdetr.make_detector("deformable" if deformable else "detr3d", device="cpu", **kwargs)
    port.load_state_dict(convert.detector_params_from_jax(flax_tree, "cpu"))
    with torch.no_grad():
        got = port(torch.from_numpy(images), torch.from_numpy(k))
    for key in ("logits", "boxes_2d", "boxes_3d"):
        w = np.asarray(want[key])
        assert np.abs(got[key].numpy() - w).max() <= LOSS_TOL * np.abs(w).max(), key


def test_cli_trains_the_published_detr_on_the_cpu(tmp_path, capsys):
    """``--arch detr-r50``: the published model (ResNet-50 at its widths, a cut
    transformer here) through the normal CLI path, with its two learning
    rates and the clip; its checkpoint holds the port's state_dict, which
    loads back into the model."""
    root = str(tmp_path / "kitti")
    _pseudo_labelled_tree(root)
    out_dir = str(tmp_path / "detr_ckpt")
    argv = ["--root_dirname", root, "--ckpt_dirname", "ckpts/vsrd", "--out_dirname", out_dir,
            "--num_steps", "2", "--batch_size", "2", "--height", "48", "--width", "64",
            "--max_boxes", "4", "--log_intervals", "1", "--eval_intervals", "2",
            "--holdout_fraction", "0", "--confidence_threshold", "0.0", "--device", "cpu",
            "--arch", "detr-r50", "--num_queries", "8", "--num_encoder_layers", "1",
            "--num_decoder_layers", "1"]
    history = ttrain.main(argv)
    stdout = capsys.readouterr().out
    assert len(history["losses"]) == 2 and np.isfinite(history["losses"]).all()
    assert any(line.startswith("eval step 2:") for line in stdout.splitlines())
    ckpt = jsaver.load_checkpoint(history["checkpoint"])
    assert str(ckpt["config"]["model"]) == "PublishedDETR3D"
    assert int(ckpt["config"]["hidden_dim"]) == 256 and int(ckpt["config"]["num_heads"]) == 8
    state = ckpt["models"]["detector"]
    model = tdetr.make_detector(arch="detr-r50", device="cpu", num_queries=8,
                                num_encoder_layers=1, num_decoder_layers=1)
    assert set(state) == set(model.state_dict())
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()})
    images = torch.rand(1, 48, 64, 3)
    k = torch.tensor([[[40.0, 0, 32], [0, 40.0, 24], [0, 0, 1]]])
    with torch.no_grad():
        assert torch.isfinite(model(images, k)["boxes_3d"]).all()
    # --deformable is --arch deformable, with the JAX CLI's widths
    args = ttrain.parse_args(argv[:-8] + ["--deformable"])
    assert args.arch == "deformable" and args.num_queries == 50
