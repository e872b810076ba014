"""The port's diagnostic panels (``vsrd_tpu_torch/visualization``) against the
JAX package's (``vsrd_tpu/visualization``), which draw with OpenCV:

* the numpy rasterizers against cv2 byte for byte on a uint8 canvas: lines
  of thickness 1 to 4 (thick ones are a sub-pixel polygon with round caps,
  clipped to the image grown by the thickness), rectangles, filled circles
  and the sub-pixel convex fill, on random points inside and outside the
  image;
* the drawers against the JAX drawers on random wireframes, footprints,
  boxes, dots and masks, exactly;
* ``diagnostic_panels`` against the JAX panels on the same synthetic frame
  (4 views of 96x128, 3 of 4 instances valid) and parameters, after the
  warmup (the residual field and the sphere-traced surface mask), with the
  JAX panels' ray draw given to the port as ``ray_indices``: every panel
  equal exactly;
* the labeling driver writes the panels to TensorBoard at
  ``image_intervals``.
"""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from vsrd_tpu.ops import sampling as jsampling
from vsrd_tpu.pipeline import frame as jfm, optimize as jopt
from vsrd_tpu.visualization import drawers as jdrawers, panels as jpanels
from vsrd_tpu_torch.pipeline import frame as tfm, optimize as topt
from vsrd_tpu_torch.utils import convert
from vsrd_tpu_torch.visualization import drawers as tdrawers, panels as tpanels

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(2)
H, W = 37, 53
COLOR = (255, 128, 7)


def _points(rng, count, lo=-20, hi=80):
    return [tuple(int(v) for v in rng.integers(lo, hi, 2)) for _ in range(count)]


@pytest.mark.parametrize("thickness", [1, 2, 3, 4])
def test_lines_are_cv2_byte_for_byte(thickness):
    rng = np.random.default_rng(thickness)
    for p1, p2 in zip(_points(rng, 300), _points(rng, 300)):
        want = np.zeros((H, W, 3), np.uint8)
        cv2.line(want, p1, p2, COLOR, thickness)
        got = tdrawers.line(np.zeros((H, W, 3), np.uint8), p1, p2, COLOR, thickness)
        assert np.array_equal(got, want), (p1, p2)


@pytest.mark.parametrize("shape", ["rectangle", "circle", "fill"])
def test_rectangles_circles_and_the_subpixel_fill_are_cv2_byte_for_byte(shape):
    rng = np.random.default_rng(7)
    for _ in range(300):
        want = np.zeros((H, W, 3), np.uint8)
        got = want.copy()
        if shape == "rectangle":
            p1, p2 = _points(rng, 2)
            cv2.rectangle(want, p1, p2, COLOR, 2)
            tdrawers.rectangle(got, p1, p2, COLOR, 2)
        elif shape == "circle":
            (center,), radius = _points(rng, 1), int(rng.integers(0, 6))
            cv2.circle(want, center, radius, COLOR, -1)
            tdrawers.circle(got, center, radius, COLOR)
        else:
            q = rng.integers(-20 << 16, 80 << 16, (4, 2))
            c = q.mean(0)
            q = q[np.argsort(np.arctan2(q[:, 1] - c[1], q[:, 0] - c[0]))]   # convex
            cv2.fillConvexPoly(want, q.astype(np.int32), COLOR, cv2.LINE_8, 16)
            tdrawers._fill_convex(got, [tuple(int(v) for v in p) for p in q],
                                  np.asarray(COLOR, np.uint8))
        assert np.array_equal(got, want)


def _boxes(rng, count):
    centers = rng.uniform([-8, -1, 2], [8, 2, 30], size=(count, 1, 3))
    unit = np.asarray([[-1, -1, 1], [1, -1, 1], [1, -1, -1], [-1, -1, -1],
                       [-1, 1, 1], [1, 1, 1], [1, 1, -1], [-1, 1, -1]], np.float64)
    boxes = unit * rng.uniform(0.5, 3.0, size=(count, 1, 3)) + centers
    boxes[0, :4, 2] = -1.0                       # half behind the camera: clipped to the front
    boxes[1] = np.nan                            # skipped
    return boxes.astype(np.float32)


@pytest.mark.parametrize("canvas_dtype", [np.float32, np.uint8])
def test_drawers_equal_the_jax_drawers(canvas_dtype):
    rng = np.random.default_rng(3)
    image = rng.random((60, 80, 3)).astype(np.float32)
    if canvas_dtype == np.uint8:
        image = (image * 255).astype(np.uint8)
    k = np.asarray([[40.0, 0, 40], [0, 40.0, 30], [0, 0, 1]], np.float32)
    boxes = _boxes(rng, 6)
    boxes_2d = rng.uniform(-10, 90, size=(5, 2, 2))
    dots = rng.uniform(-5, 85, size=(40, 2))
    masks = rng.random((3, 60, 80))
    bev = np.ones((200, 200, 3), np.float32)
    lines = tdrawers.LINE_INDICES + [[0, 5], [1, 4]]
    calls = [
        ("draw_boxes_3d", (image, boxes, k), dict(line_indices=lines)),
        ("draw_boxes_3d", (image, boxes, k), dict(thickness=1, color=(0, 255, 0))),
        ("draw_boxes_bev", (bev, boxes * 3.0), {}),
        ("draw_boxes_2d", (image, boxes_2d), {}),
        ("draw_points_2d", (image, dots), {}),
        ("draw_masks", (image, masks), {}),
        ("draw_masks", (image, np.concatenate([np.zeros_like(masks[:1]), masks])), {}),
    ]
    for name, args, kwargs in calls:
        got = getattr(tdrawers, name)(*args, **kwargs)
        want = getattr(jdrawers, name)(*args, **kwargs)
        assert got.dtype == want.dtype and np.array_equal(got, want), name


def test_drawers_copy_the_jax_line_indices():
    assert tdrawers.LINE_INDICES == jdrawers.LINE_INDICES


CFG = dict(num_steps=20, warmup_steps=10, num_rays=64, num_samples=8, checkpoint_interval=20,
           surface_num_iterations=16)


def test_diagnostic_panels_equal_the_jax_panels():
    jcfg = jopt.OptimizationConfig(pallas_matmul_precision="highest", field_dtype=None, **CFG)
    tcfg = topt.OptimizationConfig(kernel_matmul_precision="highest", **CFG)
    key = jax.random.PRNGKey(0)
    kw = dict(num_views=4, image_size=(96, 128), num_instances=3, max_instances=4,
              with_images=True)
    jf = jfm.synthetic_frame(key, **kw)
    tf = tfm.synthetic_frame(int(jax.random.randint(key, (), 0, 2**31 - 1)), **kw, device="cpu")
    params = jax.device_get(jopt.init_params(jax.random.PRNGKey(1), 4, jcfg))
    step, dots = 15, jax.random.PRNGKey(7)
    # the JAX panels' own ray draw, as flat (view, y, x) pixel indices
    cand = jsampling.multinomial_logits(dots, jf.candidate_weights, jcfg.num_rays,
                                        sorted_logits=True)
    ray_indices = np.asarray(jf.candidate_indices)[np.asarray(cand)]
    want = jpanels.diagnostic_panels(params, jf, step, jcfg, key=dots)
    got = tpanels.diagnostic_panels(convert.params_from_jax(params, device="cpu"), tf, step,
                                    tcfg, ray_indices=ray_indices)
    assert sorted(got) == sorted(want) == ["bev/0", "gt/-1", "gt/0", "gt/1", "gt/2", "pd/0"]
    for name, image in want.items():
        assert got[name].shape == image.shape, name
        assert np.array_equal(got[name], np.asarray(image)), name
    # the pd panel shows the predicted masks, the gt panels the red dots
    assert (got["pd/0"] != got["gt/0"]).any()
    target = int(tf.target_index)
    view0 = ray_indices[ray_indices < 96 * 128]
    y, x = view0[0] // 128, view0[0] % 128
    assert got[f"gt/{0 - target}"][y, x].tolist() == [1.0, 0.0, 0.0]


def _panel_tree(root):
    import test_tools_e2e as e2e

    e2e._make_synthetic_kitti360(root)
    image_dir = os.path.join(root, "data_2d_raw", e2e.SEQUENCE, "image_00", "data_rect")
    split = os.path.join(root, "filenames", "panels", e2e.SEQUENCE)
    os.makedirs(split)
    with open(os.path.join(split, "sampled_image_filenames.txt"), "w") as file:
        file.write(f"26000,26001 {os.path.join(image_dir, '0000000002.png')} -1,1\n")
    chain = [{"function": f"vsrd.transforms.{name}", "args": args} for name, args in (
        ("Resizer", [[e2e.H, e2e.W]]), ("MaskAreaFilter", [1]), ("MaskRefiner", []),
        ("MaskAreaFilter", [8]), ("BoxGenerator", []), ("BoxSizeFilter", [2]),
        ("SoftRasterizer", []))]
    config = {
        "datasets": {"train": {"function": "vsrd_tpu.data.KITTI360Dataset", "kwargs": {
            "filenames": [os.path.join(split, "sampled_image_filenames.txt")],
            "num_source_frames": 2, "num_workers": 1,
            "target_transforms": chain, "source_transforms": chain}}},
        "optimization": {"num_steps": 4, "warmup_steps": 2},
        "volume_rendering": {"num_rays": 32, "num_fine_samples": 8},
        "surface_rendering": {"num_iterations": 16},
        "logging": {"ckpt_intervals": 2, "scalar_intervals": 2, "image_intervals": 4},
    }
    path = os.path.join(root, "configs", "panels", e2e.SEQUENCE, "config.json")
    os.makedirs(os.path.dirname(path))
    with open(path, "w") as file:
        json.dump(config, file)
    return path


def test_the_driver_writes_the_panels_at_image_intervals(tmp_path):
    pytest.importorskip("tensorboardX")
    from vsrd_tpu_torch.scripts import main as driver

    config = _panel_tree(str(tmp_path))
    driver.main(["--config", config, "--train", "--device", "cpu"])
    events = glob.glob(os.path.join(str(tmp_path), "logs", "panels", "**", "events.*"),
                       recursive=True)
    assert events
    blob = b"".join(open(e, "rb").read() for e in events)
    for tag in (b"images/gt/0", b"images/gt/-1", b"images/pd/0", b"images/bev/0",
                b"scalars/loss"):
        assert tag in blob, tag
    # at step 4 only (image_intervals), not at the checkpoint of step 2
    assert blob.count(b"images/pd/0") == 1
