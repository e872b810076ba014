"""The frozen work counts against the port's twin-based count of today."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import counts  # noqa: E402
from vsrd_tpu_torch.scripts import roofline  # noqa: E402


@pytest.mark.parametrize("kind", ["K1", "K2", "K3"])
@pytest.mark.parametrize("rdf", [True, False])
def test_frozen_counts_equal_count_ops(kind, rdf):
    instances = 3
    twin = roofline.tile_counts(kind, instances, rdf, "default")
    per_pair = twin.tensor_macs / (roofline.TILE * instances)
    assert counts.call_macs(kind, 1, 1, rdf) == per_pair
    for points, n, frames in ((1000, 8, 1), (199_000, 32, 8)):
        assert counts.call_bytes(kind, points, n, rdf, frames) == roofline.call_bytes(
            kind, points, n, rdf, frames)


def config(precision="default", box_coarse=True, instances=8):
    return {"max_instances": instances,
            "optimization": {"num_rays": 1000, "num_samples": 100,
                             "kernel_matmul_precision": precision, "kernel_dir_coarse": True,
                             "kernel_box_coarse": box_coarse}}


def test_step_work_follows_the_configuration():
    cfg = config()
    warm = counts.step_work(cfg, 1, residual=False)
    res = counts.step_work(cfg, 1, residual=True)
    assert warm["macs"] == 0.0          # box only: bound by bytes
    assert res["macs"] == 199_000 * 8 * (3104 + 9312)
    assert counts.step_work(cfg, 8, True)["macs"] == 8 * res["macs"]
    # a configuration that the counts do not cover brings its own
    for other in (config("highest"), config(box_coarse=False)):
        with pytest.raises(ValueError):
            counts.step_calls(other, True)


def test_shares_are_shares():
    cfg = config()
    bound = counts.mix(counts.step_work(cfg, 1, False)["bound_s"],
                       counts.step_work(cfg, 1, True)["bound_s"]) * 1e3
    # a kernel time at its bound reads 100 %
    assert counts.kernel_roofline(cfg, 1, {"warmup": bound, "residual": bound}) == pytest.approx(
        100.0)
    flops = 2 * counts.mix(0.0, counts.step_work(cfg, 1, True)["macs"])
    wall_ms = flops / counts.PEAK_BF16_FLOPS * 1e3
    assert counts.step_mfu(cfg, 1, {"warmup": wall_ms, "residual": wall_ms}) == pytest.approx(100.0)
