"""Without a card the benchmark fails and prints no result: it never falls
back to the CPU."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def run_cell(cwd: Path, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "b8-f1", "--seed",
                           str(2**31 + 11), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=cwd, env=env)


def no_result(out):
    for line in out.stdout.strip().splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: this test is of a machine without one")
    out = run_cell(ROOT, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "CUDA card" in out.stderr
    no_result(out)


def test_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = run_cell(tmp_path)
    assert out.returncode != 0
    no_result(out)
