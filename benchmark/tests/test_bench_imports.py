"""What the benchmark imports: never JAX or the JAX package, and the plain
reference nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
JAX_SIDE = {"jax", "jaxlib", "flax", "vsrd_tpu"}


def top_level_imports(path: Path) -> set:
    """Top-level module names (the part before the first dot, whole) that a
    source file imports anywhere in it."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    sources = sorted(BENCH.rglob("*.py"))
    assert len(sources) > 10
    for path in sources:
        found = top_level_imports(path) & JAX_SIDE
        assert not found, f"{path.relative_to(ROOT)} imports {found}"


def test_names_are_compared_whole():
    # the port's name begins with the JAX package's: a prefix test would
    # take one for the other
    assert "vsrd_tpu_torch".split(".")[0] not in JAX_SIDE
    assert "vsrd_tpu.pipeline".split(".")[0] in JAX_SIDE


def test_reference_imports_nothing_of_the_port():
    for name in ("reference.py", "check.py", "counts.py", "scenes.py"):
        imports = top_level_imports(BENCH / name)
        assert not imports & (JAX_SIDE | {"vsrd_tpu_torch"}), (name, imports)


def test_a_run_leaves_no_jax_module_loaded():
    code = ("import sys; sys.path.insert(0, %r); from benchmark import run, control, reference; "
            "import vsrd_tpu_torch.pipeline.optimize; print(run.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_sees_the_jax_package(monkeypatch):
    sys.path.insert(0, str(ROOT))
    from benchmark import run
    monkeypatch.setitem(sys.modules, "vsrd_tpu.fake", object())
    assert run.forbidden_modules() == ["vsrd_tpu"]
