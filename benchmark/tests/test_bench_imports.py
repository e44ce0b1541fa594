"""Nothing under benchmark/ imports JAX or the JAX package, compared by
whole top-level names (``mdir_tpu_torch`` is not ``mdir_tpu``), and the
reference imports nothing of the port."""
import ast
import os

import pytest

from harness.registry import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "mdir_tpu"}


def modules():
    for base, _, files in os.walk(BENCH_DIR):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(base, name)


def imported_tops(path):
    """Top-level names of every module a file imports (relative imports
    name nothing outside its package)."""
    with open(path) as handle:
        tree = ast.parse(handle.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def test_the_walk_sees_every_part():
    found = {os.path.relpath(p, BENCH_DIR).split(os.sep)[0]
             for p in modules()}
    assert {"run.py", "harness", "reference", "metrics", "tests"} <= found


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_no_jax(path):
    assert not imported_tops(path) & FORBIDDEN


def test_whole_names_are_compared(tmp_path):
    path = tmp_path / "x.py"
    path.write_text("import mdir_tpu_torch.ops\nfrom jax import numpy\n"
                    "import mdir_tpu.stages\n")
    tops = imported_tops(str(path))
    assert tops & FORBIDDEN == {"jax", "mdir_tpu"}
    assert "mdir_tpu_torch" in tops


@pytest.mark.parametrize("path", sorted(
    p for p in modules()
    if os.path.relpath(p, BENCH_DIR).startswith("reference")),
    ids=os.path.basename)
def test_reference_imports_nothing_of_the_port(path):
    assert "mdir_tpu_torch" not in imported_tops(path)
