"""The import guard compares whole top-level names: the port's name begins
with the JAX package's, and must not be taken for it."""

import ast
import sys
import types

from gpubench import run, spec

PORT = "physimglobalpose_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_the_guard_takes_whole_top_level_names(monkeypatch):
    for name in (PORT, f"{PORT}.pipeline.api", "jaxtyping", "flax_like", "physimglobalpose"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert "physimglobalpose_tpu" not in run.forbidden_loaded()
    assert "jax" not in run.forbidden_loaded() and "flax" not in run.forbidden_loaded()
    for name in ("physimglobalpose_tpu.ops.lcp", "jaxlib.xla_client", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(run.forbidden_loaded()) >= {"physimglobalpose_tpu", "jaxlib", "flax"}


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in sorted(spec.HERE.rglob("*.py")):
        for mod in _imports(path):
            assert mod.split(".")[0] not in run.FORBIDDEN_MODULES, (path, mod)


def test_the_yardstick_imports_nothing_of_the_port():
    """The reference, the scene generator, the traffic generator, the check
    and the arithmetic of the metrics take nothing from the program."""
    for name in ("reference", "scenes", "traffic", "check", "roofline", "timings", "sets", "spec"):
        for mod in _imports(spec.HERE / f"{name}.py"):
            assert mod.split(".")[0] != PORT, (name, mod)
    for path in (spec.HERE / "metrics").glob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] != PORT, (path, mod)
