"""The port and chip_smoke.py import neither JAX nor the JAX package.

Checked on the source (ast), not on sys.modules: the test process itself
imports JAX. Note that physimglobalpose_tpu_torch shares its prefix with
physimglobalpose_tpu, so the check is on the top-level module name.
"""

import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "physimglobalpose_tpu"}


def _sources():
    files = sorted((ROOT / "physimglobalpose_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _forbidden_imports(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        bad += [nm for nm in names if nm.split(".")[0] in FORBIDDEN]
    return bad


def test_port_imports_no_jax():
    files = _sources()
    assert len(files) > 20
    offenders = {str(p.relative_to(ROOT)): b for p in files if (b := _forbidden_imports(p))}
    assert offenders == {}


def test_checker_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import jax.numpy as jnp\nfrom physimglobalpose_tpu.ops import lcp\n"
        "import physimglobalpose_tpu_torch\nfrom physimglobalpose_tpu_torch.ops import lcp\n"
    )
    assert _forbidden_imports(src) == ["jax.numpy", "physimglobalpose_tpu.ops"]
