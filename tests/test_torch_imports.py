"""The port and chip_smoke.py import neither JAX nor the JAX package nor its
bench.py and scripts/, and importing the port needs no CUDA compiler and no triton.

Checked on the source (ast), not on sys.modules: the test process itself
imports JAX. Note that physimglobalpose_tpu_torch shares its prefix with
physimglobalpose_tpu, so the check is on the top-level module name.
"""

import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
# "scripts": the JAX package's scripts/ directory, imported as a namespace
# package from the repository's root.
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "physimglobalpose_tpu", "bench", "scripts"}


def _sources():
    files = sorted((ROOT / "physimglobalpose_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))


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
    names = {str(p.relative_to(ROOT)) for p in files}
    assert {"physimglobalpose_tpu_torch/ops/scoring.py", "physimglobalpose_tpu_torch/ops/icp.py",
            "physimglobalpose_tpu_torch/ops/lcp.py", "physimglobalpose_tpu_torch/geometry/metrics.py",
            "physimglobalpose_tpu_torch/bench_inputs.py",
            "physimglobalpose_tpu_torch/ops/raster.py", "physimglobalpose_tpu_torch/ops/cost.py",
            "physimglobalpose_tpu_torch/ops/physics.py",
            "physimglobalpose_tpu_torch/pipeline/mcts.py",
            "physimglobalpose_tpu_torch/pipeline/greedy_search.py",
            "physimglobalpose_tpu_torch/pipeline/evaluate.py",
            "physimglobalpose_tpu_torch/ops/ppf_voting.py",
            "physimglobalpose_tpu_torch/models/fcn.py",
            "physimglobalpose_tpu_torch/models/detect.py",
            "physimglobalpose_tpu_torch/pipeline/detector.py",
            "physimglobalpose_tpu_torch/pipeline/selection.py",
            "physimglobalpose_tpu_torch/pipeline/server.py",
            "physimglobalpose_tpu_torch/parallel/mesh.py",
            "physimglobalpose_tpu_torch/parallel/sharding.py",
            "physimglobalpose_tpu_torch/parallel/scene_sweep.py",
            "physimglobalpose_tpu_torch/ops/raster_tri.py",
            "physimglobalpose_tpu_torch/utils/viz.py",
            "physimglobalpose_tpu_torch/utils/debug.py",
            "physimglobalpose_tpu_torch/utils/checkpoint.py",
            "physimglobalpose_tpu_torch/utils/segdata.py",
            "physimglobalpose_tpu_torch/utils/synthdata.py",
            "physimglobalpose_tpu_torch/runtime/__init__.py",
            "physimglobalpose_tpu_torch/scripts/train_fcn.py",
            "physimglobalpose_tpu_torch/scripts/train_detector.py",
            "physimglobalpose_tpu_torch/scripts/make_synthetic_scenes.py",
            "physimglobalpose_tpu_torch/scripts/bench_scoring.py",
            "physimglobalpose_tpu_torch/scripts/whole_scene_bench.py",
            "physimglobalpose_tpu_torch/scripts/server_loadtest.py",
            "physimglobalpose_tpu_torch/scripts/eval_fcn_checkpoints.py",
            "physimglobalpose_tpu_torch/scripts/_synth_eval.py",
            "physimglobalpose_tpu_torch/scripts/r4_hard_eval.py",
            "physimglobalpose_tpu_torch/scripts/r5_eval.py",
            "physimglobalpose_tpu_torch/scripts/r5_hard_miss_analysis.py"} <= names
    offenders = {str(p.relative_to(ROOT)): b for p in files if (b := _forbidden_imports(p))}
    assert offenders == {}


def test_kernel_sources_are_all_built_and_stand_alone():
    # _build.KERNEL_SOURCES names every .cu file of csrc/, and a kernel source
    # includes the CUDA toolkit's headers only: no PyTorch, cuBLAS, cuDNN or
    # CUTLASS device-level kernel, and nothing of Python.
    from physimglobalpose_tpu_torch import _build

    csrc = ROOT / "physimglobalpose_tpu_torch" / "csrc"
    sources = sorted(p.stem for p in csrc.glob("*.cu"))
    assert sources == sorted(_build.KERNEL_SOURCES)
    assert {"lcp_stream", "icp_corr_stream"} <= set(sources)
    allowed = {"cuda_runtime.h", "cuda_bf16.h", "math.h"}
    for path in csrc.iterdir():
        includes = {line.split("<")[1].split(">")[0] for line in path.read_text().splitlines()
                    if line.startswith("#include")}
        assert includes <= allowed, (path.name, includes - allowed)
        assert 'extern "C"' in path.read_text()  # a plain C launcher for ctypes


def test_checker_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import jax.numpy as jnp\nfrom physimglobalpose_tpu.ops import lcp\n"
        "import physimglobalpose_tpu_torch\nfrom physimglobalpose_tpu_torch.ops import lcp\n"
        "import bench\nfrom physimglobalpose_tpu_torch import bench_inputs\n"
        "from scripts import r4_hard_eval\nfrom physimglobalpose_tpu_torch.scripts import r5_eval\n"
    )
    assert _forbidden_imports(src) == ["jax.numpy", "physimglobalpose_tpu.ops", "bench", "scripts"]


def test_importing_the_port_builds_and_loads_no_kernel():
    # Every module of the port imports in a process that can find no CUDA
    # compiler, without loading triton, building or loading a kernel library.
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "physimglobalpose_tpu_torch").rglob("*.py") if p.name != "__init__.py"
    )
    assert {"physimglobalpose_tpu_torch.ops.scoring", "physimglobalpose_tpu_torch.pipeline.mcts",
            "physimglobalpose_tpu_torch.pipeline.evaluate", "physimglobalpose_tpu_torch.models.fcn",
            "physimglobalpose_tpu_torch.models.detect",
            "physimglobalpose_tpu_torch.pipeline.detector",
            "physimglobalpose_tpu_torch.pipeline.server",
            "physimglobalpose_tpu_torch.parallel.scene_sweep",
            "physimglobalpose_tpu_torch.ops.raster_tri", "physimglobalpose_tpu_torch.utils.debug",
            "physimglobalpose_tpu_torch.utils.checkpoint",
            "physimglobalpose_tpu_torch.utils.synthdata",
            "physimglobalpose_tpu_torch.scripts.train_fcn",
            "physimglobalpose_tpu_torch.scripts.train_detector",
            "physimglobalpose_tpu_torch.scripts.make_synthetic_scenes",
            "physimglobalpose_tpu_torch.scripts.bench_scoring",
            "physimglobalpose_tpu_torch.scripts.whole_scene_bench",
            "physimglobalpose_tpu_torch.scripts.server_loadtest",
            "physimglobalpose_tpu_torch.scripts.eval_fcn_checkpoints",
            "physimglobalpose_tpu_torch.scripts.r4_hard_eval",
            "physimglobalpose_tpu_torch.scripts.r5_eval",
            "physimglobalpose_tpu_torch.scripts.r5_hard_miss_analysis"} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "from physimglobalpose_tpu_torch import _build\n"
        "assert 'triton' not in sys.modules\n"
        "assert _build._LOADED == {} and _build.BUILD_LOG == {}\n"
        "from physimglobalpose_tpu_torch import runtime\n"
        "assert runtime._lib is None and not runtime._build_failed\n"
        "print('imported', len(sys.modules))\n"
    )
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent", CUDA_PATH="/nonexistent",
               PYTHONPATH=str(ROOT))
    done = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(ROOT), timeout=300,
                          capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.startswith("imported")
