"""The port stands alone: it never imports JAX or the JAX package, and
chip_smoke.py refuses to run without a CUDA card instead of falling back."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "kronfluence_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "safetensors", "tqdm", "kronfluence_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path",
    sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_source_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.mark.parametrize(
    "path",
    sorted((PACKAGE / "examples").rglob("*.py")),
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_port_examples_import_neither_jax_nor_the_jax_examples(path):
    """The port's example pipelines stand alone: no JAX, no optax, nothing of
    the JAX package and nothing of its `examples` package, and no relative
    import that could reach past the port."""
    tree = ast.parse(path.read_text(), filename=str(path))
    relative = [node.module for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom) and node.level > 0]
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN + ("examples",)))
    assert not bad and not relative, f"{path.relative_to(REPO)} imports {bad or relative}"


# The entry points of the cifar, imagenet, uci, glue, swag and dailymail
# example pipelines.
EXAMPLE_ENTRY_POINTS = tuple(
    f"kronfluence_tpu_torch.examples.{script}" for script in (
        "cifar.train", "cifar.detect_mislabeled_dataset", "cifar.half_precision_analysis",
        "cifar.inspect_factors", "imagenet.analyze", "imagenet.query_batching_analysis",
        "imagenet.ddp_analyze", "uci.train", "uci.analyze", "uci.run_counterfactual",
        "glue.train", "glue.analyze", "glue.half_precision_analysis", "glue.run_counterfactual",
        "glue.evaluate_lds", "swag.train", "swag.analyze", "swag.influence_analysis",
        "swag.evaluate_lds", "dailymail.train", "dailymail.analyze",
        "dailymail.inspect_examples",
    )
)
EXAMPLE_PIPELINES = tuple(f"kronfluence_tpu_torch.examples.{name}.pipeline"
                          for name in ("glue", "swag", "dailymail"))


def _port_modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PACKAGE.rglob("*.py")
        if p.name != "__init__.py"
    )


def test_every_module_is_checked():
    """The checks above walk the package; the modules ported last are in it."""
    modules = _port_modules()
    for name in ("kronfluence_tpu_torch.ops.svd", "kronfluence_tpu_torch.evaluate",
                 "kronfluence_tpu_torch.score.pairwise", "kronfluence_tpu_torch.ops.scores",
                 "kronfluence_tpu_torch.capture.functional", "kronfluence_tpu_torch.nn",
                 "kronfluence_tpu_torch.models.mlp", "kronfluence_tpu_torch.models.encoder_decoder",
                 "kronfluence_tpu_torch.parallel.distributed",
                 "kronfluence_tpu_torch.parallel.mesh",
                 "kronfluence_tpu_torch.examples.common",
                 "kronfluence_tpu_torch.examples.openwebtext.fit_factors",
                 "kronfluence_tpu_torch.examples.wikitext.run_counterfactual",
                 *EXAMPLE_ENTRY_POINTS, *EXAMPLE_PIPELINES):
        assert name in modules


def test_importing_parallel_starts_no_process_group():
    """`kronfluence_tpu_torch.parallel` initialises nothing when imported:
    no process group, one process, rank 0."""
    code = (
        "import sys\n"
        "import torch.distributed as dist\n"
        "from kronfluence_tpu_torch import parallel\n"
        "state = (dist.is_initialized(), parallel.num_processes(), parallel.process_index(),\n"
        "         parallel.initialize())\n"
        "print('STATE', state)\n"
        "sys.exit(0 if state == (False, 1, 0, False) else 1)\n"
    )
    env = _clean_env()
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_importing_every_module_loads_no_jax():
    """Against a baseline of torch and numpy alone (torch.hub loads tqdm
    where it is installed), importing the port loads none of FORBIDDEN."""
    code = (
        "import importlib, sys\n"
        "import numpy, torch\n"
        "baseline = set(sys.modules)\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "new = set(sys.modules) - baseline\n"
        f"bad = sorted(m for m in new if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_clean_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr


def test_package_exports_the_api_and_builds_nothing():
    """`import kronfluence_tpu_torch` exposes the JAX package's public names
    and neither builds nor loads the kernel library."""
    code = (
        "import sys\n"
        "import kronfluence_tpu_torch as kf\n"
        "from kronfluence_tpu_torch.ops.kernels import build\n"
        "names = ['Analyzer', 'prepare_model', 'FactorArguments', 'ScoreArguments', 'Task',\n"
        "         '__version__', 'nn', 'FunctionalModel']\n"
        "missing = [n for n in names if not hasattr(kf, n)]\n"
        "maps = open('/proc/self/maps').read()\n"
        "print('MISSING', missing, 'LOADED', build.load_library.cache_info().currsize,\n"
        "      'libkf_kernels' in maps)\n"
        "sys.exit(1 if missing or build.load_library.cache_info().currsize\n"
        "         or 'libkf_kernels' in maps else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_clean_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("entry_point", EXAMPLE_ENTRY_POINTS)
def test_example_entry_point_loads_no_kernel_library(entry_point):
    """Importing an example's entry point (its pipeline, the models and the
    Analyzer with it) neither builds nor loads the kernel library, and
    starts no process group."""
    code = (
        "import importlib, sys\n"
        "import torch.distributed as dist\n"
        "from kronfluence_tpu_torch.ops.kernels import build\n"
        f"module = importlib.import_module({entry_point!r})\n"
        "maps = open('/proc/self/maps').read()\n"
        "state = (callable(module.main), build.load_library.cache_info().currsize,\n"
        "         'libkf_kernels' in maps, dist.is_initialized())\n"
        "print('STATE', state)\n"
        "sys.exit(0 if state == (True, 0, False, False) else 1)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_clean_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "script_alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No CUDA card (or no package beside the script): non-zero exit, and the
    result line is never printed."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run for real")
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=_clean_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
