"""Nothing the benchmark runs loads JAX or the JAX package, judged by whole
top-level module names (the port's name begins with the JAX package's), and
the reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

import pytest

from benchmarks.harness import HERE, import_offenders
from benchmarks.tests.conftest import ROOT


@pytest.mark.parametrize("modules,offenders", [
    ({"landing_controller_tpu_torch", "landing_controller_tpu_torch.api", "numpy"}, []),
    ({"landing_controller_tpu_torchvision", "jaxtyping", "flaxen.x"}, []),
    ({"landing_controller_tpu.ops.pallas_blocks", "numpy"}, ["landing_controller_tpu"]),
    ({"jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"}, ["flax", "jax", "jaxlib"]),
])
def test_whole_top_level_names(modules, offenders):
    assert import_offenders(modules) == offenders


def _sources(skip_tests=True):
    for dirpath, _, files in os.walk(HERE):
        if skip_tests and os.path.basename(dirpath) == "tests":
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_or_the_old_tools():
    banned = ("jax", "jaxlib", "flax", "landing_controller_tpu", "chip_smoke", "bench", "tools")
    for path in _sources():
        for name in _imports(path):
            parts = name.split(".")
            assert parts[0] not in banned, (path, name)
            assert parts[:2] not in (["landing_controller_tpu_torch", "bench"],
                                     ["landing_controller_tpu_torch", "tools"]), (path, name)


def test_reference_imports_nothing_of_the_port():
    for path in _sources():
        if os.sep + "reference" + os.sep in path:
            for name in _imports(path):
                assert name.split(".")[0] in ("__future__", "math", "os", "numpy", "torch", "benchmarks"), name
                assert not name.startswith("benchmarks.") or name in (
                    "benchmarks.harness", "benchmarks.reference.landing"), name


def test_a_run_loads_no_jax():
    """Import everything a run imports (harness, readers, references, the
    port's solver and stream) in a fresh process and list its modules."""
    code = (
        "import os, sys; sys.path.insert(0, sys.argv[1]);"
        "from benchmarks.harness import HERE, load_module, import_offenders;"
        "import benchmarks.trace, benchmarks.peaks, benchmarks.samplers.drops;"
        "[load_module(os.path.join(HERE, d, f), 'm_' + f) for d in ('metrics', 'reference')"
        " for f in sorted(os.listdir(os.path.join(HERE, d))) if f.endswith('.py')];"
        "import landing_controller_tpu_torch.api, landing_controller_tpu_torch.parallel.stream;"
        "print(import_offenders())"
    )
    out = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True, timeout=300,
                         env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
