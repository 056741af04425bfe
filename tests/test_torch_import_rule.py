"""The port imports no JAX and nothing of the JAX package.

A fresh interpreter with ``jax`` and ``landing_controller_tpu`` blocked in
``sys.modules`` imports every module of landing_controller_tpu_torch and
the repo-root ``chip_smoke.py``; the sources are also searched for such
imports, and the package's sources for a string that names a path under
the JAX package's directory (the port reads its own data files).
"""

import os
import pkgutil
import re
import subprocess
import sys

import landing_controller_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(landing_controller_tpu_torch.__file__)


def _port_modules():
    names = ["landing_controller_tpu_torch"]
    for info in pkgutil.walk_packages([PKG_DIR], prefix="landing_controller_tpu_torch."):
        names.append(info.name)
    return names


def test_port_imports_without_jax():
    modules = _port_modules()
    assert len(modules) >= 49
    for name in ("dynamics.legs", "ops.block_tridiag", "ops.cyclic_reduction", "problems.eeparam",
                 "warmstart.cascade", "warmstart.replan", "data.factory", "parallel.batch",
                 "parallel.multihost", "parallel.montecarlo", "runtime.native",
                 "analysis.warmstart_bench", "analysis.nn_validation",
                 "analysis.foot_positions", "dynamics.spatial", "dynamics.quaternion",
                 "dynamics.featherstone", "ops.branch_sparsity", "analysis.vbl", "_device",
                 "runtime.artifact", "viz.plots", "viz.animate", "viz.html_viewer"):
        assert f"landing_controller_tpu_torch.{name}" in modules
    code = "\n".join(
        [
            "import sys",
            "sys.modules['jax'] = None",
            "sys.modules['landing_controller_tpu'] = None",
            "import importlib",
            f"for name in {modules!r}:",
            "    importlib.import_module(name)",
            "import chip_smoke",
            "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules"
            " if sys.modules[m] is not None)",
            "print('ok')",
        ]
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_port_sources_name_no_jax():
    pattern = re.compile(r"import jax|from jax|landing_controller_tpu\.")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(PKG_DIR):
        files += [os.path.join(d, f) for f in fs if f.endswith((".py", ".cu", ".cuh", ".cpp"))]
    assert sum(f.endswith((".cu", ".cuh")) for f in files) == 3
    assert sum(f.endswith(".cpp") for f in files) == 1  # the native scenario pool
    # a quoted string that starts with the JAX package's directory: a path
    # into it (chip_smoke.py names the TPU kernels' file:line it replaces)
    jax_path = re.compile(r"[\"']landing_controller_tpu[\"'/]")
    for path in files:
        with open(path) as f:
            src = f.read()
        hits = [m.group(0) for m in pattern.finditer(src)]
        if path.startswith(PKG_DIR):
            hits += [m.group(0) for m in jax_path.finditer(src)]
        assert not hits, (path, hits)


def test_port_keeps_its_own_warm_start_network():
    """The committed network is copied into the port byte for byte, and the
    solvers' default ``nn_path`` is the port's copy."""
    import hashlib

    from landing_controller_tpu_torch.api import DEFAULT_NN_PATH

    def sha256(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    assert DEFAULT_NN_PATH == os.path.join(PKG_DIR, "data", "nn_TO_landing.npz")
    assert sha256(DEFAULT_NN_PATH) == sha256(
        os.path.join(ROOT, "landing_controller_tpu", "data", "nn_TO_landing.npz"))
