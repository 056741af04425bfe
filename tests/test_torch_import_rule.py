"""The port imports no JAX and nothing of the JAX package.

A fresh interpreter with ``jax`` and ``landing_controller_tpu`` blocked in
``sys.modules`` imports every module of landing_controller_tpu_torch and
the repo-root ``chip_smoke.py``; the sources are also searched for such
imports.
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
    assert len(modules) >= 21
    assert "landing_controller_tpu_torch.dynamics.legs" in modules
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
        files += [os.path.join(d, f) for f in fs if f.endswith((".py", ".cu", ".cuh"))]
    assert sum(f.endswith((".cu", ".cuh")) for f in files) == 3
    for path in files:
        with open(path) as f:
            src = f.read()
        hits = [m.group(0) for m in pattern.finditer(src)]
        assert not hits, (path, hits)
