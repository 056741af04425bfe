"""Saved solvers: save -> load -> solve, against the live solver and JAX's.

The counterparts of ``tests/test_artifact.py`` (srbm_lcp, n_knots 11,
max_iter 8, on the CPU):

- round trip in f32: the loaded solve takes the live ``solve``'s
  iterations and its z within 1e-6 (it is bit-equal: the graph holds the
  same ops on the same inputs), and the saved graph calls the kernel's
  custom op ``landing_controller_tpu_torch::qd_inverse`` (on the CPU the op
  runs the plain version);
- a batched artifact (B=4, f64) against the live ``solve_batch``, and
  against the JAX package's batched artifact of the same solver loaded by
  ``landing_controller_tpu.runtime.load_solver`` (JAX on ``cri_ref``):
  iterations equal, z (scaled by max(1, |z|)) within 1e-8, the bound
  ``tests/test_torch_iterates.py`` holds f64 iterates to;
- a fresh interpreter with ``jax`` and ``landing_controller_tpu`` blocked
  loads the artifact and solves, without importing the port's problems,
  solver or api;
- ``enable_persistent_cache`` points the kernels' build directory.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.api import LandingSolver as JaxLandingSolver
from landing_controller_tpu.runtime import load_solver as j_load_solver
from landing_controller_tpu.runtime import save_solver as j_save_solver
from landing_controller_tpu.solver import IPConfig as JaxIPConfig
from landing_controller_tpu_torch.api import LandingSolver
from landing_controller_tpu_torch.runtime import load_solver, save_solver
from landing_controller_tpu_torch.runtime.artifact import MAGIC
from landing_controller_tpu_torch.solver.ip import IPConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q0 = np.array([0.0, 0.0, 0.6, 0.05, 0.2, -0.05])
QD0 = np.array([0.1, -0.1, 0.1, 0.2, -0.1, -1.5])
# the bench's rules (as tests/test_torch_iterates.py), 8 iterations
KW = dict(max_iter=8, hessian_mode="hybrid", mu_init=0.3, kappa_mu=0.5, mu_min=1e-5,
          tol=1e-4, sigma_max=1e5, refine_steps=1, relax_scale=1.0, delta_c=1e-6,
          ladder_scales=(0.0, 1.0), n_linesearch=4, mu_strategy="loqo", corrector=1)


def _drops(n):
    rng = np.random.default_rng(7)
    q = np.tile(Q0, (n, 1))
    q[:, 3:6] += rng.uniform(-0.1, 0.1, (n, 3))
    qd = np.tile(QD0, (n, 1))
    qd[:, 5] = -rng.uniform(0.5, 2.0, n)
    return q, qd


@pytest.fixture(scope="module")
def f32_artifact(tmp_path_factory):
    solver = LandingSolver("srbm_lcp", n_knots=11, dtype=torch.float32, device="cpu",
                           config=IPConfig(max_iter=8, hessian_mode="gn", relax_scale=1.0,
                                           kkt_backend="cri"))
    path = str(tmp_path_factory.mktemp("art") / "srbm_lcp_n11.lct")
    save_solver(solver, path)
    return solver, path


@pytest.fixture(scope="module")
def f64_batch_artifact(tmp_path_factory):
    solver = LandingSolver("srbm_lcp", n_knots=11, dtype=torch.float64, guess="ballistic",
                           config=IPConfig(kkt_backend="cri", **KW), device="cpu")
    path = str(tmp_path_factory.mktemp("art") / "srbm_lcp_n11_b4.lct")
    save_solver(solver, path, batch=4)
    return solver, path


def test_artifact_roundtrip(f32_artifact):
    solver, path = f32_artifact
    direct = solver.solve(Q0, QD0)
    loaded = load_solver(path, device="cpu")(Q0, QD0)
    assert int(loaded.iterations) == int(direct.iterations) == 8
    torch.testing.assert_close(loaded.z, direct.z, rtol=0, atol=1e-6)
    assert torch.equal(loaded.z, direct.z)  # the same ops on the same inputs
    assert bool(loaded.converged) == bool(direct.converged)
    with pytest.raises(ValueError, match="saved on cpu"):
        load_solver(path, device="meta")
    # every Newton step's block inverses are the kernel's custom op
    with open(path, "rb") as f:
        assert f.read(len(MAGIC)) == MAGIC
        header = json.loads(f.readline())
        blob = f.read()
    assert header["programs"] == ["init", "iterate", "finish"] and header["device"] == "cpu"
    assert b"landing_controller_tpu_torch::qd_inverse.default" in blob


def test_batched_artifact(f64_batch_artifact):
    solver, path = f64_batch_artifact
    q, qd = _drops(4)
    direct = solver.solve_batch(q, qd)
    loaded = load_solver(path, device="cpu")(q, qd)
    assert loaded.z.shape == (4, solver.problem.n_vars)
    assert torch.equal(loaded.iterations, direct.iterations)
    assert torch.equal(loaded.z, direct.z)


def test_artifact_matches_jax_artifact(f64_batch_artifact, tmp_path):
    _, path = f64_batch_artifact
    q, qd = _drops(4)
    js = JaxLandingSolver("srbm_lcp", n_knots=11, dtype=jnp.float64, guess="ballistic",
                          config=JaxIPConfig(kkt_backend="cri_ref", **KW))
    j_path = str(tmp_path / "jax_b4.lctpu")
    j_save_solver(js, j_path, batch=4)
    want = j_load_solver(j_path)(jnp.asarray(q), jnp.asarray(qd))
    got = load_solver(path, device="cpu")(q, qd)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    z_j = np.asarray(want.z)
    scale = np.maximum(1.0, np.abs(z_j))
    np.testing.assert_allclose(got.z.numpy() / scale, z_j / scale, rtol=0, atol=1e-8)


def test_artifact_loads_without_problem_definition(f32_artifact, tmp_path):
    """A fresh interpreter that cannot import JAX or the JAX package loads
    the artifact and solves; the port's problems, solver and api stay
    unimported."""
    solver, path = f32_artifact
    out = str(tmp_path / "loaded.npz")
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["landing_controller_tpu"] = None
import numpy as np
import torch
from landing_controller_tpu_torch.runtime.artifact import load_solver
sol = load_solver({path!r}, device="cpu")(np.array({Q0.tolist()}), np.array({QD0.tolist()}))
unwanted = [m for m in sys.modules if m.startswith("landing_controller_tpu_torch.")
            and m.split(".")[1] in ("problems", "solver", "api")]
assert not unwanted, unwanted
np.savez({out!r}, z=sol.z.numpy(), it=sol.iterations.numpy())
print("ARTIFACT_OK")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=str(tmp_path), env=env)
    assert "ARTIFACT_OK" in r.stdout, f"rc={r.returncode}\n{r.stderr[-2000:]}"
    got = np.load(out)
    direct = solver.solve(Q0, QD0)
    assert int(got["it"]) == int(direct.iterations)
    np.testing.assert_array_equal(got["z"], direct.z.numpy())


def test_enable_persistent_cache_points_the_kernel_build(tmp_path, monkeypatch):
    """The port's compile cache is the kernels' build directory: the given
    directory, else $LANDING_CTRL_CACHE, else build/kernels; idempotent."""
    from landing_controller_tpu_torch.ops import _build
    from landing_controller_tpu_torch.runtime import enable_persistent_cache

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.delenv("LANDING_CTRL_CACHE", raising=False)
    assert enable_persistent_cache() == _build.DEFAULT_BUILD_DIR == _build.BUILD_DIR
    monkeypatch.setenv("LANDING_CTRL_CACHE", str(tmp_path / "env"))
    assert enable_persistent_cache() == str(tmp_path / "env")
    for _ in range(2):
        assert enable_persistent_cache(str(tmp_path / "c")) == str(tmp_path / "c")
    assert _build.library_path("qd_inverse").startswith(str(tmp_path / "c") + os.sep)
