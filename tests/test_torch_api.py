"""The port's solver API: configuration parity with the JAX package, the
device rule, and warm restarts (CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

from landing_controller_tpu.solver import IPConfig as JaxIPConfig
from landing_controller_tpu_torch.api import LandingSolution, LandingSolver
from landing_controller_tpu_torch.solver.ip import IPConfig

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


def test_ipconfig_fields_and_defaults_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(IPConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxIPConfig)}
    assert ours == theirs


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert LandingSolver(n_knots=13).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            LandingSolver(n_knots=13)
    for kind in ("kinodynamic", "ccc", "contact_scheduled", "sliding"):
        with pytest.raises(NotImplementedError):
            LandingSolver(kind, device="cpu")
    with pytest.raises(NotImplementedError):
        LandingSolver(device="cpu", config=IPConfig(kkt_backend="scan"))
    with pytest.raises(NotImplementedError):
        LandingSolver(device="cpu", structured=False)


def test_warm_restart_from_a_solution():
    """A converged solution fed back as the warm start (z, s, lam, y) at a
    small barrier parameter converges again within a few iterations."""
    cfg = dict(hessian_mode="hybrid", mu_min=1e-6, tol=1e-4, sigma_max=1e8, refine_steps=1,
               relax_scale=1.0, delta_c=1e-6, kkt_backend="cri", ladder_scales=(0.0, 1.0),
               n_linesearch=4, mu_strategy="loqo", corrector=1)
    q0 = np.array([0.0, 0.0, 0.45, 0.02, 0.05, 0.0])
    qd0 = np.array([0.0, 0.1, 0.0, 0.1, 0.0, -0.6])
    cold = LandingSolver("srbm_lcp", n_knots=13, dtype=torch.float64, guess="ballistic",
                         config=IPConfig(max_iter=120, **cfg), device="cpu")
    sol = cold.solve(q0, qd0)
    assert isinstance(sol, LandingSolution) and bool(sol.converged)
    assert sol.X.shape == (13, 12) and sol.tau.shape == (12, 12)
    warm = LandingSolver("srbm_lcp", n_knots=13, dtype=torch.float64, guess="ballistic",
                         config=IPConfig(max_iter=120, mu_init=1e-4, **cfg), device="cpu")
    sol2 = warm.solve(q0, qd0, z0=sol.z, warm=sol)
    assert bool(sol2.converged)
    assert int(sol2.iterations) <= 10 < int(sol.iterations)
    assert abs(float(sol2.cost) - float(sol.cost)) <= 1e-6 * (1.0 + abs(float(sol.cost)))
