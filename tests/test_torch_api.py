"""The port's solver API: configuration parity with the JAX package, the
device rule, and warm restarts (CPU)."""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.api import LandingSolver as JaxLandingSolver
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
    with pytest.raises(NotImplementedError):
        LandingSolver("kinodynamic_voltage", device="cpu")
    for backend in ("scan", "cr", "cri_ref"):
        with pytest.raises(NotImplementedError):
            LandingSolver(device="cpu", config=IPConfig(kkt_backend=backend))
    with pytest.raises(NotImplementedError):
        LandingSolver(device="cpu", structured=False)
    with pytest.raises(KeyError):
        LandingSolver("eeparam", device="cpu")


def test_default_kind_is_kinodynamic_as_in_jax():
    """A bare call solves the production problem on both sides."""
    ours = inspect.signature(LandingSolver.__init__).parameters
    theirs = inspect.signature(JaxLandingSolver.__init__).parameters
    assert ours["kind"].default == theirs["kind"].default == "kinodynamic"
    assert ours["n_knots"].default == theirs["n_knots"].default == 21
    s = LandingSolver(device="cpu")
    assert s.kind == "kinodynamic" and s.problem.config.kinodynamic
    assert s.problem.n_vars == 12 * 21 + 36 * 20
    assert s._z_scale.shape == (s.problem.n_vars,)
    assert s._relax_mask.shape == (s.problem.n_ineq,)


@pytest.mark.parametrize("kind", ["kinodynamic", "srbm_lcp", "sliding", "ccc", "contact_scheduled"])
def test_solver_kinds_and_default_config_match_jax(kind):
    """Every structured kind builds, with the JAX package's problem sizes and
    default solver settings (f32 and f64); kkt_backend is the port's "cri"."""
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        ts = LandingSolver(kind, n_knots=7, dtype=tdt, device="cpu")
        js = JaxLandingSolver(kind, n_knots=7, dtype=jdt)
        assert (ts.problem.n_vars, ts.problem.n_eq, ts.problem.n_ineq) == (
            js.problem.n_vars, js.problem.n_eq, js.problem.n_ineq)
        ours, theirs = dataclasses.asdict(ts.config), dataclasses.asdict(js.config)
        assert ours.pop("kkt_backend") == "cri" and theirs.pop("kkt_backend") == "scan"
        assert ours == theirs


def test_warm_variant_carries_device_and_settings():
    base = LandingSolver("sliding", n_knots=9, dtype=torch.float64, guess="ballistic",
                         retry_guess="reference", theta_overrides={"mu": 0.3}, device="cpu")
    warm = base.warm_variant(mu_init=1e-3, max_iter=40)
    assert warm.config.mu_init == 1e-3 and warm.config.max_iter == 40
    assert dataclasses.replace(warm.config, mu_init=base.config.mu_init,
                               max_iter=base.config.max_iter) == base.config
    assert (warm.kind, warm.device, warm.dtype, warm.guess, warm.retry_guess) == (
        "sliding", base.device, torch.float64, "ballistic", ("reference",))
    assert warm.problem.config == base.problem.config and warm.theta_overrides == {"mu": 0.3}


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
