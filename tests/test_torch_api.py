"""The port's solver API: configuration parity with the JAX package, the
device rule, the KKT paths it accepts, warm restarts, and the JAX default
configuration's "scan" backend against the port's (CPU)."""

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
    # the voltage kind runs on the dense path, as in the JAX package
    assert not LandingSolver("kinodynamic_voltage", n_knots=5, device="cpu").structured
    for backend in ("scan", "cr"):
        s = LandingSolver(n_knots=5, device="cpu", config=IPConfig(kkt_backend=backend))
        assert s.structured and s.config.kkt_backend == backend
    assert not LandingSolver(n_knots=5, device="cpu", structured=False).structured
    # the JAX package's forcing variants select TPU or interpret paths
    for backend in ("cri_ref", "cri_pallas", "cri_pallas_interpret"):
        with pytest.raises(NotImplementedError):
            LandingSolver(device="cpu", config=IPConfig(kkt_backend=backend))
    with pytest.raises(KeyError):
        LandingSolver("no_such_kind", device="cpu")
    # eeparam is a kind now, on the dense path, with its own collocation count
    assert not LandingSolver("eeparam", n_knots=10, device="cpu").structured
    with pytest.raises(ValueError, match="collocation"):
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


@pytest.mark.parametrize("kind,structured", [
    ("kinodynamic", True), ("srbm_lcp", True), ("sliding", True), ("ccc", True),
    ("contact_scheduled", True), ("kinodynamic_voltage", True), ("kinodynamic", False),
    ("contact_scheduled", False)])
def test_solver_kinds_and_default_config_match_jax(kind, structured):
    """Every kind builds, with the JAX package's problem sizes, path
    (structured or dense) and default solver settings (f32 and f64: delta_c
    and refine_steps depend on the path); kkt_backend is the port's "cri"
    where the JAX default leaves "scan" (ROADMAP §3)."""
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        ts = LandingSolver(kind, n_knots=7, dtype=tdt, device="cpu", structured=structured)
        js = JaxLandingSolver(kind, n_knots=7, dtype=jdt, structured=structured)
        assert ts.structured == js.structured
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


def test_warm_variant_keeps_the_dense_path():
    dense = LandingSolver("kinodynamic", n_knots=5, structured=False, device="cpu")
    warm = dense.warm_variant()
    assert not warm.structured and warm.config.mu_init == 1e-2
    assert LandingSolver("kinodynamic", n_knots=5, device="cpu").warm_variant().structured


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


def test_scan_backend_matches_the_jax_default_config():
    """The JAX package's default-config solver (its IPConfig leaves
    kkt_backend="scan") against the port's default config with "scan" in
    place of the port's "cri": kinodynamic, f64, N=6, first five iterates.
    The kinodynamic systems are ill-conditioned, so the iterate is held by the
    rule of tests/test_torch_iterates_kino.py (1e-8, or 20 times the port's
    own change under a one-part-in-1e15 nudge of the scenario)."""
    q0 = np.array([0.0, 0.0, 0.55, 0.05, -0.2, 0.03])
    qd0 = np.array([0.2, -0.1, 0.3, 0.3, -0.2, -1.5])
    js = JaxLandingSolver(n_knots=6, dtype=jnp.float64)
    assert js.config.kkt_backend == "scan"
    js = JaxLandingSolver(n_knots=6, dtype=jnp.float64,
                          config=dataclasses.replace(js.config, max_iter=5))
    base = LandingSolver(n_knots=6, dtype=torch.float64, device="cpu").config
    ts = LandingSolver(n_knots=6, dtype=torch.float64, device="cpu",
                       config=dataclasses.replace(base, kkt_backend="scan", max_iter=5))
    assert dataclasses.asdict(ts.config) == dataclasses.asdict(js.config)
    sol_j = js.solve(jnp.asarray(q0), jnp.asarray(qd0))
    sol_t = ts.solve(q0, qd0)
    sol_n = ts.solve(q0 * (1.0 + 1e-15), qd0)
    assert int(sol_t.iterations) == int(sol_j.iterations) == 5
    want = np.asarray(sol_j.z)
    scale = np.maximum(1.0, np.abs(want))
    own = float(np.abs((sol_n.z.numpy() - sol_t.z.numpy()) / scale).max())
    gap = float(np.abs((sol_t.z.numpy() - want) / scale).max())
    print(f"[reading] scan vs JAX default config, 5 iterates: gap {gap:.3e}, own {own:.3e}")
    assert gap <= max(1e-8, 20.0 * own), (gap, own)
