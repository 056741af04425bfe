"""The eeParam (free contact timing) kind on the stream's normal path, on the
CPU, port only (no JAX):

- the benchmark's plain reference (``benchmarks/reference/eeparam_sweep.py``,
  which imports nothing of the port) against the port at four seeded drops
  of the eeParam sweep: in float64 the parameters, the cold guess, the
  scales, the cost and every row at seeded random decision vectors to
  1e-12; in float32, as the benchmark runs it, the violation the solver
  reports after three iterations;
- ``StreamingSolver`` over ``LandingSolver("eeparam")`` against
  ``EEParamSolver.solve_batch`` on the same drops: the same iterates and
  iteration counts;
- the dense KKT step's spans and its device counter ``dense_kkt.emergency``;
- the iteration's path makes no tensor from host data after its first
  call (what a CUDA graph's capture needs), and a saved step is refused;
- the kind's rules (collocation count, guesses, fixed horizon).
"""

import os

import numpy as np
import pytest
import torch

from landing_controller_tpu_torch import tracing
from landing_controller_tpu_torch.api import EEParamSolver, LandingSolver
from landing_controller_tpu_torch.parallel import StreamingSolver
from landing_controller_tpu_torch.solver.ip import IPConfig, _solve_kkt, ip_program

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 7  # seeds may exceed 32 signed bits


def _bench():
    """The eeParam configuration and drop mix of the benchmark, and its
    reference module."""
    import json

    from benchmarks.harness import load_module

    with open(os.path.join(ROOT, "benchmarks", "configs", "eeparam_sweep.json")) as f:
        cfg = {**json.load(f), "name": "eeparam_sweep"}
    with open(os.path.join(ROOT, "benchmarks", "traffic", "eeparam_drops.b512.json")) as f:
        mix = json.load(f)
    ref_mod = load_module(os.path.join(ROOT, "benchmarks", "reference", "eeparam_sweep.py"), "t_ref_eeparam")
    return cfg, mix, ref_mod


def _drops(mix, n, seed=SEED):
    from benchmarks.samplers.eeparam_drops import draw

    return draw(mix, seed, n, 0)


def _solver(dtype=torch.float32, max_iter=200):
    from benchmarks.harness import build_solver

    cfg, _, _ = _bench()
    return build_solver({**cfg, "dtype": str(dtype).removeprefix("torch."),
                         "ip": {**cfg["ip"], "max_iter": max_iter}}, "cpu")


def test_reference_rows_guess_and_scales_match_the_port():
    """Both sides in float64, so they round alike."""
    cfg, mix, ref_mod = _bench()
    ref = ref_mod.make(cfg, "cpu")
    solver = _solver(torch.float64)
    q, qd = _drops(mix, 4)
    q64, qd64 = (torch.as_tensor(a, dtype=torch.float64) for a in (q, qd))
    th_p, th = solver.build_params(q, qd), ref.params(q64, qd64)
    for key in ("r_init", "rdot_init", "theta_init", "thetadot_init", "r_des", "theta_des", "mu",
                "l_leg_max", "f_max"):
        np.testing.assert_allclose(th[key].numpy(), getattr(th_p, key).numpy(), rtol=0, atol=1e-12)
    z0 = solver._cold_guess(th_p, 0)
    np.testing.assert_allclose(ref.guess("reference", th).numpy(), z0.numpy(), rtol=1e-12, atol=1e-12)
    gen = torch.Generator().manual_seed(1)
    z = z0 + 0.01 * torch.randn(4, ref.n_vars, generator=gen, dtype=torch.float64)
    for port_fn, ref_fn in ((solver.problem.cost, ref.cost), (solver.problem.eq, ref.eq),
                            (solver.problem.ineq, ref.ineq)):
        rp, rr = port_fn(z, th_p), ref_fn(z, th)
        assert rr.shape == rp.shape
        np.testing.assert_allclose(rr.numpy(), rp.numpy(), rtol=1e-12, atol=1e-12)
    snlp = solver.scaled_problem(th_p, z0)
    _, _, (fs, se, sg) = ref.evaluate(q64, qd64, z, ["reference"])
    for mine, theirs in ((fs[:, 0], snlp.f_scale), (se[:, 0], snlp.eq_scale), (sg[:, 0], snlp.ineq_scale)):
        np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(snlp.z_scale.numpy(), np.ones((4, ref.n_vars)))


def test_reference_violation_of_a_short_solve():
    """Three iterations of the program (float32, as the benchmark runs it):
    the reference's violation of the iterate equals the one the program
    reports."""
    cfg, mix, ref_mod = _bench()
    ref = ref_mod.make(cfg, "cpu")
    solver = _solver()
    q, qd = _drops(mix, 4)
    snlp, st = solver.init_lanes(q, qd, 0)
    prog = solver.program(snlp)
    for _ in range(3):
        st = prog.step(st)
    res = prog.finish(st)
    z = snlp.from_scaled(res.z).double()
    mine = ref.violation(torch.as_tensor(q, dtype=torch.float64), torch.as_tensor(qd, dtype=torch.float64),
                         z, ["reference"])[:, 0].numpy()
    rep = res.constr_viol.double().numpy()
    assert (np.abs(mine - rep) / np.maximum(1.0, mine)).max() < 1e-5, (rep, mine)


def test_stream_gives_eeparam_solvers_iterates():
    """B=2 lanes over a pool of 4 drops, one attempt of the whole budget
    (cut to 4 iterations): each drop's harvested z and iteration count are
    EEParamSolver's on the same drops, bit for bit."""
    _, mix, _ = _bench()
    q, qd = _drops(mix, 4)
    solver = _solver(max_iter=4)
    ss = StreamingSolver(solver, batch=2, segment=2, sampler=lambda n: (q[:n], qd[:n]), attempt_iters=(4,),
                         collect_z=True)
    step, rows = ss.get_step(4), []

    def recording(pool, carry):
        carry = step(pool, carry)
        rows.append(carry.res.numpy().copy())
        return carry

    ss._step_cache[4] = recording
    stats = ss.run(4)
    assert stats["n_finished"] == 4 and len(rows) == 4  # two drops a lane, two segments each
    np.testing.assert_array_equal(stats["ics"], np.concatenate([q, qd], 1))

    ee = EEParamSolver(ip_config=solver.config, device="cpu")
    th = ee.build_params(r_init=q[:, :3], rdot_init=qd[:, 3:6], theta_init=q[:, 3:6],
                         thetadot_init=np.zeros((4, 3), np.float32))
    sol = ee.solve_batch(th)
    np.testing.assert_array_equal(stats["z"], sol.z.numpy())
    np.testing.assert_array_equal(rows[-1][2, :4], sol.iterations.numpy())
    np.testing.assert_array_equal(np.asarray(stats["converged_mask"]), sol.converged.numpy())


def test_dense_step_spans_and_emergency_counter():
    """The dense step records newton.derivatives, .factor and .solve; a lane
    whose Hessian no ladder shift can make positive definite takes the
    emergency shift and is counted on its device."""
    tracing.reset()
    tracing.enable()
    try:
        _, mix, _ = _bench()
        solver = _solver(max_iter=2)
        q, qd = _drops(mix, 2)
        snlp, st = solver.init_lanes(q, qd, 0)
        prog = ip_program(snlp.cost, snlp.eq, snlp.ineq, solver.config)
        prog.step(st)
        names = {s[0] for s in tracing.spans()}
        assert {"newton.derivatives", "newton.factor", "newton.solve"} <= names
    finally:
        tracing.disable()
    before = tracing.counters()
    n, me = 4, 1
    H = torch.eye(n, dtype=torch.float64).expand(2, n, n).clone()
    H[1, 0, 1] = H[1, 1, 0] = 10.0  # eigenvalues 11 and -9 after equilibration
    cfg = IPConfig(ladder_scales=(0.0, 1.0))
    dz, _, delta, _ = _solve_kkt(H, torch.ones(2, me, n, dtype=torch.float64), torch.ones(2, n, dtype=torch.float64),
                                 torch.zeros(2, me, dtype=torch.float64),
                                 torch.full((2,), 1e-2, dtype=torch.float64), cfg)
    c = tracing.counters() - before
    assert c["dense_kkt.emergency"] == 1 and c["dense_kkt.lane_iterations"] == 2
    assert delta[0] == cfg.delta_w and delta[1] == pytest.approx(1e3 * 1e-2 + 1e3)
    assert bool(torch.isfinite(dz).all())


def test_iteration_makes_no_tensor_from_host_data_and_no_saved_step(monkeypatch, tmp_path):
    """After the first iteration, the eeParam iteration (the dense step
    included) calls neither ``torch.tensor`` nor ``torch.as_tensor`` /
    ``torch.from_numpy`` on host data nor ``nonzero``: on a card each is a
    copy or a wait, which a CUDA graph's capture refuses.  A saved step of
    the kind is refused (its parameters are not the landing kinds'), with
    the kind's name."""
    from landing_controller_tpu_torch.parallel.stream import _Lanes

    _, mix, _ = _bench()
    q, qd = (torch.as_tensor(a) for a in _drops(mix, 2))
    ss = StreamingSolver(_solver(max_iter=4), batch=2, segment=2, sampler=lambda n: _drops(mix, n),
                         attempt_iters=(4,))
    lanes = ss._iterate(_Lanes.of(*ss.solver.init_lanes(q, qd, 0)))
    with pytest.raises(NotImplementedError, match="eeparam"):
        ss.export_step(str(tmp_path / "step.lcs"), 2)
    with pytest.raises(NotImplementedError, match="eeparam"):
        ss.load_step(str(tmp_path / "step.lcs"), 2)

    def refuse(name, real=None):
        def call(*args, **kw):
            if real is not None and isinstance(args[0], torch.Tensor):
                return real(*args, **kw)
            raise AssertionError(f"torch.{name} on the iteration's path")
        return call

    monkeypatch.setattr(torch, "tensor", refuse("tensor"))
    monkeypatch.setattr(torch, "as_tensor", refuse("as_tensor", torch.as_tensor))
    monkeypatch.setattr(torch, "from_numpy", refuse("from_numpy"))
    monkeypatch.setattr(torch, "nonzero", refuse("nonzero"))
    monkeypatch.setattr(torch.Tensor, "nonzero", refuse("nonzero"))
    after = ss._iterate(lanes)
    assert bool((after.state.it == 2).all())


def test_kind_rules():
    """n_knots is the collocation count, the other guesses are refused, the horizon is the problem's (no
    override), and the kind's defaults are EEParamSolver's."""
    from landing_controller_tpu_torch.problems.eeparam import EEParamConfig, EEParamParams

    with pytest.raises(ValueError, match="collocation"):
        LandingSolver("eeparam", n_knots=21, device="cpu")
    with pytest.raises(ValueError, match="takes \\['reference'\\]"):
        LandingSolver("eeparam", n_knots=10, guess="nn", device="cpu")
    with pytest.raises(ValueError, match="takes \\['reference'\\]"):
        LandingSolver("eeparam", n_knots=10, retry_guess="ballistic", device="cpu")
    with pytest.raises(ValueError, match="horizon"):
        LandingSolver("eeparam", n_knots=10, theta_overrides={"horizon": 0.9}, device="cpu")
    s = LandingSolver("eeparam", n_knots=10, device="cpu")
    assert not s.structured and s.n_knots == 10 and s.params_type is EEParamParams
    assert s.config == EEParamSolver(device="cpu").config
    long = LandingSolver("eeparam", n_knots=12, problem_config=EEParamConfig(horizon=1.0), device="cpu")
    assert long.problem.config.n_colloc == 12
    assert float(long.build_params(np.zeros((1, 6)), np.zeros((1, 6))).horizon[0]) == pytest.approx(1.0)
