"""The plain reference against the port on the CPU, per configuration: the
parameters' rows, each cold guess, the row scales, and the violation the
solver reports after a few iterations of a real solve."""

import os

import numpy as np
import pytest
import torch

from benchmarks.harness import HERE, build_solver, draw, load_cell, load_module

CELLS = ["srbm_lcp.b64", "kinodynamic.b512"]


def setup(cell_name, n=4, seed=2**31 + 7):
    cell = load_cell(cell_name)
    cfg = cell.config
    ref = load_module(os.path.join(HERE, "reference", cfg["name"] + ".py"), "t_ref_" + cfg["name"]).make(cfg, "cpu")
    solver = build_solver(cfg, "cpu")
    q, qd = draw(cell.mix, seed, n, 0)
    return cfg, ref, solver, q, qd


@pytest.mark.parametrize("cell", CELLS)
def test_rows_and_guesses(cell):
    """Against the port built in float64, so both sides round alike."""
    cfg, ref, _, q, qd = setup(cell)
    solver = build_solver({**cfg, "dtype": "float64"}, "cpu")
    th_p = solver.build_params(q, qd)
    th = ref.params(torch.as_tensor(q, dtype=torch.float64), torch.as_tensor(qd, dtype=torch.float64))
    for v, name in enumerate([cfg["guess"]] + cfg["retry_guess"]):
        z0 = solver._cold_guess(th_p, v)
        np.testing.assert_allclose(ref.guess(name, th).numpy(), z0.numpy(), rtol=1e-12, atol=1e-12)
    gen = torch.Generator().manual_seed(1)
    z = solver._cold_guess(th_p, 0) + 0.01 * torch.randn(q.shape[0], ref.n_vars, generator=gen, dtype=torch.float64)
    for port_fn, ref_fn in ((solver.problem.cost, ref.cost), (solver.problem.eq, ref.eq),
                            (solver.problem.ineq, ref.ineq)):
        rp, rr = port_fn(z, th_p), ref_fn(z, th)
        assert rr.shape == rp.shape
        np.testing.assert_allclose(rr.numpy(), rp.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("cell", CELLS)
def test_violation_of_a_short_solve(cell):
    """A few iterations of the program from each cold-guess family: the
    reference's violation of the iterate equals the one the program reports."""
    cfg, ref, solver, q, qd = setup(cell)
    names = [cfg["guess"]] + cfg["retry_guess"]
    for v in range(len(names)):
        snlp, st = solver.init_lanes(q, qd, v)
        prog = solver.program(snlp)
        for _ in range(3):
            st = prog.step(st)
        res = prog.finish(st)
        z = snlp.from_scaled(res.z).double()
        mine = ref.violation(torch.as_tensor(q, dtype=torch.float64), torch.as_tensor(qd, dtype=torch.float64),
                             z, names)
        rep = res.constr_viol.double().numpy()
        gap = np.abs(mine[:, v].numpy() - rep) / np.maximum(1.0, mine[:, v].numpy())
        assert gap.max() < 1e-5, (names[v], rep, mine)
