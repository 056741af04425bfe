"""A whole run of a cell at CPU size, without the look for a card: sound, it
comes out correct; with the timed path broken underneath, once for each
fault a cell of this benchmark can have, it comes out not correct.

(The exchange between chips cannot be left out: every cell runs on one card
and the stream exchanges nothing.  A wrong Newton step or block inverse
alone cannot make a wrong answer: the solver calls a lane converged by its
KKT error and violation, which it evaluates from the problem's own rows
(solver/ip.py:373-383), so such a fault only leaves lanes unconverged and
shows in the rates.  A wrong cost gradient makes wrong answers that the
solver calls converged; ``kkt_error`` catches it.)"""

import dataclasses
import json

import pytest
import torch

from benchmarks.harness import load_cell, run_cell

SEED = 2**31 + 99


def quiet(*args, **kwargs):
    pass


def run(tiny_bench, hooks=None, cell="srbm_lcp.b64", seconds=3.0, control=False):
    bench, traffic = tiny_bench
    return run_cell(cell, SEED, seconds, False, device="cpu", hooks=hooks, bench_path=bench,
                    traffic_dir=traffic, log=quiet, control=control)


def state_unchanged(ss):
    ss._iterate = lambda lanes: lanes


def half_the_lanes(ss):
    step = ss._iterate

    def iterate(lanes):
        new = step(lanes)
        B = lanes.state.z.shape[0]
        keep = torch.arange(B) >= B // 2

        def pick(a, b):
            if not isinstance(a, torch.Tensor) or a.dim() == 0 or a.shape[0] != B:
                return a
            return torch.where(keep.reshape((B,) + (1,) * (a.dim() - 1)), b, a)

        fields = {f.name: pick(getattr(new.state, f.name), getattr(lanes.state, f.name))
                  for f in dataclasses.fields(new.state)}
        return dataclasses.replace(new, state=dataclasses.replace(new.state, **fields))

    ss._iterate = iterate


def altered(attr, how):
    def hook(ss):
        harvest = ss._harvest

        def harvest_altered(pool, carry, P):
            out = harvest(pool, carry, P)
            return dataclasses.replace(out, **{attr: how(getattr(out, attr))})

        ss._harvest = harvest_altered

    return hook


def bump_knot0(z):
    """Every harvested trajectory's first x position moved by 5 m.  At this
    size no drop converges in its few iterations, and a change shows only
    where it exceeds the iterate's own violation (about 1.5); at the cells'
    size a converged answer's violation is below 1e-4."""
    z = z.clone()
    z[:, 0] += 5.0
    return z


def cost_target_moved(solver):
    """The program's cost gradient taken at a terminal height target 5 cm
    off: the solver converges, to the optimum of another cost."""
    cost = solver.problem.cost

    def moved(z, theta):
        shift = torch.zeros_like(theta.x_ref)
        shift[:, -1, 2] = 0.05
        return cost(z, dataclasses.replace(theta, x_ref=theta.x_ref + shift))

    solver.problem.cost = moved


def halve_violation(res):
    res = res.clone()
    res[3] *= 0.5
    return res


@pytest.mark.parametrize("cell", ["srbm_lcp.b64", "kinodynamic.b512"])
def test_sound_run_is_correct(tiny_bench, cell):
    result, checks = run(tiny_bench, cell=cell)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    bench, traffic = tiny_bench
    assert set(result["metrics"]) == {m["name"] for m in load_cell(cell, bench, traffic).end_to_end}
    assert {"converged_solves_per_s", "batch_iteration_ms", "setup_s"} <= set(result["metrics"])
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault,check", [
    (state_unchanged, "answered"),
    (half_the_lanes, "overdue"),
    (altered("res_z", bump_knot0), "viol_gap"),
    (altered("res", halve_violation), "viol_gap"),
    (altered("res_z", lambda z: z * float("nan")), "nonfinite"),
])
def test_fault_is_not_correct(tiny_bench, fault, check):
    result, checks = run(tiny_bench, hooks={"stream": fault})
    assert not result["correct"] and json.loads(json.dumps(result, allow_nan=False)) == result
    value, limit = checks[check]
    assert value > limit, checks


def test_converged_answers_pass_and_the_control_fails(solve_bench):
    """Drops converge at this size; the program's answers pass every check,
    the KKT error among them, and the control (the TF32 reference in the
    program's place) fails on the same answers."""
    result, checks = run(solve_bench, seconds=12.0, control=True)
    mine = result["program_checks"]
    assert all(mine[k] <= lim for k, (_, lim) in checks.items()), mine
    assert 0 < mine["kkt_error"], mine  # converged drops were judged
    assert not result["correct"]
    assert checks["kkt_error"][0] > checks["kkt_error"][1] and checks["viol_gap"][0] > checks["viol_gap"][1]


def test_wrong_cost_is_not_correct(solve_bench):
    result, checks = run(solve_bench, hooks={"solver": cost_target_moved}, seconds=12.0)
    assert not result["correct"]
    value, limit = checks["kkt_error"]
    assert value > limit, checks
    # the answers are feasible: only the KKT error sees the fault
    assert checks["viol_gap"][0] <= checks["viol_gap"][1] and checks["conv_viol"][0] <= checks["conv_viol"][1]
