"""The port's convergence diagnostics (``tools.conv_battery``,
``fail_taxonomy``, ``diag_conv``, ``iter_bench``, ``tune_sweep``) on the
CPU against the JAX package's tools/*.py of the same names:

- the shared sampler ``legacy_ics`` bit-equal to each JAX tool's
  ``make_ics`` (the tools are imported by path: their module level imports
  only numpy);
- each tool's positionals, configurations and run lists equal to the JAX
  tool's, read from its source;
- fail_taxonomy's batched group reduction against the JAX tool's per-lane
  ``lane_groups`` (fail_taxonomy.py:71-81, rebuilt here on the JAX
  problem) at f64, on perturbed ballistic guesses, no solve;
- diag_conv's raw solve against ``LandingSolver.solve_batch``;
- each tool's record with the JAX tool's keys and summary lines (that each
  raises without a card is held with the other entry points in
  tests/test_torch_bench.py).

The f32 solves are cut to a few iterations, so no outcome is held there.
"""

import ast
import importlib.util
import inspect
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.api import LandingSolver as JaxLandingSolver
from landing_controller_tpu_torch.api import LandingSolver
from landing_controller_tpu_torch.solver.ip import IPConfig
from landing_controller_tpu_torch.solver.scaling import landing_z_scale
from landing_controller_tpu_torch.tools import (conv_battery, diag_conv, fail_taxonomy,
                                                iter_bench, tune_sweep)
from landing_controller_tpu_torch.tools.common import kino_config, legacy_ics, srbm_config
from landing_controller_tpu_torch.warmstart.reference import ballistic_guess

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
TOOLS = {"conv_battery": conv_battery, "diag_conv": diag_conv, "fail_taxonomy": fail_taxonomy,
         "iter_bench": iter_bench, "tune_sweep": tune_sweep}


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _source(name):
    with open(os.path.join(ROOT, "tools", f"{name}.py")) as f:
        return ast.parse(f.read())


def _function(tree, name):
    return next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)


def _assigned(node, target):
    """The value node of the first assignment to ``target`` under ``node``."""
    return next(n.value for n in ast.walk(node) if isinstance(n, ast.Assign)
                and ast.unparse(n.targets[0]) == target)


def _literal(node):
    """ast.literal_eval, with ``dict(k=v, ...)`` read as a dict."""
    if isinstance(node, ast.Call) and ast.unparse(node.func) == "dict":
        return {k.arg: _literal(k.value) for k in node.keywords}
    if isinstance(node, ast.Dict):
        return {_literal(k): _literal(v) for k, v in zip(node.keys, node.values)}
    return ast.literal_eval(node)


def _kwargs(call, **names):
    """The keywords of a call such as ``dict(...)`` or ``IPConfig(...)``, each
    a literal or one of ``names``."""
    return {k.arg: names[k.value.id] if isinstance(k.value, ast.Name) else
            ast.literal_eval(k.value) for k in call.keywords}


def _argv_defaults(tree):
    """The JAX tool's positionals' defaults, ``x = ... if len(sys.argv) > k
    else default``, in the order of k."""
    found = {}
    for n in ast.walk(tree):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.IfExp) \
                and "sys.argv" in ast.unparse(n.value.test):
            found[n.value.test.comparators[0].value] = ast.literal_eval(n.value.orelse)
    return [found[k] for k in sorted(found)]


def _slice_stop(tree, name):
    """k of the JAX tool's ``name[:k]``."""
    return next(n.slice.upper.value for n in ast.walk(tree) if isinstance(n, ast.Subscript)
                and ast.unparse(n.value) == name and isinstance(n.slice, ast.Slice))


def _read(path):
    with open(path) as f:
        return json.load(f)


# ---- the sampler


@pytest.mark.parametrize("name", sorted(TOOLS))
@pytest.mark.parametrize("seed", [0, 7])
def test_legacy_ics_is_the_jax_tools_sampler(name, seed):
    make_ics = _jax_tool(name).make_ics
    want = make_ics(5, seed=seed) if name not in ("diag_conv", "tune_sweep") else \
        make_ics(5, seed=seed, sampler="legacy")
    for a, b in zip(legacy_ics(5, seed), want):
        b = np.asarray(b)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


# ---- positionals, configurations and run lists


def test_conv_battery_runs_and_config():
    tree = _source("conv_battery")
    main = _function(tree, "main")
    quick = ast.literal_eval(_assigned(main, "runs"))
    extra = next(n for n in ast.walk(main) if isinstance(n, ast.AugAssign))
    assert conv_battery.QUICK_RUNS == [tuple(r) for r in quick]
    assert conv_battery.FULL_RUNS == conv_battery.QUICK_RUNS + ast.literal_eval(extra.value)
    base = _kwargs(_assigned(_function(tree, "run_config"), "base"))
    for _, kw in conv_battery.FULL_RUNS:
        assert srbm_config(**kw) == IPConfig(**{**base, **kw})
    args = conv_battery.parse_args([])
    assert [args.mode, args.B] == _argv_defaults(tree) == ["quick", 64]
    out = _assigned(_function(tree, "run_config"), "out")
    assert conv_battery.RUN_KEYS == tuple(k.arg for k in out.keywords)


def test_iter_bench_runs_and_config():
    tree = _source("iter_bench")
    main = _function(tree, "main")
    full_if = next(n for n in main.body if isinstance(n, ast.If))

    def calls(nodes):
        return [(c.args[0].value, c.args[1].value, ast.literal_eval(c.args[2]))
                for node in nodes for c in ast.walk(node)
                if isinstance(c, ast.Call) and ast.unparse(c.func) == "run_config"]

    quick = calls(n for n in main.body if n is not full_if)
    assert iter_bench.QUICK_RUNS == quick
    assert iter_bench.FULL_RUNS == quick + calls(full_if.body)
    run_config = _function(tree, "run_config")
    base = _kwargs(_assigned(run_config, "base"), n_iters=200)
    for _, _, kw in iter_bench.FULL_RUNS:
        assert srbm_config(max_iter=200, **kw) == IPConfig(**{**base, **kw})
    jax_defaults = {a.arg: ast.literal_eval(d) for a, d in
                    zip(run_config.args.args[-3:], run_config.args.defaults)}
    port = inspect.signature(iter_bench.run_config).parameters
    assert jax_defaults == {k: port[k].default for k in jax_defaults}
    assert _assigned(run_config, "seg").value == iter_bench.SEGMENT
    assert iter_bench.parse_args([]).mode == _argv_defaults(tree)[0] == "quick"
    out = _assigned(run_config, "out")
    assert iter_bench.RUN_KEYS == tuple(k.arg for k in out.keywords)


def test_tune_sweep_configs():
    tree = _source("tune_sweep")
    assert tune_sweep.CONFIGS == _literal(_assigned(tree, "CONFIGS"))
    base = _kwargs(_assigned(_function(tree, "run_cfg"), "base"))
    assert kino_config() == IPConfig(**base)
    for kw in tune_sweep.CONFIGS.values():
        kw = {k: v for k, v in kw.items() if not k.startswith("_")}
        assert kino_config(**kw) == IPConfig(**{**base, **kw})


def test_fail_taxonomy_and_diag_conv_configs():
    ft = _source("fail_taxonomy")
    assert [fail_taxonomy.parse_args([]).B, fail_taxonomy.parse_args([]).mu_strategy] == \
        _argv_defaults(ft) == [128, "loqo"]
    for mu in ("loqo", "monotone"):
        cfg = _kwargs(_assigned(_function(ft, "main"), "cfg"), mu=mu)
        assert srbm_config(mu_strategy=mu) == IPConfig(**cfg)
    assert _slice_stop(ft, "bad") == fail_taxonomy.MAX_LANES
    dc = _source("diag_conv")
    args = diag_conv.parse_args([])
    defaults = [args.B, args.backend, args.mu_strategy, args.sampler]
    assert defaults == _argv_defaults(dc) == [64, "scan", "monotone", "legacy"]
    for backend, mu in (("scan", "monotone"), ("cri", "loqo")):
        cfg = _kwargs(_assigned(_function(dc, "main"), "cfg"), backend=backend, mu_strategy=mu)
        assert kino_config(kkt_backend=backend, mu_strategy=mu) == IPConfig(**cfg)
    assert args.max_iter == cfg["max_iter"]
    assert _slice_stop(dc, "bad") == diag_conv.N_LANES


# ---- fail_taxonomy's group reduction against the JAX tool's per lane


def _jax_lane_groups(js, z, q0, qd0):
    """fail_taxonomy.py:66-81 on the JAX problem."""
    prob = js.problem
    labels = prob.ineq_row_labels()
    group_of = [lab.split(":")[-1].split("[")[0] for lab in labels]
    n = prob.config.n_knots
    theta = js.build_params(q0, qd0)
    E = np.asarray(prob.eq(z, theta))
    g = np.asarray(prob.ineq(z, theta))
    out = {}
    out["eq_head"] = np.abs(E[:12]).max()
    out["eq_dyn"] = np.abs(E[12 : 12 + 12 * (n - 1)]).max()
    gv = np.maximum(-g, 0.0)
    for lab, v in zip(group_of, gv):
        out[lab] = max(out.get(lab, 0.0), float(v))
    return out


def test_lane_groups_match_jax():
    ts = LandingSolver("srbm_lcp", dtype=torch.float64, guess="ballistic", device="cpu")
    js = JaxLandingSolver("srbm_lcp", dtype=jnp.float64, guess="ballistic")
    assert ts.problem.ineq_row_labels() == js.problem.ineq_row_labels()
    q, qd = (a.astype(np.float64) for a in legacy_ics(3, seed=4))
    theta = ts.build_params(q, qd)
    rng = np.random.default_rng(12)
    z = ballistic_guess(ts.problem, theta).numpy()
    z = z + 0.05 * rng.standard_normal(z.shape) * landing_z_scale(ts.problem)
    names, index = fail_taxonomy.group_index(ts.problem)
    got = fail_taxonomy.lane_groups(ts.problem, torch.as_tensor(z), theta, index).numpy()
    assert got.shape == (3, len(names))
    for i in range(3):
        want = _jax_lane_groups(js, jnp.asarray(z[i]), jnp.asarray(q[i]), jnp.asarray(qd[i]))
        assert list(want) == names
        np.testing.assert_allclose(got[i], list(want.values()), rtol=1e-10, atol=1e-14)
        dom = max(want.items(), key=lambda kv: kv[1])[0]
        assert names[int(np.argmax(got[i]))] == dom
        assert sum(v > 0 for v in want.values()) >= 4  # the perturbation violates several groups


# ---- diag_conv's raw solve


@pytest.mark.parametrize("backend", ["scan", "cri"])
def test_raw_solve_matches_solve_batch(backend):
    cfg = kino_config(max_iter=6, kkt_backend=backend)
    solver = LandingSolver("srbm_lcp", dtype=torch.float32, config=cfg, device="cpu")
    q, qd = legacy_ics(2, seed=3)
    res = diag_conv.raw_solve(solver, q, qd)
    sol = solver.solve_batch(q, qd)
    assert torch.equal(res.converged, sol.converged)
    assert torch.equal(res.iterations, sol.iterations) and int(res.iterations.max()) <= 6
    # the same operations in the same order: equal bit for bit
    assert torch.equal(res.kkt_error, sol.kkt_error) and torch.equal(res.z * solver._z_scale, sol.z)
    assert res.kkt_history.shape == res.mu_history.shape == res.alpha_history.shape == (2, 6)
    its = res.iterations.numpy()
    for lane in range(2):  # the ring buffers hold every iteration run
        assert bool((res.mu_history[lane, :its[lane]] > 0).all())


# ---- the records and summary lines


def test_conv_battery_record(tmp_path, capsys):
    out = tmp_path / "cb.json"
    conv_battery.main(["quick", "2", "--max-iter", "3", "--out", str(out)] + CPU)
    rec = _read(out)
    assert (rec["mode"], rec["B"], rec["card"]) == ("quick", 2, "cpu")
    assert [r["name"] for r in rec["runs"]] == [n for n, _ in conv_battery.QUICK_RUNS]
    for r in rec["runs"]:
        assert set(conv_battery.RUN_KEYS) <= set(r) and r["iters_p90"] <= 3
        assert r["batch_iterations"] == 3 and r["qd_inverse_launches"] == 0  # CPU: plain version
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("{") for line in lines) == 5 and "== summary ==" in lines
    assert re.fullmatch(r" +baseline-200: conv=\d\.\d{3} it_mean=3\.0 p50=3 p90=3 "
                        r"kkt_only_fails=\d/\d", lines[lines.index("== summary ==") + 1])


def test_fail_taxonomy_record(tmp_path, capsys):
    out = tmp_path / "ft.json"
    fail_taxonomy.main(["3", "--max-iter", "3", "--out", str(out)] + CPU)
    rec = _read(out)
    names, _ = fail_taxonomy.group_index(LandingSolver("srbm_lcp", device="cpu").problem)
    assert set(fail_taxonomy.RECORD_KEYS) <= set(rec)
    assert (rec["B"], rec["mu"], rec["max_iter"], rec["batch_iterations"]) == (3, "loqo", 3, 3)
    assert len(rec["failed_lanes"]) == 3  # three iterations converge no drop
    for lane in rec["failed_lanes"]:
        assert lane["group"] in names and list(lane["groups"]) == names
        assert lane["viol"] == max(lane["groups"].values()) and lane["it"] <= 3
    assert sum(rec["dominant_group_counts"].values()) == 3
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"B=3 mu=loqo conv=0\.000 iters_mean=3", lines[0])
    assert lines[1] == "-- failed lanes (dominant violated group) --"
    assert re.fullmatch(r"lane +\d+: \w+ +viol=\d+\.\d{3} it=  3 pitch=[+-]\d\.\d\d roll=[+-]\d\.\d\d "
                        r"vz=[+-]\d\.\d\d wx=[+-]\d\.\d\d wy=[+-]\d\.\d\d kkt=\d\.\de[+-]\d\d",
                        lines[2])
    assert lines[5].startswith("dominant-group counts: {")
    assert lines[6].startswith("severity |pitch|+0.2|vz|: failed mean=")


def test_diag_conv_record(tmp_path, capsys):
    out = tmp_path / "dc.json"
    diag_conv.main(["2", "cri", "loqo", "reference", "--max-iter", "8", "--out", str(out)] + CPU)
    rec = _read(out)
    assert set(diag_conv.RECORD_KEYS) <= set(rec)
    assert (rec["B"], rec["backend"], rec["mu"], rec["sampler"]) == (2, "cri", "loqo", "reference")
    assert rec["kkt_at"] == [2, 4, 6, 7] and rec["it_max"] <= 8
    assert rec["batch_iterations"] == 2 * 8  # two passes
    assert len(rec["lanes"]) == 2 and all(len(lane["kkt"]) == 4 for lane in rec["lanes"])
    assert np.isfinite([lane["mu_end"] for lane in rec["lanes"]]).all()
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"B=2 backend=cri mu=loqo sampler=reference wall=\d+\.\d\ds conv=0\.000 "
                        r"it p50/p90/max=8/8/8 solves/s=0\.00", lines[0])
    assert re.fullmatch(r"lane 0: kkt\[2,4,6,7\]=(\d\.\de[+-]\d\d,){3}\d\.\de[+-]\d\d "
                        r"mu_end=\d\.\de[+-]\d\d alpha: frac<1e-3=\d\.\d\d "
                        r"last20_mean=\d\.\d\de[+-]\d\d", lines[1])


def test_iter_bench_record(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(iter_bench, "QUICK_RUNS", [(n, 2, kw) for n, _, kw in iter_bench.QUICK_RUNS])
    out = tmp_path / "ib.json"
    iter_bench.main(["--max-iter", "4", "--out", str(out)] + CPU)
    rec = _read(out)
    assert (rec["mode"], rec["n_iters"], rec["card"]) == ("quick", 4, "cpu")
    assert [r["name"] for r in rec["runs"]] == [n for n, _, _ in iter_bench.QUICK_RUNS]
    for r in rec["runs"]:
        assert set(iter_bench.RUN_KEYS) <= set(r) and r["B"] == 2
        assert r["batch_iterations"] == 4 and r["iters_p90"] <= 4  # two segments of 2
        assert r["ms_per_iter_batch"] > 0 and r["us_per_iter_lane"] > 0
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r" *r2-bench-baseline: +\d+\.\d\d ms/iter \(B=2\)  conv=\d\.\d{3} p50=4 "
                        r"est=\d+\.\d+/s compile=\d+\.\ds", lines[lines.index("== summary ==") + 1])


def test_tune_sweep_record(monkeypatch, tmp_path, capsys):
    for name in ("lean", "refsampler"):
        monkeypatch.setitem(tune_sweep.CONFIGS, name, {**tune_sweep.CONFIGS[name], "_B": 2})
    out = tmp_path / "ts.json"
    tune_sweep.main(["lean", "refsampler", "--max-iter", "3", "--out", str(out)] + CPU)
    rec = _read(out)
    assert list(rec["configs"]) == ["lean", "refsampler"]
    assert rec["configs"]["refsampler"]["sampler"] == "reference"
    for r in rec["configs"].values():
        assert r["B"] == 2 and r["max_iter"] == 3 and r["it_p90"] <= 3
        assert r["batch_iterations"] == 2 * 3  # the first pass and the timed one
        assert set(tune_sweep.RUN_KEYS) <= set(r)
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"lean {36} B=   2 wall= +\d+\.\d\ds comp= +\d+s conv=\d\.\d{3} "
                        r"it p50/p90=  3/  3 solves/s= +\d+\.\d\d", lines[0])
