"""The port's tools and examples at tiny sizes on the CPU, against the JAX
package's tools (their record keys and settings, read from their sources).

- ``tools.montecarlo_100k``: two pools aggregated into one record with the
  JAX tool's keys; the success-region map has its edges
  (tools/montecarlo_100k.py:119-120) and counts that add up to
  ``n_finished``; the sampler is bench.py's with ``default_rng(2026)``;
- ``tools.train_warmstart`` from saved samples: a run below the sample
  floor writes the network and the record only under ``scratch/``, one
  above it the network to ``--out-dir`` and, its cold row under the floor,
  the record under ``scratch/``; the port's committed network is untouched;
- ``tools.warmstart_compare``, ``tools.eeparam_bench``,
  ``tools.kino_battery``, ``tools.cascade_sweep``: each writes its record
  with the JAX tool's keys;
- ``examples.solve_landing``: the cascade with the HTML viewer, and one
  srbm_lcp solve with the PNG panel; ``parallel.montecarlo --map`` with the
  bins of examples/envelope_sweep.py.

The solves are cut to a few iterations (the tools' ``--max-iter`` or, where a
tool fixes its solver, its configuration capped here), so no outcome is
held, only what the tools build around the solves.
"""

import ast
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import bench as jax_bench
from landing_controller_tpu_torch import api
from landing_controller_tpu_torch import bench as t_bench
from landing_controller_tpu_torch.parallel import montecarlo
from landing_controller_tpu_torch.tools import (cascade_sweep, eeparam_bench, kino_battery,
                                                montecarlo_100k, train_warmstart,
                                                warmstart_compare)
from landing_controller_tpu_torch.examples import solve_landing
from landing_controller_tpu_torch.warmstart.reference import (initial_guess_from_reference,
                                                              sample_drop_scenario)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


def _jax_source(rel):
    with open(os.path.join(ROOT, rel)) as f:
        return ast.parse(f.read())


def _dict_keys(rel, target):
    """The string keys of the dict literal the JAX tool assigns to ``target``."""
    node = next(n for n in ast.walk(_jax_source(rel)) if isinstance(n, ast.Assign)
                and ast.unparse(n.targets[0]) == target and isinstance(n.value, ast.Dict))
    return {k.value for k in node.value.keys}


def _jax_values(rel, *names):
    """The values the JAX tool assigns to ``names`` (numpy expressions)."""
    nodes = [n for n in ast.walk(_jax_source(rel)) if isinstance(n, ast.Assign)
             and ast.unparse(n.targets[0]) in names]
    ns = {"np": np}
    exec(compile(ast.Module(nodes, []), rel, "exec"), ns)
    return [ns[n] for n in names]


def _read(path):
    with open(path) as f:
        return json.load(f)


def _capped(monkeypatch, module, name, max_iter):
    """Cap the iterations of the configurations ``module.name`` builds."""
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **kw: real(*a, **{**kw, "max_iter": max_iter}))


def test_montecarlo_record(monkeypatch, tmp_path):
    _capped(monkeypatch, t_bench, "bench_config", 4)
    stream = t_bench.bench_stream
    monkeypatch.setattr(t_bench, "bench_stream", lambda *a, **kw: stream(*a, segment=4, **kw))
    out = tmp_path / "mc.json"
    montecarlo_100k.main(CPU + ["--n", "4", "--chunk", "2", "--batch", "2", "--out", str(out)])
    rec = _read(out)
    assert _dict_keys("tools/montecarlo_100k.py", "out") <= set(rec)
    assert rec["n_requested"] == rec["n_finished"] == 4 and rec["chunk"] == 2
    assert rec["convergence_rate"] == round(rec["n_converged"] / 4, 4)
    p_edges, v_edges = _jax_values("tools/montecarlo_100k.py", "p_edges", "v_edges")
    region = rec["success_region"]
    assert region["pitch_edges_rad"] == [round(float(x), 4) for x in p_edges]
    assert region["vz_edges_mps"] == [round(float(x), 4) for x in v_edges]
    assert np.asarray(region["count"]).shape == (12, 9)
    assert sum(map(sum, region["count"])) == rec["n_finished"]
    assert rec["card"] == "cpu" and len(rec["terminal_envelope"]["min"] or [0] * 12) == 12
    # the JAX tool's sampler is bench.py's, from default_rng(2026)
    jax_bench.bench_sampler.__defaults__[0][0] = np.random.default_rng(2026)
    sample = t_bench.make_sampler(2026)
    for n in (2, 2):
        for a, b in zip(sample(n), jax_bench.bench_sampler(n)):
            assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def samples_npz(tmp_path_factory):
    """Eight training samples: the reference guesses of eight drops (the
    pipeline trains on any samples of the factory's shapes)."""
    kino = api.LandingSolver("kinodynamic", device="cpu")
    q, qd = sample_drop_scenario(8, torch.Generator().manual_seed(3), device="cpu")
    v = kino.problem.unpack(initial_guess_from_reference(kino.problem, kino.build_params(q, qd)))
    path = tmp_path_factory.mktemp("samples") / "samples.npz"
    np.savez(path, inputs=torch.cat([q[:, 3:6], qd], 1).numpy(), X=v.X.numpy(), U=v.U.numpy(),
             jpos=v.jpos.numpy())
    return str(path)


@pytest.mark.parametrize("floor,published", [(500, set()), (8, {"nn_TO_landing.npz"})])
def test_train_warmstart_gates(samples_npz, tmp_path, floor, published):
    def digest():
        with open(api.DEFAULT_NN_PATH, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    before = digest()
    train_warmstart.main(CPU + ["--data-npz", samples_npz, "--sample-floor", str(floor),
                                "--trials", "1", "--compare-batch", "2", "--max-iter", "2",
                                "--out-dir", str(tmp_path)])
    assert digest() == before
    # the cold row (two iterations) is below the 0.5 floor: the record stays in scratch
    assert set(os.listdir(tmp_path)) == {"scratch"} | published
    scratch = set(os.listdir(tmp_path / "scratch"))
    assert scratch == {"warmstart_bench.json"} | ({"nn_TO_landing.npz"} - published)
    rec = _read(tmp_path / "scratch" / "warmstart_bench.json")
    assert {"batch", "n_trials", "regimes", "n_training_samples", "final_loss"} <= set(rec)
    assert rec["n_training_samples"] == 8 and set(rec["regimes"]) == {
        "nn_eval", "nn_ws", "cold", "srbm_ws"}


def test_warmstart_compare_record(tmp_path):
    out = tmp_path / "ws.json"
    out.write_text(json.dumps({"n_training_samples": 499, "final_loss": 0.01}))
    warmstart_compare.main(CPU + ["--batch", "2", "--trials", "1", "--max-iter", "2",
                                  "--out", str(out)])
    rec = _read(out)
    assert _dict_keys("tools/warmstart_compare.py", "out") <= set(rec)
    assert (rec["n_training_samples"], rec["final_loss"]) == (499, 0.01)
    assert set(rec["regimes"]["nn_eval"]) == {"mean_s", "min_s"}
    for k in ("nn_ws", "cold", "srbm_ws"):
        assert set(rec["regimes"][k]) == {"mean_s", "min_s", "convergence"}


def test_eeparam_record(tmp_path):
    out = tmp_path / "ee.json"
    eeparam_bench.main(CPU + ["--batch", "2", "--trials", "1", "--max-iter", "2",
                              "--out", str(out)])
    rec = _read(out)
    assert _dict_keys("tools/eeparam_bench.py", "out") <= set(rec)
    assert (rec["batch"], rec["n_trials"]) == (2, 1)
    r0, rd0, th0 = eeparam_bench.eeparam_drops(0, 4)
    r = np.random.default_rng(0)  # tools/eeparam_bench.py:68-71, in its order
    np.testing.assert_array_equal(r0[:, 2], r.uniform(0.45, 0.65, 4))
    np.testing.assert_array_equal(rd0[:, 2], -r.uniform(0.5, 1.5, 4))
    np.testing.assert_array_equal(th0[:, 1], r.uniform(-0.2, 0.2, 4))


def test_kino_battery_record(tmp_path):
    out = tmp_path / "kb.json"
    kino_battery.main(["base", "patient", "--batch", "2", "--max-iter", "2", "--out", str(out)]
                      + CPU)
    rec = _read(out)
    assert set(rec["configs"]) == {"base", "patient"}
    for row in rec["configs"].values():
        assert set(row) == {"conv", "it_mean", "it_p50_conv", "wall_s"} and row["it_mean"] <= 2
    names = _jax_values("tools/kino_battery.py", "CONFIGS")[0]
    assert kino_battery.CONFIGS == names


def test_cascade_sweep_record(tmp_path):
    out = tmp_path / "cs.json"
    cascade_sweep.main(CPU + ["--batch", "2", "--batches", "1", "--max-iter", "1", "--seeds",
                              "x_grf,cold", "--out", str(out)])
    rec = _read(out)
    want = {"x_grf@mu1e-2", "x_grf@mu1e-1", "cold@mu1e-1"}
    assert set(rec) == want | {"batch", "n_batches", "card"}
    for k in want:
        assert {"conv", "it"} <= set(rec[k]) and rec[k]["it"] <= 1


def test_cascade_sweep_seeds():
    """Each seed variant mixes the stage-1 blocks into the cold guesses as
    tools/cascade_sweep.py:77-113 does; x_grf and full are the cascade's
    own seed modes."""
    from landing_controller_tpu_torch.warmstart.cascade import cascade_seed
    from landing_controller_tpu_torch.warmstart.reference import ballistic_guess

    srbm, kino = cascade_sweep.cascade_solvers("cpu", max_iter=1)
    q, qd = sample_drop_scenario(2, torch.Generator().manual_seed(5), device="cpu")
    s1 = srbm.solve_batch(q, qd)
    theta = kino.build_params(q, qd)
    jl = (theta.jpos_min[:1], theta.jpos_max[:1])
    prob = kino.problem
    z = {n: cascade_sweep.seed_variant(n, kino, q, qd, s1.X, s1.U, jl)
         for n in cascade_sweep.SEEDS + ("x_blend50",)}
    v = {n: prob.unpack(zn) for n, zn in z.items()}
    vb = prob.unpack(ballistic_guess(prob, theta))
    for n in ("full", "x_grf"):
        torch.testing.assert_close(z[n], cascade_seed(prob, kino.robot_params, theta, s1.X, s1.U,
                                                      n, jl), rtol=0, atol=0)
    assert torch.equal(z["ballistic"], ballistic_guess(prob, theta))
    for n in ("x_only", "x_feet", "x_grf"):
        assert torch.equal(v[n].X, s1.X)
    assert torch.equal(v["x_only"].U, vb.U) and torch.equal(v["x_only"].jpos, vb.jpos)
    assert torch.equal(v["x_feet"].U[..., :12], v["full"].U[..., :12])
    assert torch.equal(v["x_feet"].U[..., 12:], vb.U[..., 12:])
    X_cold = v["cold"].X
    torch.testing.assert_close(v["x_blend50"].X, 0.5 * s1.X + 0.5 * X_cold)
    with pytest.raises(KeyError):
        cascade_sweep.seed_variant("x_bogus", kino, q, qd, s1.X, s1.U, jl)


def test_solve_landing_example(monkeypatch, tmp_path):
    _capped(monkeypatch, api, "IPConfig", 3)
    html, png = tmp_path / "cascade.html", tmp_path / "srbm.png"
    solve_landing.main(CPU + ["--cascade", "--plot", str(html)])
    solve_landing.main(CPU + ["--kind", "srbm_lcp", "--seed", "1", "--plot", str(png)])
    assert "__DATA__" not in html.read_text() and png.stat().st_size > 0


def test_envelope_map(tmp_path):
    path = tmp_path / "map.png"
    montecarlo.main(CPU + ["--drops", "4", "--chunk", "4", "--max-iter", "2", "--map", str(path)])
    assert path.stat().st_size > 0
    pb, vb = _jax_values("examples/envelope_sweep.py", "pb", "vb")
    assert np.array_equal(pb, montecarlo.MAP_PITCH_EDGES)
    assert np.array_equal(vb, montecarlo.MAP_VZ_EDGES)
    ics = np.zeros((5, 12))
    ics[:, 4] = [-2.0, -1.0, 0.0, 0.0, 2.0]  # two outside the edges
    ics[:, 11] = [-5.0, -3.0, -1.0, -1.0, -9.0]
    p_mid, v_mid, rate, count = montecarlo.success_map(ics, np.array([1, 0, 1, 0, 1]))
    assert count.sum() == 5 and count.shape == (12, 12) and len(p_mid) == len(v_mid) == 12
    assert count[0, 0] == 1 and count[0, -1] == 1 and np.nansum(rate * count) == 3
