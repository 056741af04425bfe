"""The port's bench (``landing_controller_tpu_torch.bench``) against the JAX
package's ``bench.py`` (CPU).

- the two pools it streams (warm-up, then measured) are bit-equal to two
  successive calls of bench.py's ``bench_sampler(384)``, and its stream and
  solver have bench.py's settings (a stub ``StreamingSolver.run`` records
  them, so no pool is solved);
- its IPConfig equals the one bench.py's worker builds (bench.py:345-376,
  read from the file and evaluated with no ``BENCH_*`` variable set), field
  by field;
- ``main`` at B=4 over a pool of 8 prints snapshot rows, the "#" lines and
  a last row with bench.py's keys except ``vs_baseline``;
- every entry point of the port raises without a card unless given
  ``--device cpu``.

bench.py's top level imports no JAX; only its worker does.
"""

import ast
import dataclasses
import importlib
import json
import os
import types

import numpy as np
import pytest
import torch

import bench as jax_bench
from landing_controller_tpu.solver import IPConfig as JaxIPConfig
from landing_controller_tpu_torch import bench
from landing_controller_tpu_torch.parallel.stream import StreamingSolver
from landing_controller_tpu_torch.warmstart.reference import DT_PRODUCTION

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _worker_assignments():
    """bench.py's worker_main: {target source: the assignment node}."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    worker = next(n for n in tree.body
                  if isinstance(n, ast.FunctionDef) and n.name == "worker_main")
    return {ast.unparse(n.targets[0]): n for n in ast.walk(worker) if isinstance(n, ast.Assign)}


def _row_keys():
    """The keys of bench.py's row: the snapshot dict, its ``extra`` and
    ``compile_s`` (bench.py:300-314, 417-421, 455), less ``vs_baseline``."""
    nodes = _worker_assignments()
    keys = {k.value for k in nodes["best[0]"].value.keys if k is not None}
    keys |= {k.value for k in nodes["extra"].value.keys} | {"compile_s"}
    return keys - {"vs_baseline"}


def test_bench_config_is_bench_py():
    nodes = _worker_assignments()
    ns = {"os": types.SimpleNamespace(environ={}), "IPConfig": JaxIPConfig}
    exec(compile(ast.Module([nodes["ladder"], nodes["cfg"]], []), "bench.py", "exec"), ns)
    ours = bench.bench_config()
    for f in dataclasses.fields(JaxIPConfig):
        assert getattr(ours, f.name) == getattr(ns["cfg"], f.name), f.name


def test_pools_and_settings_are_bench_py(monkeypatch, capsys):
    runs = []

    def recording_run(self, n, max_wall_s=None, progress_cb=None):
        q, qd = self.sampler(n)
        runs.append(dict(q=q, qd=qd, max_wall_s=max_wall_s, stream=self))
        stats = {"n_finished": n, "n_converged": n, "converged_per_sec": 1.0, "wall_s": 1.0,
                 "convergence_rate": 1.0, "iters_p50": 50.0, "iters_p90": 90.0}
        if progress_cb is not None:
            progress_cb(stats)
        return stats

    monkeypatch.setattr(StreamingSolver, "run", recording_run)
    assert bench.main(["--device", "cpu"]) == 0
    jax_bench.bench_sampler.__defaults__[0][0] = None  # a fresh default_rng(0)
    for run in runs:
        q, qd = jax_bench.bench_sampler(384)
        assert run["q"].dtype == q.dtype and np.array_equal(run["q"], q)
        assert np.array_equal(run["qd"], qd)
    assert [r["max_wall_s"] for r in runs] == [0.0, None]  # the warm-up, then the whole pool
    ss = runs[1]["stream"]
    assert (ss.batch, ss.segment, ss.attempt_iters, ss.collect_z) == (64, 25, (100, 150), False)
    s = ss.solver
    assert (s.kind, s.guess, s.retry_guess, s.dtype) == ("srbm_lcp", "ballistic", ("nn",),
                                                         torch.float32)
    assert s.config == bench.bench_config() and s.structured
    np.testing.assert_array_equal(s.theta_overrides["dt"], DT_PRODUCTION.astype(np.float32))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["n_scenarios"] == 384


def test_main_prints_snapshots_then_the_row(capsys):
    assert bench.main(["--device", "cpu", "--batch", "4", "--n", "8", "--segment", "5",
                       "--attempt-iters", "5,5"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    row = json.loads(lines[-1])
    assert set(row) == _row_keys()
    assert row["n_scenarios"] == 8 and (row["batch"], row["segment"]) == (4, 5)
    assert len(rows) >= 2 and rows[-2]["n_scenarios"] == 8  # the last segment's snapshot
    assert [r["n_scenarios"] for r in rows] == sorted(r["n_scenarios"] for r in rows)
    assert "# card: cpu" in lines
    run = json.loads(next(line for line in lines if line.startswith("# measured run: "))[16:])
    assert run["batch_iterations"] == 5 * run["segments"] and run["qd_inverse_launches"] == 0


ENTRY_POINTS = ("bench", "tools.montecarlo_100k", "tools.train_warmstart",
                "tools.warmstart_compare", "tools.eeparam_bench", "tools.kino_battery",
                "tools.cascade_sweep", "examples.solve_landing", "parallel.montecarlo",
                "tools.conv_battery", "tools.diag_conv", "tools.fail_taxonomy", "tools.iter_bench",
                "tools.tune_sweep")


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_need_a_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    module = importlib.import_module(f"landing_controller_tpu_torch.{name}")
    argv = ["--out-dir", str(tmp_path)] if name == "tools.train_warmstart" else []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)
    assert not os.listdir(tmp_path)
