"""The port's one-process-per-card layer against the JAX package (CPU).

- ``monte_carlo_envelope`` on two gloo ranks (``torch.multiprocessing``,
  CPU): every rank samples its rows from seed ``seed * 1000003 + rank`` and
  returns them; their solutions are held against the JAX package's
  ``solve_batch`` of the same returned ``ics`` (srbm_lcp, N=11, f64,
  ``kkt_backend`` "cri" here and "cri_ref" there): converged masks equal,
  terminal states of converged lanes to 1e-8; the global converged count
  on both ranks equals the sum of the ranks' masks; n_scenarios is rounded
  up to whole chunks;
- ``envelope_stats`` against JAX's, without a mesh and with one (two ranks
  here, JAX's 8-device scenario mesh there), to 1e-12;
- one process: the mesh without a process group, ``solve_sharded``'s
  reduced statistics, the multihost helpers, a sweep with the native pool
  and a result log read back record by record, and the sweep program.
"""

import os
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from landing_controller_tpu.api import LandingSolver as JaxLandingSolver
from landing_controller_tpu.parallel import batch as j_batch
from landing_controller_tpu.solver import IPConfig as JaxIPConfig
from landing_controller_tpu_torch.api import LandingSolver
from landing_controller_tpu_torch.parallel import (envelope_stats, global_scenario_batch,
                                                   local_shards, make_scenario_mesh, montecarlo,
                                                   replicated_value, solve_sharded)
from landing_controller_tpu_torch.parallel.batch import backend_for
from landing_controller_tpu_torch.parallel.montecarlo import monte_carlo_envelope
from landing_controller_tpu_torch.runtime import ResultLog, read_result_log
from landing_controller_tpu_torch.solver.ip import IPConfig
from landing_controller_tpu_torch.warmstart.reference import sample_drop_scenario

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

N = 11
CFG_KW = dict(max_iter=40, hessian_mode="hybrid", mu_init=0.3, kappa_mu=0.5, mu_min=1e-6, tol=1e-4,
              sigma_max=1e8, refine_steps=1, relax_scale=1.0, delta_c=1e-6,
              ladder_scales=(0.0, 1.0), n_linesearch=4, mu_strategy="loqo", corrector=1)
SEED = 3


def _solver(**kw):
    cfg = IPConfig(kkt_backend="cri", **{**CFG_KW, **kw})
    return LandingSolver("srbm_lcp", n_knots=N, dtype=torch.float64, config=cfg,
                         guess="ballistic", device="cpu")


def _envelope_data():
    rng = np.random.default_rng(4)
    X = rng.standard_normal((8, 5, 12))
    conv = np.array([1, 0, 1, 1, 0, 0, 1, 0], bool)
    return X, conv


def _rank(rank, world, port, out_dir):
    """One gloo rank: the sweep, and envelope_stats over the mesh."""
    torch.set_num_threads(1)
    dist.init_process_group(backend_for("cpu"), init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = make_scenario_mesh("cpu")
        res = monte_carlo_envelope(_solver(), 5, chunk=6, seed=SEED, mesh=mesh,
                                   use_native_pool=False)
        X, conv = _envelope_data()
        rows = slice(4 * rank, 4 * rank + 4)
        env = envelope_stats(torch.as_tensor(X[rows]), torch.as_tensor(conv[rows]), mesh)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), world=mesh.world_size, rank=mesh.rank,
                 ics=res["ics"], converged=res["converged"], xT=res["terminal_states"],
                 n_converged=res["n_converged"], n_scenarios=res["n_scenarios"],
                 **{k: v.numpy() for k, v in env.items()})
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_match_jax(tmp_path):
    ranks = torch.multiprocessing.spawn(_rank, args=(2, _free_port(), str(tmp_path)), nprocs=2,
                                        join=False)
    # each rank's drops, from its seed: JAX solves them while the ranks run
    ics = []
    for r in range(2):
        q, qd = sample_drop_scenario(3, torch.Generator().manual_seed(SEED * 1000003 + r),
                                     device="cpu")
        ics.append(np.concatenate([q.numpy(), qd.numpy()], 1))
    ics = np.concatenate(ics)
    jsolver = JaxLandingSolver("srbm_lcp", n_knots=N, dtype=jnp.float64, guess="ballistic",
                               config=JaxIPConfig(kkt_backend="cri_ref", **CFG_KW))
    sol = jsolver.solve_batch(jnp.asarray(ics[:, :6], jnp.float64),
                              jnp.asarray(ics[:, 6:], jnp.float64))
    while not ranks.join():
        pass

    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for r, d in enumerate(ranks):
        assert int(d["world"]) == 2 and int(d["rank"]) == r
        assert int(d["n_scenarios"]) == 6  # 5 rounded up to a whole chunk of 6
        np.testing.assert_array_equal(d["ics"], ics[3 * r:3 * r + 3])  # the rank's rows
    conv = np.concatenate([d["converged"] for d in ranks])
    assert [int(d["n_converged"]) for d in ranks] == [int(conv.sum())] * 2
    np.testing.assert_array_equal(conv, np.asarray(sol.converged))
    assert conv.any()
    xT = np.concatenate([d["xT"] for d in ranks])
    np.testing.assert_allclose(xT[conv], np.asarray(sol.X)[conv, -1], rtol=0, atol=1e-8)

    X, c = _envelope_data()
    want = j_batch.envelope_stats(jnp.asarray(X), jnp.asarray(c),
                                  mesh=j_batch.make_scenario_mesh())
    for d in ranks:
        np.testing.assert_allclose(d["success_rate"], np.asarray(want["success_rate"]), atol=1e-12)
        for k in ("term_state_min", "term_state_max"):
            np.testing.assert_allclose(d[k], np.asarray(want[k]), rtol=0, atol=1e-12)


def test_envelope_stats_without_a_mesh_match_jax():
    X, conv = _envelope_data()
    got = envelope_stats(torch.as_tensor(X), torch.as_tensor(conv))
    want = j_batch.envelope_stats(jnp.asarray(X), jnp.asarray(conv))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-12)
    # no converged lane: the empty-envelope sentinels, as in JAX
    got0 = envelope_stats(torch.as_tensor(X), torch.zeros(8, dtype=torch.bool))
    want0 = j_batch.envelope_stats(jnp.asarray(X), jnp.zeros(8, bool))
    np.testing.assert_array_equal(got0["term_state_min"].numpy(),
                                  np.asarray(want0["term_state_min"]))


def test_one_process_mesh_and_sharded_solve():
    mesh = make_scenario_mesh("cpu")
    assert (mesh.world_size, mesh.rank, mesh.device.type, mesh.distributed) == (1, 0, "cpu", False)
    assert backend_for("cuda:1") == "nccl" and backend_for("cpu") == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_scenario_mesh()  # cuda:LOCAL_RANK needs a card
    q, qd = sample_drop_scenario(3, torch.Generator().manual_seed(0), device="cpu")
    qg = global_scenario_batch(q.numpy(), mesh)
    assert torch.equal(qg, q) and np.array_equal(local_shards(qg), q.numpy())
    solver = _solver(max_iter=4)
    sols, stats = solve_sharded(solver._solve_impl, qg, global_scenario_batch(qd, mesh), mesh)
    assert int(replicated_value(stats["n_converged"])) == int(sols.converged.sum())
    assert int(replicated_value(stats["iterations_sum"])) == int(sols.iterations.sum())
    _, none = solve_sharded(solver._solve_impl, q, qd, mesh, collect_stats=False)
    assert none == {}


def test_one_process_sweep_with_the_native_pool_and_a_result_log(tmp_path):
    path = str(tmp_path / "mc.log")
    solver = _solver(max_iter=4)
    with ResultLog(path) as rlog:
        res = monte_carlo_envelope(solver, 5, chunk=4, seed=1, result_log=rlog)
    assert res["n_scenarios"] == 5 and res["ics"].shape == (5, 12)  # 4 + the first of 4
    assert res["converged"].shape == (5,) and res["terminal_states"].shape == (5, 12)
    recs = read_result_log(path)
    assert len(recs) == 5
    for rec, ic, c in zip(recs, res["ics"], res["converged"]):
        np.testing.assert_array_equal(np.concatenate([rec["q_init"], rec["qd_init"]]),
                                      ic.astype(np.float32))
        assert rec["converged"] == bool(c) and rec["z"].shape == (solver.problem.n_vars,)
        assert rec["lam"].shape == (solver.problem.n_ineq,)
    assert res["success_rate"] == res["n_converged"] / 5


def test_the_sweep_program_on_the_cpu(tmp_path, capsys):
    path = str(tmp_path / "sweep.log")
    assert montecarlo.main(["--drops", "3", "--chunk", "2", "--device", "cpu", "--max-iter", "2",
                            "--result-log", path]) == 0
    assert len(read_result_log(path)) == 3
    assert "/3 converged" in capsys.readouterr().out
