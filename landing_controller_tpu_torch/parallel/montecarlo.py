"""Chunked Monte-Carlo landing-envelope sweeps, one process per card.

Streams scenario batches (the native pool when available) through the
sharded batched solve, accumulating success statistics and optional durable
results: the replacement for the reference's serial sweep loops
(analysis/foot_positions.m:32-43) and append-on-accept .mat store.

The host reads results only at chunk boundaries; each chunk is one batched
solve on every rank with collective reductions of its counts.

Run as a program (the counterpart of the JAX package's
examples/envelope_sweep.py)::

    python -m landing_controller_tpu_torch.parallel.montecarlo --drops 256 --chunk 64
    torchrun --nproc_per_node=K -m landing_controller_tpu_torch.parallel.montecarlo \
        --drops 100000 --chunk 1024 --result-log build/envelope.log

Under ``torchrun`` each process takes the card ``LOCAL_RANK`` and joins the
default process group (NCCL; gloo with ``--device cpu``) from the variables
torchrun sets; each rank writes its own log, ``<log>.rank<r>``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from .batch import make_scenario_mesh, solve_sharded
from .multihost import global_scenario_batch, local_shards, replicated_value


def monte_carlo_envelope(
    solver,
    n_scenarios: int,
    chunk: int = 64,
    seed: int = 0,
    mesh=None,
    result_log=None,
    use_native_pool: bool = True,
):
    """Run an n_scenarios Monte-Carlo sweep in chunks.

    solver: a LandingSolver.  mesh: a :class:`.batch.ScenarioMesh` (None:
    :func:`.batch.make_scenario_mesh` on the solver's device).  Returns a
    stats dict: success rate, converged solves per second of solve time,
    per-dimension terminal-state envelope over converged scenarios, and the
    sampled ICs + convergence mask (for success-region maps).

    Several processes (one per card): every rank calls this with the same
    global ``n_scenarios`` / ``chunk``; each samples its own rows (seed
    ``seed * 1000003 + rank``) and solves them, and the returned per-lane
    arrays (``ics``, ``converged``, ``terminal_states``) are this rank's
    rows while the counts are global.  There n_scenarios is rounded up to a
    multiple of ``chunk`` (a partial chunk is counted in one process only).
    """
    if mesh is None:
        mesh = make_scenario_mesh(solver.device)
    n_dev = n_proc = mesh.world_size  # one device per process
    chunk = max(chunk, n_dev, n_proc) // n_dev * n_dev
    if n_proc > 1:
        n_scenarios = -(-n_scenarios // chunk) * chunk
        seed = seed * 1000003 + mesh.rank
    chunk_local = chunk // n_proc

    pool = None
    if use_native_pool:
        from ..runtime import NativeScenarioPool

        pool = NativeScenarioPool(batch=chunk_local, depth=2, threads=2, seed=seed)
        sample = pool.next
    else:
        from ..warmstart.reference import sample_drop_scenario

        generator = torch.Generator().manual_seed(seed)

        def sample():
            q, qd = sample_drop_scenario(chunk_local, generator, device="cpu")
            return q.numpy(), qd.numpy()

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    n_conv = 0
    n_done = 0
    t_solve = 0.0
    q_all, conv_all, xT_all = [], [], []
    try:
        while n_done < n_scenarios:
            # the solve always runs a full chunk; only the first `take`
            # lanes of the final chunk count toward the requested total
            # (several processes: n_scenarios was rounded so take == chunk)
            take = min(chunk, n_scenarios - n_done)
            take_local = take if n_proc == 1 else take // n_proc
            q, qd = sample()
            qj = global_scenario_batch(q, mesh)
            qdj = global_scenario_batch(qd, mesh)
            sync()
            t0 = time.time()
            sols, stats = solve_sharded(solver._solve_impl, qj, qdj, mesh)
            sync()
            t_solve += time.time() - t0
            conv = local_shards(sols.converged)[:take_local]
            if n_proc == 1:
                n_conv += int(conv.sum())
            else:
                n_conv += int(replicated_value(stats["n_converged"]))
            zs = local_shards(sols.z)[:take_local]
            lams = local_shards(sols.lam)[:take_local]
            xT = local_shards(sols.X[:, -1, :])[:take_local]
            n_done += take
            q_all.append(np.concatenate([q[:take_local], qd[:take_local]], axis=1))
            conv_all.append(conv)
            xT_all.append(xT)
            if result_log is not None:
                for i in range(take_local):
                    result_log.append_solution(q[i], qd[i], zs[i], bool(conv[i]), lam=lams[i])
    finally:
        if pool is not None:
            pool.close()

    ics = np.concatenate(q_all)
    conv = np.concatenate(conv_all)
    xT = np.concatenate(xT_all)
    ok = conv.astype(bool)
    return {
        "n_scenarios": n_done,
        "n_converged": n_conv,
        "success_rate": n_conv / max(1, n_done),
        "solves_per_sec": n_conv / max(t_solve, 1e-9),
        "wall_time_s": t_solve,
        "ics": ics,
        "converged": conv,
        "terminal_states": xT,
        "term_min": xT[ok].min(axis=0) if ok.any() else None,
        "term_max": xT[ok].max(axis=0) if ok.any() else None,
    }


def main(argv=None) -> int:
    import torch.distributed as dist

    from ..api import LandingSolver
    from ..runtime import ResultLog
    from .batch import backend_for

    ap = argparse.ArgumentParser(description="Monte-Carlo landing-envelope sweep")
    # no option is a prefix of one of torchrun's, which parses them first
    ap.add_argument("--drops", type=int, default=256, help="drops in all (every rank together)")
    ap.add_argument("--chunk", type=int, default=64, help="drops per solve, every rank together")
    ap.add_argument("--problem", default="srbm_lcp")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-iter", type=int, default=None, help="the solver's default when unset")
    ap.add_argument("--device", default=None, help="default cuda:LOCAL_RANK; 'cpu' for the CPU")
    ap.add_argument("--result-log", default=None, help="result log path (one file per rank)")
    args = ap.parse_args(argv)

    world = int(os.environ.get("WORLD_SIZE", "1"))
    device = args.device or f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    if world > 1:
        dist.init_process_group(backend_for(device))  # env:// from torchrun
    log = None
    try:
        mesh = make_scenario_mesh(device)
        solver = LandingSolver(args.problem, dtype=torch.float32, device=mesh.device)
        if args.max_iter is not None:
            cfg = dataclasses.replace(solver.config, max_iter=args.max_iter)
            solver = LandingSolver(args.problem, dtype=torch.float32, device=mesh.device,
                                   config=cfg)
        if args.result_log:
            path = args.result_log
            log = ResultLog(path if world == 1 else f"{path}.rank{mesh.rank}")
        stats = monte_carlo_envelope(solver, args.drops, chunk=args.chunk, seed=args.seed,
                                     mesh=mesh, result_log=log)
        print(f"[rank {mesh.rank} of {mesh.world_size}, {mesh.device}] {stats['n_converged']}/"
              f"{stats['n_scenarios']} converged ({100 * stats['success_rate']:.1f}%) at "
              f"{stats['solves_per_sec']:.2f} converged solves/s", flush=True)
        for k in ("term_min", "term_max"):
            if stats[k] is not None:
                env = np.round(stats[k].astype(np.float64), 3).tolist()
                print(f"terminal-state envelope {k[5:]}: {env}")
    finally:
        if log is not None:
            log.close()
        if world > 1:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
