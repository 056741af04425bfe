"""Benchmark of the port: converged srbm_lcp landing solves per second on
one card, in streaming mode.

    python -m landing_controller_tpu_torch.bench [--device cpu] [options]

The counterpart of the JAX package's ``bench.py`` (its measurement worker,
bench.py:268-460): the srbm_lcp NLP at N=21 under the reference tolerance
contract (tol 1e-4), a ballistic cold guess with one retry from the NN warm
start, the production dt schedule, solved by the StreamingSolver (B=64
lanes, 25-iteration segments, attempt deadlines (100, 150)) over a pool of
n = 6 B scenarios from the benchmark's sampler.  One run at the same pool
size with ``max_wall_s=0`` comes first (``compile_s`` is the solver's
build, the kernels' first build and this warm-up); it also draws the first
pool, so the measured pool is the sampler's second, as in bench.py.  The
measured run prints one snapshot row per segment, then lines starting with
"#" (the card's name and power limit; the ``qd_inverse`` launches, batch
iterations, peak device memory and pool set-up time of the measured run),
then the final row as the last line of standard output.

The row has bench.py's keys except ``vs_baseline`` (bench.py divides by a
TPU target).  The options are bench.py's ``BENCH_*`` variables with the same
defaults.  There is no parent watchdog and no zero row: a failure raises
and the program exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

METRIC = "converged_landing_solves_per_sec_per_chip"
STEP_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build",
                         "bench", "stream_step.lcs")


def make_sampler(seed: int = 0):
    """The benchmark's drop-condition sampler (bench.py:268-283): one numpy
    ``default_rng(seed)`` kept across calls; roll, yaw U(+-0.25), pitch
    U(+-pi/3), z0 0.6, omega U(+-0.5), v_xy U(+-1), v_z -U(0.5, 5).
    Returns ``sample(n) -> (q (n, 6), qd (n, 6))`` float32."""
    rng = np.random.default_rng(seed)

    def sample(n):
        q0s = np.zeros((n, 6), np.float32)
        q0s[:, 2] = 0.6
        q0s[:, 3] = rng.uniform(-0.25, 0.25, n)
        q0s[:, 4] = rng.uniform(-np.pi / 3, np.pi / 3, n)
        q0s[:, 5] = rng.uniform(-0.25, 0.25, n)
        qd0s = np.zeros((n, 6), np.float32)
        qd0s[:, :3] = rng.uniform(-0.5, 0.5, (n, 3))
        qd0s[:, 3:5] = rng.uniform(-1, 1, (n, 2))
        qd0s[:, 5] = -rng.uniform(0.5, 5.0, n)
        return q0s, qd0s

    return sample


def bench_config(**overrides):
    """The IPConfig of bench.py:345-376 at its defaults: warm barrier start
    (mu_init 0.3, kappa_mu 0.5), loqo rule, one corrector, the reference
    tolerance 1e-4, stall window 40, cri; ``overrides`` replace fields."""
    from .solver.ip import IPConfig

    cfg = IPConfig(
        max_iter=200, hessian_mode="hybrid", mu_init=0.3, kappa_mu=0.5, mu_min=1e-5, tol=1e-4,
        sigma_max=1e5, refine_steps=1, relax_scale=1.0, delta_c=1e-6, kkt_backend="cri",
        ladder_scales=(0.0, 1.0), n_linesearch=4, mu_strategy="loqo", stall_window=40,
        stall_min_iter=40, matmul_precision="highest", corrector=1,
    )
    return dataclasses.replace(cfg, **overrides)


def bench_solver(device="cuda", config=None, guess="ballistic", retry_guess="nn",
                 production_dt=True):
    """The benchmark's srbm_lcp solver (bench.py:380-403): ballistic cold
    guess, NN retry, the production dt schedule, :func:`bench_config`."""
    import torch

    from .api import LandingSolver
    from .warmstart.reference import DT_PRODUCTION

    overrides = {"dt": DT_PRODUCTION.astype(np.float32)} if production_dt else None
    return LandingSolver("srbm_lcp", dtype=torch.float32, structured=True,
                         config=config or bench_config(), guess=guess, theta_overrides=overrides,
                         retry_guess=retry_guess, device=device)


def bench_stream(solver, sampler, batch=64, segment=25, attempt_iters=(100, 150),
                 collect_z=False):
    """The benchmark's StreamingSolver (bench.py:406-415)."""
    from .parallel.stream import StreamingSolver

    return StreamingSolver(solver, batch=batch, segment=segment, sampler=sampler,
                           attempt_iters=attempt_iters, collect_z=collect_z)


def row(stats, extra):
    """bench.py's row of the stats so far (bench.py:297-314), without
    ``vs_baseline``."""
    value = stats["converged_per_sec"]
    return {
        "metric": METRIC,
        "value": round(value, 2),
        "unit": "solves/s",
        "mode": "streaming",
        "n_scenarios": stats["n_finished"],
        "wall_s": round(stats["wall_s"], 2),
        "convergence_rate": round(stats["convergence_rate"], 4),
        "iters_p50": int(stats["iters_p50"]),
        "iters_p90": int(stats["iters_p90"]),
        **extra,
    }


def main(argv=None) -> int:
    t_start = time.time()
    base = bench_config()
    ap = argparse.ArgumentParser(description="Converged srbm_lcp solves/s on one card, streaming")
    ap.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    ap.add_argument("--batch", type=int, default=64, help="lanes (BENCH_B)")
    ap.add_argument("--segment", type=int, default=25, help="iterations per segment")
    ap.add_argument("--n", type=int, default=None, help="pool size (default 6 x batch)")
    ap.add_argument("--attempt-iters", default="100,150", help="iteration deadline per attempt")
    ap.add_argument("--retry", type=int, choices=(0, 1), default=1,
                    help="1: a failed first attempt re-solves from the retry guess")
    ap.add_argument("--max-iter", type=int, default=base.max_iter)
    ap.add_argument("--hess", default=base.hessian_mode)
    ap.add_argument("--mu-init", type=float, default=base.mu_init)
    ap.add_argument("--kappa-mu", type=float, default=base.kappa_mu)
    ap.add_argument("--tol", type=float, default=base.tol)
    ap.add_argument("--refine", type=int, default=base.refine_steps)
    ap.add_argument("--backend", default=base.kkt_backend)
    ap.add_argument("--ladder", default="0,1", help="shift ladder scales")
    ap.add_argument("--ls", type=int, default=base.n_linesearch, help="line-search candidates")
    ap.add_argument("--mu", default=base.mu_strategy, help="barrier rule")
    ap.add_argument("--stall-window", type=int, default=base.stall_window)
    ap.add_argument("--stall-min", type=int, default=base.stall_min_iter)
    ap.add_argument("--prec", default=base.matmul_precision,
                    help="IPConfig.matmul_precision (the port's solver runs full f32 matmuls, "
                         "TF32 off, whatever its value)")
    ap.add_argument("--corr", type=int, default=base.corrector, help="correctors per step")
    ap.add_argument("--guess", default="ballistic", help="cold guess of the first attempt")
    ap.add_argument("--dt", choices=("production", "uniform"), default="production")
    ap.add_argument("--retry-guess", default="nn", help="retry chain ('' for none)")
    ap.add_argument("--aot", action="store_true", help="load the saved stream step (--step-path)")
    ap.add_argument("--export", action="store_true", help="save the stream step after warm-up")
    ap.add_argument("--step-path", default=STEP_PATH)
    ap.add_argument("--max-wall-s", type=float, default=None,
                    help="stop the measured run after this many seconds (default: the whole pool)")
    args = ap.parse_args(argv)

    import torch

    from ._device import card_line, resolve_device
    from .runtime import enable_persistent_cache
    from .tracing import counters

    device = resolve_device(args.device)
    enable_persistent_cache()
    cfg = bench_config(
        max_iter=args.max_iter, hessian_mode=args.hess, mu_init=args.mu_init,
        kappa_mu=args.kappa_mu, tol=args.tol, refine_steps=args.refine, kkt_backend=args.backend,
        ladder_scales=tuple(float(x) for x in args.ladder.split(",")), n_linesearch=args.ls, mu_strategy=args.mu,
        stall_window=args.stall_window, stall_min_iter=args.stall_min,
        matmul_precision=args.prec, corrector=args.corr,
    )
    retry_guess = args.retry_guess or None
    solver = bench_solver(device, cfg, args.guess, retry_guess, args.dt == "production")
    attempts = tuple(int(x) for x in args.attempt_iters.split(","))
    B = args.batch
    ss = bench_stream(solver, make_sampler(0), B, args.segment,
                      attempts if args.retry else attempts[:1])
    extra = {
        "batch": B, "segment": args.segment, "guess": args.guess, "retry_guess": retry_guess,
        "tol": cfg.tol, "mu_strategy": cfg.mu_strategy, "retry_failed": bool(args.retry),
    }
    n = args.n or 6 * B

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if args.aot:
        extra["aot"] = ss.load_step(args.step_path, n)
    t_built = time.time()
    ss.run(n, max_wall_s=0.0)  # warm-up: draws the sampler's first pool
    sync()
    t_warm = time.time() - t_built
    if args.export and not extra.get("aot"):
        os.makedirs(os.path.dirname(os.path.abspath(args.step_path)), exist_ok=True)
        ss.export_step(args.step_path, n)
        print(f"# exported {args.step_path}", flush=True)
    extra["compile_s"] = round(time.time() - t_start, 1)

    segments = []

    def snapshot(stats):
        segments.append(stats["n_finished"])
        if stats["n_finished"]:
            print(json.dumps(row(stats, extra)), flush=True)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches = counters()["qd_inverse.launches"]
    t0 = time.time()
    stats = ss.run(n, max_wall_s=args.max_wall_s, progress_cb=snapshot)
    sync()
    t_run = time.time() - t0
    launches = counters()["qd_inverse.launches"] - launches
    if stats["n_finished"] == 0:
        raise RuntimeError(f"no scenario of the pool of {n} finished")
    peak = torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None
    print(f"# card: {card_line(device)}", flush=True)
    print("# measured run: " + json.dumps({
        "qd_inverse_launches": launches, "segments": len(segments),
        "batch_iterations": len(segments) * args.segment,
        "peak_device_memory_gb": peak, "pool_setup_s": round(t_run - stats["wall_s"], 2),
        "solver_build_s": round(t_built - t_start, 2), "warmup_s": round(t_warm, 2),
    }), flush=True)
    print(json.dumps(row(stats, extra)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
