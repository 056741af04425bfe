"""Convergence diagnosis of the srbm_lcp solver: why do cold-start lanes
fail?

    python -m landing_controller_tpu_torch.tools.diag_conv [B] [backend] [mu_strategy] [sampler]

The counterpart of the JAX package's tools/diag_conv.py:42-120: the raw
interior-point solve of B drops (:func:`raw_solve`, which keeps the
iteration histories), an untimed pass and then a timed one, then the
batch's convergence and iterations and, for the first six failed lanes,
their KKT error at a quarter, half, three quarters and the end of the
iteration budget, the last barrier parameter and the step lengths.
Positionals as the JAX tool's: B=64, backend ``scan``, ``monotone``,
sampler ``legacy`` (:func:`.common.legacy_ics`) or ``reference`` (the
production distribution from a torch generator: the same distribution as
JAX's ``jax.random`` draws, not the same drops).  ``--out`` writes the
record.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .common import clock, counted, counts, kino_config, sampled_ics, to_host, write_record

N_LANES = 6  # failed lanes reported
# the record's keys: the values of the JAX tool's printed lines (diag_conv.py:100-119)
RECORD_KEYS = ("B", "backend", "mu", "sampler", "wall_s", "conv", "it_p50", "it_p90", "it_max",
               "solves_s", "lanes")


def raw_solve(solver, q0s, qd0s):
    """The IPResult (with histories) of the solver's srbm_lcp lanes from the
    reference guess: build_params -> initial_guess_from_reference ->
    scale_problem -> the structured Newton step -> solve, as diag_conv.py:68-85."""
    from ..solver.ip import solve
    from ..solver.scaling import scale_problem
    from ..solver.structured import make_structured_newton_step
    from ..warmstart.reference import initial_guess_from_reference

    prob, cfg = solver.problem, solver.config
    theta = solver.build_params(q0s, qd0s)
    z0 = initial_guess_from_reference(prob, theta)
    snlp = scale_problem(prob, theta, z0, z_scale=solver._z_scale)
    step = make_structured_newton_step(prob, theta, cfg, snlp)
    return solve(snlp.cost, snlp.eq, snlp.ineq, snlp.to_scaled(z0), cfg,
                 relax_mask=solver._relax_mask, newton_step_fn=step)


def parse_args(argv=None):
    """The command line: the JAX tool's positionals, then the port's options."""
    ap = argparse.ArgumentParser(description="srbm_lcp convergence diagnosis")
    ap.add_argument("B", nargs="?", type=int, default=64)
    ap.add_argument("backend", nargs="?", default="scan")
    ap.add_argument("mu_strategy", nargs="?", default="monotone")
    ap.add_argument("sampler", nargs="?", default="legacy")
    ap.add_argument("--max-iter", type=int, default=200, help="iteration cap (default: 200)")
    ap.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    ap.add_argument("--out", default=None, help="record path (JSON)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from .._device import card_line, resolve_device
    from ..api import LandingSolver

    device = resolve_device(args.device)
    B, backend, mu_strategy, sampler = args.B, args.backend, args.mu_strategy, args.sampler
    cfg = kino_config(max_iter=args.max_iter, kkt_backend=backend, mu_strategy=mu_strategy)
    solver = LandingSolver("srbm_lcp", dtype=torch.float32, structured=True, config=cfg,
                           device=device)
    q0s, qd0s = sampled_ics(B, sampler=sampler)

    before = counts()
    t0 = clock(device)
    raw_solve(solver, q0s, qd0s)
    t1 = clock(device)
    res = raw_solve(solver, q0s, qd0s)
    dt = clock(device) - t1
    record = {"B": B, "backend": backend, "mu": mu_strategy, "sampler": sampler,
              "max_iter": cfg.max_iter, "card": card_line(device), "first_pass_s": t1 - t0,
              "wall_s": dt, **counted(before)}

    conv, its, kkt_h, mu_h, al_h = to_host(res.converged, res.iterations, res.kkt_history,
                                           res.mu_history, res.alpha_history)
    print(
        f"B={B} backend={backend} mu={mu_strategy} sampler={sampler} wall={dt:.2f}s "
        f"conv={conv.mean():.3f} it p50/p90/max={np.percentile(its,50):.0f}/"
        f"{np.percentile(its,90):.0f}/{its.max()} solves/s={conv.sum()/dt:.2f}"
    )
    record.update(conv=float(conv.mean()), it_p50=float(np.percentile(its, 50)),
                  it_p90=float(np.percentile(its, 90)), it_max=int(its.max()),
                  solves_s=float(conv.sum() / dt), lanes=[])
    # converged lanes: where did they converge?
    if conv.any():
        print(f"converged-lane iterations: p50={np.median(its[conv]):.0f} "
              f"p90={np.percentile(its[conv],90):.0f}")
        record.update(conv_it_p50=float(np.median(its[conv])),
                      conv_it_p90=float(np.percentile(its[conv], 90)))
    # (50, 100, 150, 199) of the JAX tool's 200-iteration buffers
    n = cfg.max_iter
    at = (n // 4, n // 2, 3 * n // 4, n - 1)
    record["kkt_at"] = list(at)
    for i in np.where(~conv)[0][:N_LANES]:
        k, a, m = kkt_h[i], al_h[i], mu_h[i]
        print(
            f"lane {i}: kkt[{','.join(map(str, at))}]="
            + ",".join(f"{k[j]:.1e}" for j in at)
            + f" mu_end={m[n - 1]:.1e}"
            + f" alpha: frac<1e-3={np.mean(a < 1e-3):.2f} last20_mean={a[-20:].mean():.2e}"
        )
        record["lanes"].append({"lane": int(i), "kkt": [float(k[j]) for j in at],
                                "mu_end": float(m[n - 1]),
                                "alpha_frac_below_1e-3": float(np.mean(a < 1e-3)),
                                "alpha_last20_mean": float(a[-20:].mean())})
    if args.out:
        write_record(args.out, record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
