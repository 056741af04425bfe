"""Batched free-contact-timing (eeParam) throughput on one card.

    python -m landing_controller_tpu_torch.tools.eeparam_bench [--batch 32] [--trials 3]

The counterpart of the JAX package's tools/eeparam_bench.py:23-131: f32
``EEParamSolver`` solves of a drop sweep (the reference's config 2,
quadruped_SRBM_eeParam.m:324-409, solved there one at a time by IPOPT), one
untimed batch (seed 0), then ``--trials`` timed batches (seeds 100, 101,
...), written to ``--out`` (default: the port's ``data/eeparam_bench.json``;
``--out ''`` prints only).  Any of the IPConfig options replaces the
solver's default configuration by the tool's base one with those fields.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

from .common import DATA_DIR, write_record

# option -> IPConfig field (tools/eeparam_bench.py:37-46)
_OVERRIDES = {"ladder": "ladder_scales", "refine": "refine_steps", "corr": "corrector",
              "mu_init": "mu_init", "kappa_mu": "kappa_mu", "ls": "n_linesearch",
              "max_iter": "max_iter", "mu": "mu_strategy", "prec": "matmul_precision"}


def eeparam_drops(seed: int, n: int):
    """The tool's drop sampler (tools/eeparam_bench.py:68-80, numpy): height
    U(0.45, 0.65), vertical velocity -U(0.5, 1.5), pitch U(-0.2, 0.2).
    Returns (r_init, rdot_init, theta_init), each (n, 3)."""
    r = np.random.default_rng(seed)
    h = r.uniform(0.45, 0.65, n)
    vz = -r.uniform(0.5, 1.5, n)
    pitch = r.uniform(-0.2, 0.2, n)
    zero = np.zeros(n)
    return (np.stack([zero, zero, h], 1), np.stack([zero, zero, vz], 1),
            np.stack([zero, pitch, zero], 1))


def drop_params(solver, seed: int, n: int):
    """EEParamParams of ``n`` drops of :func:`eeparam_drops`."""
    r0, rd0, th0 = eeparam_drops(seed, n)
    return solver.build_params(r_init=r0, rdot_init=rd0, theta_init=th0)


def tool_ip_config(**overrides):
    """The tool's base configuration with ``overrides`` (no override: None,
    the solver's default)."""
    if not overrides:
        return None
    from ..solver.ip import IPConfig

    base = IPConfig(max_iter=200, hessian_mode="gn", relax_scale=0.0, delta_c=1e-6, mu_min=1e-5,
                    tol=2e-4, sigma_max=1e5, refine_steps=5)
    return dataclasses.replace(base, **overrides)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="EEParamSolver throughput on one card")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--ladder", type=lambda s: tuple(float(x) for x in s.split(",")))
    for name, cast in (("refine", int), ("corr", int), ("mu-init", float), ("kappa-mu", float),
                       ("ls", int), ("max-iter", int), ("mu", str), ("prec", str)):
        ap.add_argument(f"--{name}", type=cast)
    ap.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    ap.add_argument("--out", default=os.path.join(DATA_DIR, "eeparam_bench.json"))
    args = ap.parse_args(argv)

    import torch

    from .._device import card_line, resolve_device
    from ..api import EEParamSolver

    device = resolve_device(args.device)
    over = {field: getattr(args, opt) for opt, field in _OVERRIDES.items()
            if getattr(args, opt) is not None}
    if over:
        print(f"[config] overrides: {over}", flush=True)
    s = EEParamSolver(ip_config=tool_ip_config(**over), dtype=torch.float32, device=device)
    B = args.batch

    def solve(seed):
        sol = s.solve_batch(drop_params(s, seed, B))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return sol

    t0 = time.time()
    solve(0)  # the first call's costs, untimed
    compile_s = time.time() - t0
    rates, times, iters = [], [], []
    for t in range(args.trials):
        t0 = time.time()
        sol = solve(100 + t)
        dt = time.time() - t0
        conv = sol.converged.cpu().numpy()
        times.append(dt)
        rates.append(float(conv.mean()))
        iters.append(float(sol.iterations.float().mean()))
        print(f"trial {t}: {dt:.2f}s conv={conv.mean():.3f} solves/s={conv.sum() / dt:.1f} "
              f"iters_mean={iters[-1]:.0f}", flush=True)
    out = {
        "problem": "eeparam_free_contact_timing",
        "batch": B,
        "n_trials": args.trials,
        "dtype": "float32",
        "kkt": "dense inertia-corrected Schur (api.EEParamSolver default)",
        "compile_s": round(compile_s, 1),
        "wall_s_mean": round(float(np.mean(times)), 2),
        "convergence_rate": round(float(np.mean(rates)), 4),
        "converged_solves_per_sec": round(float(np.mean(rates)) * B / float(np.mean(times)), 2),
        "iters_mean": round(float(np.mean(iters)), 1),
        "reference": "quadruped_SRBM_eeParam.m:324-409 (IPOPT, one scenario at a time)",
        "card": card_line(device),
    }
    print(json.dumps(out), flush=True)
    if args.out:
        write_record(args.out, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
