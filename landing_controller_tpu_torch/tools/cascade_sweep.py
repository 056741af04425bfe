"""Cascade seed ablation: which stage-1 (SRBM) blocks help the kinodynamic
stage.

    python -m landing_controller_tpu_torch.tools.cascade_sweep [--batch 64] [--batches 2]

The counterpart of the JAX package's tools/cascade_sweep.py:34-165.  Stage 2
solves the same drops from initial guesses that mix the stage-1 solution
with the cold-guess blocks:

  full      : X + FK-consistent feet + stage-1 GRFs + IK jpos
  x_only    : stage-1 X; feet, GRFs and jpos from the ballistic guess
  x_feet    : stage-1 X + feet (+ IK jpos); GRFs from the ballistic guess
  x_grf     : stage-1 X + GRFs; feet and jpos from the ballistic guess
  x_blend<a>: a% of stage-1 X blended with the reference guess's X
  cold      : the reference (linspace) guess
  ballistic : the ballistic guess

each at stage-2 barrier starts mu_init 1e-2 and 1e-1 (the two baselines at
1e-1 only), on ``--batches`` batches of ``sample_drop_scenario`` drops from
a generator seeded 7; stage 1 runs on the kinodynamic dt grid.  Prints one
line per solve and the summary; ``--out`` writes the summary as a record.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .common import kino_config, write_record

SEEDS = ("full", "x_only", "x_feet", "x_grf", "cold", "ballistic")


def cascade_solvers(device, max_iter: int = 200):
    """(stage-1 srbm_lcp on the kinodynamic dt grid, kinodynamic), both with
    the family's settings (cascade_sweep.py:58-75)."""
    import torch

    from ..api import LandingSolver

    cfg = kino_config(max_iter)
    kino = LandingSolver("kinodynamic", dtype=torch.float32, config=cfg, device=device)
    dt_kino = kino.build_params(np.zeros((1, 6)), np.zeros((1, 6))).dt[0].cpu().numpy()
    srbm = LandingSolver("srbm_lcp", dtype=torch.float32, config=cfg,
                         theta_overrides={"dt": dt_kino}, device=device)
    return srbm, kino


def seed_variant(name: str, kino, q, qd, X1, U1, jpos_clip):
    """Stage 2's initial guess (B, n) of variant ``name`` from the stage-1
    solutions X1, U1 of the drops (q, qd)."""
    import torch

    from ..problems.landing import LandingVars
    from ..warmstart.cascade import kinodynamic_guess_from_srbm
    from ..warmstart.reference import ballistic_guess, initial_guess_from_reference

    prob = kino.problem
    theta = kino.build_params(q, qd)
    if name == "full":
        return kinodynamic_guess_from_srbm(prob, kino.robot_params, X1, U1, jpos_clip)
    if name == "cold":
        return initial_guess_from_reference(prob, theta)
    zb = ballistic_guess(prob, theta)
    if name == "ballistic":
        return zb
    vb = prob.unpack(zb)
    if name == "x_only":
        return prob.pack(LandingVars(X=X1, jpos=vb.jpos, U=vb.U))
    if name.startswith("x_blend"):
        # pull the near-boundary stage-1 trajectory toward the centred cold reference
        a = float(name[len("x_blend"):]) / 100.0
        vref = prob.unpack(initial_guess_from_reference(prob, theta))
        return prob.pack(LandingVars(X=a * X1 + (1 - a) * vref.X, jpos=vb.jpos, U=vb.U))
    if name == "x_feet":
        vf = prob.unpack(kinodynamic_guess_from_srbm(prob, kino.robot_params, X1, U1, jpos_clip))
        return prob.pack(LandingVars(X=X1, jpos=vf.jpos,
                                     U=torch.cat([vf.U[..., :12], vb.U[..., 12:]], -1)))
    if name == "x_grf":
        return prob.pack(LandingVars(X=X1, jpos=vb.jpos,
                                     U=torch.cat([vb.U[..., :12], U1[..., 12:]], -1)))
    raise KeyError(name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Cascade seed ablation")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--seeds", default=",".join(SEEDS), help="comma-separated variants")
    ap.add_argument("--max-iter", type=int, default=200)
    ap.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    ap.add_argument("--out", default=None, help="record path (JSON)")
    args = ap.parse_args(argv)

    import torch

    from .._device import card_line, resolve_device
    from ..warmstart.reference import sample_drop_scenario

    device = resolve_device(args.device)
    srbm, kino = cascade_solvers(device, args.max_iter)
    theta0 = kino.build_params(np.zeros((1, 6)), np.zeros((1, 6)))
    jl = (theta0.jpos_min, theta0.jpos_max)
    stage2 = {"1e-2": kino.warm_variant(1e-2), "1e-1": kino.warm_variant(1e-1)}
    names = args.seeds.split(",")
    generator = torch.Generator().manual_seed(7)
    results = {}
    for bi in range(args.batches):
        q, qd = sample_drop_scenario(args.batch, generator, device="cpu")
        t0 = time.time()
        s1 = srbm.solve_batch(q, qd)
        s1_conv = s1.converged.cpu().numpy()
        print(f"[b{bi}] stage1 conv {s1_conv.mean():.3f} t={time.time() - t0:.0f}s", flush=True)
        for name in names:
            z0 = seed_variant(name, kino, q, qd, s1.X, s1.U, jl)
            for muk, solver in stage2.items():
                if name in ("cold", "ballistic") and muk == "1e-2":
                    continue  # the cold baselines run at the cold barrier only
                t0 = time.time()
                sol = solver._solve_impl(solver._as_batch(q), solver._as_batch(qd), z0=z0)
                conv = sol.converged.cpu().numpy()
                its = sol.iterations.float().mean().item()
                row = results.setdefault(f"{name}@mu{muk}", {"conv": [], "it": []})
                row["conv"].append(float(conv.mean()))
                row["it"].append(its)
                # conditional on stage-1 success
                if s1_conv.any():
                    row.setdefault("conv_s1ok", []).append(float(conv[s1_conv].mean()))
                s1ok = float(conv[s1_conv].mean()) if s1_conv.any() else float("nan")
                print(f"[b{bi}] {name}@mu{muk}: conv {conv.mean():.3f} (|s1ok {s1ok:.3f}) it "
                      f"{its:.0f} t={time.time() - t0:.0f}s", flush=True)

    summary = {k: {kk: float(np.mean(vv)) for kk, vv in v.items()} for k, v in results.items()}
    print(json.dumps(summary, indent=1), flush=True)
    if args.out:
        write_record(args.out, {**summary, "batch": args.batch, "n_batches": args.batches,
                                "card": card_line(device)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
