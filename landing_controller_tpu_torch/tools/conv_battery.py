"""Convergence battery of the srbm_lcp solver: what share of the bench
distribution's failures is divergence, and what share impatience?

    python -m landing_controller_tpu_torch.tools.conv_battery [quick|full] [B]

The counterpart of the JAX package's tools/conv_battery.py:36-118: each run
is one ``solve_batch`` of the ballistic-guess srbm_lcp solver (the base of
:func:`.common.srbm_config` with the run's settings) on B drops of
:func:`.common.legacy_ics`, printed as one JSON line with the JAX tool's
keys, then the summary.  Each run's line also holds its ``qd_inverse``
launches and batch iterations.  ``--max-iter`` sets every run's iteration
cap; ``--out`` writes the runs as a record.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .common import counted, counts, legacy_ics, srbm_config, to_host, write_record

QUICK_RUNS = [
    ("baseline-200", {}),
    # patience: does more budget convert failures?
    ("patient-400", {"max_iter": 400}),
    ("patient-400-nostall", {"max_iter": 400, "stall_window": 0}),
    # loqo: fewer iterations; where do its failures come from?
    ("loqo-200", {"mu_strategy": "loqo"}),
    ("loqo-400-nostall", {"mu_strategy": "loqo", "max_iter": 400, "stall_window": 0}),
]
FULL_RUNS = QUICK_RUNS + [
    ("kappa01", {"kappa_mu": 0.1}),
    ("mu-init-3e2", {"mu_init": 3e-2}),
    ("alpha-y-primal", {"alpha_for_y": "primal"}),
    ("loqo-patient-stall100", {"mu_strategy": "loqo", "max_iter": 400, "stall_window": 100}),
    ("tol1e-4", {"tol": 1e-4, "max_iter": 400}),
]
# the keys of each run's line (conv_battery.py:72-84)
RUN_KEYS = ("name", "B", "conv", "iters_mean", "iters_p50", "iters_p90", "conv_iters_mean",
            "fail_viol_p50", "fail_kkt_p50", "fail_kkt_only", "n_fail")


def run_config(name, B, cfg_kwargs, device, seed=0, max_iter=None):
    """One run: its line printed and returned as a dict."""
    import torch

    from ..api import LandingSolver

    over = dict(cfg_kwargs, **({} if max_iter is None else {"max_iter": max_iter}))
    solver = LandingSolver("srbm_lcp", dtype=torch.float32, structured=True,
                           config=srbm_config(**over), guess="ballistic", device=device)
    q, qd = legacy_ics(B, seed)
    before = counts()
    sols = solver.solve_batch(q, qd)
    conv, its, kkt, viol = to_host(sols.converged, sols.iterations, sols.kkt_error,
                                   sols.constr_viol)
    bad = ~conv
    out = dict(
        name=name,
        B=B,
        conv=round(float(conv.mean()), 4),
        iters_mean=round(float(its.mean()), 1),
        iters_p50=float(np.percentile(its, 50)),
        iters_p90=float(np.percentile(its, 90)),
        conv_iters_mean=round(float(its[conv].mean()), 1) if conv.any() else -1,
        fail_viol_p50=float(np.median(viol[bad])) if bad.any() else 0.0,
        fail_kkt_p50=float(np.median(kkt[bad])) if bad.any() else 0.0,
        fail_kkt_only=int(((viol <= 1e-3) & bad).sum()),
        n_fail=int(bad.sum()),
        **counted(before),
    )
    print(json.dumps(out), flush=True)
    return out


def parse_args(argv=None):
    """The command line: the JAX tool's positionals, then the port's options."""
    ap = argparse.ArgumentParser(description="srbm_lcp convergence battery")
    ap.add_argument("mode", nargs="?", default="quick", choices=("quick", "full"))
    ap.add_argument("B", nargs="?", type=int, default=64)
    ap.add_argument("--max-iter", type=int, default=None,
                    help="every run's iteration cap (default: its own)")
    ap.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    ap.add_argument("--out", default=None, help="record path (JSON)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from .._device import card_line, resolve_device

    device = resolve_device(args.device)
    runs = FULL_RUNS if args.mode == "full" else QUICK_RUNS
    results = [run_config(n, args.B, kw, device, max_iter=args.max_iter) for n, kw in runs]
    print("== summary ==")
    for r in results:
        print(
            f"{r['name']:>22}: conv={r['conv']:.3f} it_mean={r['iters_mean']}"
            f" p50={r['iters_p50']:.0f} p90={r['iters_p90']:.0f}"
            f" kkt_only_fails={r['fail_kkt_only']}/{r['n_fail']}"
        )
    if args.out:
        write_record(args.out, {"mode": args.mode, "B": args.B, "max_iter": args.max_iter,
                                "card": card_line(device), "runs": results})
    return 0


if __name__ == "__main__":
    sys.exit(main())
