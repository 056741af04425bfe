"""Cold-start convergence battery of the kinodynamic family.

    python -m landing_controller_tpu_torch.tools.kino_battery [--batch 128] [config ...]

The counterpart of the JAX package's tools/kino_battery.py:37-87: single-knob
responses of cold kinodynamic solves (reference guess) on one batch of
``sample_drop_scenario`` drops from a generator seeded 11, one line per
configuration; ``--out`` writes them as a record.  Configurations: the
names of :data:`CONFIGS` and ``ballistic`` (``base`` with the ballistic
guess).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .common import kino_config, write_record

CONFIGS = {
    "base": {},
    "warm03": {"mu_init": 0.3, "kappa_mu": 0.5},
    "corr": {"corrector": 1},
    "loqo": {"mu_strategy": "loqo", "stall_window": 40, "stall_min_iter": 40},
    "warm03corr": {"mu_init": 0.3, "kappa_mu": 0.5, "corrector": 1},
    "loqocorr": {
        "mu_strategy": "loqo", "stall_window": 40, "stall_min_iter": 40,
        "corrector": 1, "mu_init": 0.3, "kappa_mu": 0.5,
    },
    "patient": {"max_iter": 350},
    "patient500": {"max_iter": 500},
}


def battery_solver(name: str, device, max_iter: int | None = None, **solver_kw):
    """The kinodynamic solver of configuration ``name`` (``base``: the
    family's settings with the reference guess), its iterations capped at
    ``max_iter`` if given; ``solver_kw`` go to LandingSolver (a retry
    chain, say)."""
    import torch

    from ..api import LandingSolver

    guess, over = ("ballistic", {}) if name == "ballistic" else ("reference", dict(CONFIGS[name]))
    if max_iter is not None:
        over["max_iter"] = max_iter
    return LandingSolver("kinodynamic", dtype=torch.float32, guess=guess, device=device,
                         config=kino_config(**over), **solver_kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Kinodynamic cold-start convergence battery")
    ap.add_argument("configs", nargs="*", help=f"of {sorted(CONFIGS) + ['ballistic']} (all)")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--max-iter", type=int, default=None,
                    help="cap every configuration's iterations (default: its own)")
    ap.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    ap.add_argument("--out", default=None, help="record path (JSON)")
    args = ap.parse_args(argv)

    import torch

    from .._device import card_line, resolve_device
    from ..warmstart.reference import sample_drop_scenario

    device = resolve_device(args.device)
    q0s, qd0s = sample_drop_scenario(args.batch, torch.Generator().manual_seed(11),
                                     device="cpu")
    record = {"batch": args.batch, "card": card_line(device), "configs": {}}
    for name in args.configs or list(CONFIGS):
        s = battery_solver(name, device, args.max_iter)
        t0 = time.time()
        sol = s.solve_batch(q0s, qd0s)
        conv = sol.converged.cpu().numpy()
        its = sol.iterations.cpu().numpy()
        wall = time.time() - t0
        p50 = float(np.percentile(its[conv], 50)) if conv.any() else -1.0
        print(f"{name:12s} conv {conv.mean():.3f} it_mean {its.mean():.0f} it_p50(conv) {p50:.0f} "
              f"wall {wall:.0f}s", flush=True)
        record["configs"][name] = {"conv": float(conv.mean()), "it_mean": float(its.mean()),
                                   "it_p50_conv": p50, "wall_s": wall}
    if args.out:
        write_record(args.out, record)
    else:
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
