"""The four-regime warm-start comparison (nn_warmstart.m:32-235) against a
saved network, written as a record.

    python -m landing_controller_tpu_torch.tools.warmstart_compare [--batch 64] [--trials 5]

The counterpart of the JAX package's tools/warmstart_compare.py:22-85: no
data generation or training, only the comparison (NN inference, NN warm
start, cold, SRBM cascade) on fresh drops of ``sample_drop_scenario`` from
a generator seeded 123, with the kinodynamic family's settings.  The record
keeps the training provenance keys of the record it replaces.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .common import DATA_DIR, kino_config, write_record


def compare_regimes(kino, srbm, mlp, stats, n_trials: int, batch: int, seed: int):
    """:func:`..analysis.warmstart_comparison` on ``n_trials`` batches of
    ``batch`` drops drawn by ``sample_drop_scenario`` from a generator
    seeded ``seed``; returns its result."""
    import torch

    from ..analysis.warmstart_bench import warmstart_comparison
    from ..warmstart.reference import sample_drop_scenario

    q, qd = sample_drop_scenario(n_trials * batch, torch.Generator().manual_seed(seed),
                                 device="cpu")
    return warmstart_comparison(kino, srbm, mlp, stats, q.reshape(n_trials, batch, 6),
                                qd.reshape(n_trials, batch, 6), n_trials=n_trials)


def regime_table(res) -> dict:
    """The records' table: mean and least seconds of each row, and the
    convergence of each solve row."""
    table = {k: {"mean_s": float(np.mean(v)), "min_s": float(np.min(v))}
             for k, v in res["t"].items()}
    for k, v in res["convergence"].items():
        table[k]["convergence"] = float(np.mean(v))
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Warm-start regimes on a saved network")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--max-iter", type=int, default=200)
    ap.add_argument("--nn", default=os.path.join(DATA_DIR, "nn_TO_landing.npz"))
    ap.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    ap.add_argument("--out", default=os.path.join(DATA_DIR, "warmstart_bench.json"))
    args = ap.parse_args(argv)

    import torch

    from .._device import card_line, resolve_device
    from ..api import LandingSolver
    from ..warmstart.nn import load_warmstart

    device = resolve_device(args.device)
    cfg = kino_config(args.max_iter)
    srbm = LandingSolver("srbm_lcp", dtype=torch.float32, config=cfg, device=device)
    kino = LandingSolver("kinodynamic", dtype=torch.float32, config=cfg, device=device)
    mlp, stats = load_warmstart(args.nn, device=device)
    t0 = time.time()
    res = compare_regimes(kino, srbm, mlp, stats, args.trials, args.batch, 123)
    old = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            old = json.load(f)
    out = {
        "batch": args.batch,
        "n_trials": args.trials,
        "regimes": regime_table(res),
        "cascade": "x_grf seed, cold barrier (warmstart/cascade.py)",
        "n_training_samples": old.get("n_training_samples"),
        "final_loss": old.get("final_loss"),
        "card": card_line(device),
    }
    write_record(args.out, out)
    print(json.dumps(out["regimes"], indent=1))
    print(f"compared in {time.time() - t0:.0f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
