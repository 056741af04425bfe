"""The warm-start pipeline end to end: training data, the network, its
comparison.

    python -m landing_controller_tpu_torch.tools.train_warmstart [--n-samples 1024] [--batch 128]

The counterpart of the JAX package's tools/train_warmstart.py:30-166:

1. the streaming kinodynamic factory (``data.generate_training_data_streaming``;
   failed cold lanes retry from the current network's guess), or the
   samples of ``--data-npz`` (resume);
2. normalisation statistics and 400 epochs of ``train_mlp``;
3. ``save_warmstart`` to ``--out-dir``/nn_TO_landing.npz (default: the
   port's ``data/``, the file its solvers load);
4. the four-regime comparison (5 trials of 64 drops, seed 999), written to
   ``--out-dir``/warmstart_bench.json.

Two gates keep a broken run from replacing the committed files: fewer than
``--sample-floor`` (500) samples sends the network and the record to the
``scratch/`` subdirectory of ``--out-dir``; a cold convergence row below
``--cold-conv-floor`` (0.5) sends the record there.  The harvested samples
are kept in ``scratch/training_data_landing.npz`` for ``--data-npz``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .common import DATA_DIR, kino_config, write_record
from .warmstart_compare import compare_regimes, regime_table


def factory_solvers(device, max_iter: int = 200, nn_retry: bool = True):
    """The pipeline's solvers (train_warmstart.py:48-67): srbm_lcp and
    kinodynamic with the family's settings, the kinodynamic one retrying
    failed lanes from the NN guess."""
    import torch

    from ..api import LandingSolver

    cfg = kino_config(max_iter)
    srbm = LandingSolver("srbm_lcp", dtype=torch.float32, config=cfg, device=device)
    kino = LandingSolver("kinodynamic", dtype=torch.float32, config=cfg,
                         retry_guess="nn" if nn_retry else None, device=device)
    return srbm, kino


def train_network(kino, data: dict, epochs: int = 400):
    """Normalisation statistics of the samples ``data`` (the factory's dict)
    and the network trained on them, on the solver's device; returns
    (mlp, stats, losses)."""
    import torch

    from ..warmstart import nn as wsnn

    t = {k: torch.as_tensor(v, device=kino.device) for k, v in data.items()}
    z6 = np.zeros((1, 6))
    stats = wsnn.compute_stats(t["inputs"], t["X"], t["U"], t["jpos"],
                               float(kino.build_params(z6, z6).mass[0]))
    xin_n, targets = wsnn.normalize_sample(stats, t["inputs"], t["X"], t["U"], t["jpos"])
    mlp, losses = wsnn.train_mlp(xin_n, targets, epochs=epochs)
    return mlp, stats, losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Training data, warm-start network, comparison")
    ap.add_argument("--n-samples", type=int, default=1024, help="drops the factory samples")
    ap.add_argument("--batch", type=int, default=128, help="the factory's lanes")
    ap.add_argument("--data-wall-s", type=float, default=1200.0, help="the factory's wall budget")
    ap.add_argument("--data-npz", default="", help="resume from these samples (skip the factory)")
    ap.add_argument("--nn-retry", type=int, choices=(0, 1), default=1,
                    help="1: failed factory lanes retry from the current network's guess")
    ap.add_argument("--sample-floor", type=int, default=500)
    ap.add_argument("--cold-conv-floor", type=float, default=0.5)
    ap.add_argument("--trials", type=int, default=5, help="comparison trials")
    ap.add_argument("--compare-batch", type=int, default=64, help="drops per comparison trial")
    ap.add_argument("--max-iter", type=int, default=200)
    ap.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    ap.add_argument("--out-dir", default=DATA_DIR)
    args = ap.parse_args(argv)

    from .._device import card_line, resolve_device
    from ..data import generate_training_data_streaming
    from ..warmstart import nn as wsnn

    device = resolve_device(args.device)
    scratch = os.path.join(args.out_dir, "scratch")
    os.makedirs(scratch, exist_ok=True)
    srbm, kino = factory_solvers(device, args.max_iter, bool(args.nn_retry))

    t0 = time.time()
    if args.data_npz and os.path.exists(args.data_npz):
        with np.load(args.data_npz) as d:
            data = {k: d[k] for k in d.files}
        print(f"[data] resumed {data['inputs'].shape[0]} samples from {args.data_npz}", flush=True)
    else:
        data = generate_training_data_streaming(kino, args.n_samples, batch=args.batch,
                                                max_wall_s=args.data_wall_s)
        np.savez_compressed(os.path.join(scratch, "training_data_landing.npz"), **data)
    m = data["inputs"].shape[0]
    print(f"[data] {m}/{args.n_samples} converged samples in {time.time() - t0:.0f}s", flush=True)
    if m == 0:
        raise RuntimeError("no converged sample to train on")

    # gate 1: a run short of the floor writes nothing over the committed files
    commit_ok = m >= args.sample_floor
    if not commit_ok:
        print(f"[gate] only {m} samples (< {args.sample_floor}): writing to {scratch}", flush=True)

    t0 = time.time()
    mlp, stats, losses = train_network(kino, data)
    print(f"[train] {len(losses)} epochs in {time.time() - t0:.0f}s; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.5f}", flush=True)
    nn_path = os.path.join(args.out_dir if commit_ok else scratch, "nn_TO_landing.npz")
    wsnn.save_warmstart(nn_path, mlp, stats)
    print(f"[save] {nn_path} ({os.path.getsize(nn_path) // 1024} KB)", flush=True)

    res = compare_regimes(kino, srbm, mlp, stats, args.trials, args.compare_batch, 999)
    table = regime_table(res)
    print(json.dumps({"batch": args.compare_batch, "regimes": table}, indent=1), flush=True)
    # gate 2: a cold row far below the bench's rate means this run was broken
    cold_conv = table["cold"]["convergence"]
    publish = commit_ok and cold_conv >= args.cold_conv_floor
    if not publish:
        print(f"[gate] cold convergence {cold_conv:.3f} < {args.cold_conv_floor} or sample floor "
              f"unmet: the record goes to {scratch}", flush=True)
    write_record(os.path.join(args.out_dir if publish else scratch, "warmstart_bench.json"), {
        "batch": args.compare_batch, "n_trials": args.trials, "regimes": table,
        "n_training_samples": m, "final_loss": float(losses[-1]), "card": card_line(device),
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
