"""The warm-start comparison at the reference harness's settings, on the card.

    python tests/probe_warmstart_reference.py [--batch 64] [--max-iter 200] [--trials 1]

Not a test (needs an NVIDIA GPU and nvcc; about ten minutes at the
defaults).  Runs ``analysis.warmstart_comparison`` with the committed
network (``api.DEFAULT_NN_PATH``) on drops of ``sample_drop_scenario``
(seed 999), with the kinodynamic solver of tools/train_warmstart.py:48-57
(NN retry) and its srbm_lcp solver (the port's tool's ``factory_solvers``
and ``compare_regimes``): the settings of the JAX package's
record ``landing_controller_tpu/data/warmstart_bench.json`` (B=64, 200
iterations), with fewer trials.  One untimed pass precedes the trials.
Prints the four timing rows and the three convergence rows with the card's
name and power limit, and the JAX record's convergence beside them.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from landing_controller_tpu_torch import tracing  # noqa: E402
from landing_controller_tpu_torch.api import DEFAULT_NN_PATH  # noqa: E402
from landing_controller_tpu_torch.tools.train_warmstart import factory_solvers  # noqa: E402
from landing_controller_tpu_torch.tools.warmstart_compare import compare_regimes  # noqa: E402
from landing_controller_tpu_torch.warmstart.nn import load_warmstart  # noqa: E402

JAX_RECORD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "landing_controller_tpu", "data", "warmstart_bench.json")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--max-iter", type=int, default=200)
    ap.add_argument("--trials", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_warmstart_reference: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    T, B = args.trials, args.batch
    mlp, stats = load_warmstart(DEFAULT_NN_PATH, device="cuda")
    srbm, kino = factory_solvers("cuda", args.max_iter)
    tracing.reset()
    t0 = time.time()
    res = compare_regimes(kino, srbm, mlp, stats, T, B, 999)
    wall = time.time() - t0
    print(f"[warmstart] committed network {os.path.basename(DEFAULT_NN_PATH)}, B={B}, {T} trial(s) "
          f"after one untimed pass, max_iter {args.max_iter}, drops of seed 999, on {smi}: wall_s "
          f"{wall:.2f}, qd_inverse launches {tracing.counters()['qd_inverse.launches']}")
    for k, v in res["t"].items():
        print(f"[warmstart] time {k}: mean {v.mean():.4f} s, min {v.min():.4f} s per batch of {B}")
    with open(JAX_RECORD) as f:
        regimes = json.load(f)["regimes"]
    for k, v in res["convergence"].items():
        print(f"[warmstart] convergence {k}: {v.mean():.4f} (the JAX record: "
              f"{regimes.get(k, {}).get('convergence')})")
    nn_ws, cold = res["convergence"]["nn_ws"].mean(), res["convergence"]["cold"].mean()
    print(f"[warmstart] nn_ws - cold = {nn_ws - cold:+.4f}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
