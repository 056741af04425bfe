"""Failure taxonomy of the srbm_lcp solver: which constraint groups pin the
lanes that do not converge?

    python -m landing_controller_tpu_torch.tools.fail_taxonomy [B] [mu_strategy]

The counterpart of the JAX package's tools/fail_taxonomy.py:34-105: one
``solve_batch`` of the ballistic-guess srbm_lcp solver
(:func:`.common.srbm_config` with the barrier rule given) on B drops of
:func:`.common.legacy_ics`, then for each failed lane (at most 40) the
dominant violated group: the initial-state and dynamics defects
(``eq_head``, ``eq_dyn``) or a group of inequality rows (LCP, no-slip,
friction, kinematic and state boxes), with the drop's parameters, the
counts of dominant groups, and the drop severity |pitch| + 0.2 |v_z| of
the failed and the converged lanes.  Where JAX evaluates the rows one
lane at a time, :func:`lane_groups` evaluates every failed lane in one
batched call and reduces the groups on the device.  ``--out`` writes the
record.
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter

import numpy as np

from .common import counted, counts, legacy_ics, srbm_config, to_host, write_record

MAX_LANES = 40  # failed lanes reported
# the record's keys: the values of the JAX tool's printed lines (fail_taxonomy.py:61-101)
RECORD_KEYS = ("B", "mu", "conv", "iters_mean", "failed_lanes")


def group_index(problem):
    """(names, index): the violation groups of fail_taxonomy.py:67-81 in its
    order (``eq_head``, ``eq_dyn``, then the inequality groups by first
    appearance, each the label ``k3:lcp[2]`` read as ``lcp``) and each
    inequality row's column among them, as an int64 numpy array."""
    groups = [lab.split(":")[-1].split("[")[0] for lab in problem.ineq_row_labels()]
    names = ["eq_head", "eq_dyn"] + list(dict.fromkeys(groups))
    col = {name: i for i, name in enumerate(names)}
    return names, np.array([col[g] for g in groups], dtype=np.int64)


def lane_groups(problem, z, theta, index):
    """The largest violation in each group of :func:`group_index` of the
    lanes z (L, n) under theta (L lanes): (L, groups), the defect rows'
    largest |E| and each inequality group's largest max(-g, 0) (0 at
    least), all lanes in one evaluation of the rows."""
    import torch

    n = problem.config.n_knots
    E = problem.eq(z, theta)
    g = problem.ineq(z, theta)
    index = torch.as_tensor(index, device=g.device)
    out = g.new_zeros(g.shape[0], int(index.max()) + 1)
    out = out.scatter_reduce(1, index.expand_as(g), torch.clamp(-g, min=0.0), "amax")
    out[:, 0] = E[:, :12].abs().amax(-1)
    out[:, 1] = E[:, 12:12 + 12 * (n - 1)].abs().amax(-1)
    return out


def parse_args(argv=None):
    """The command line: the JAX tool's positionals, then the port's options."""
    ap = argparse.ArgumentParser(description="srbm_lcp failure taxonomy")
    ap.add_argument("B", nargs="?", type=int, default=128)
    ap.add_argument("mu_strategy", nargs="?", default="loqo")
    ap.add_argument("--max-iter", type=int, default=None, help="iteration cap (default: 200)")
    ap.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    ap.add_argument("--out", default=None, help="record path (JSON)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from .._device import card_line, resolve_device
    from ..api import LandingSolver

    device = resolve_device(args.device)
    B, mu = args.B, args.mu_strategy
    over = {} if args.max_iter is None else {"max_iter": args.max_iter}
    solver = LandingSolver("srbm_lcp", dtype=torch.float32, structured=True,
                           config=srbm_config(mu_strategy=mu, **over), guess="ballistic",
                           device=device)
    q, qd = legacy_ics(B)
    before = counts()
    sols = solver.solve_batch(q, qd)
    record = {"B": B, "mu": mu, "max_iter": solver.config.max_iter, "card": card_line(device),
              **counted(before)}
    conv, its, kkt = to_host(sols.converged, sols.iterations, sols.kkt_error)
    print(f"B={B} mu={mu} conv={conv.mean():.3f} iters_mean={its.mean():.0f}")
    record.update(conv=float(conv.mean()), iters_mean=float(its.mean()), failed_lanes=[])
    bad = np.where(~conv)[0]
    if bad.size:
        prob = solver.problem
        names, index = group_index(prob)
        lanes = bad[:MAX_LANES]
        at = torch.as_tensor(lanes, device=device)
        (viol,) = to_host(lane_groups(prob, sols.z[at], solver.build_params(q[lanes], qd[lanes]),
                                      index))
        dominant = Counter()
        print("-- failed lanes (dominant violated group) --")
        for i, v in zip(lanes, viol):
            dom = names[int(np.argmax(v))]
            val = float(v.max())
            dominant[dom] += 1
            qi, qdi = q[i], qd[i]
            print(
                f"lane {i:3d}: {dom:9s} viol={val:.3f} it={its[i]:3d} "
                f"pitch={qi[4]:+.2f} roll={qi[3]:+.2f} vz={qdi[5]:+.2f} "
                f"wx={qdi[3]:+.2f} wy={qdi[4]:+.2f} kkt={float(kkt[i]):.1e}"
            )
            record["failed_lanes"].append({
                "lane": int(i), "group": dom, "viol": val, "it": int(its[i]),
                "pitch": float(qi[4]), "roll": float(qi[3]), "vz": float(qdi[5]),
                "wx": float(qdi[3]), "wy": float(qdi[4]), "kkt": float(kkt[i]),
                "groups": dict(zip(names, map(float, v)))})
        print("dominant-group counts:", dict(dominant))
        # correlation with drop severity
        sev = np.abs(q[:, 4]) + 0.2 * np.abs(qd[:, 5])
        print(
            f"severity |pitch|+0.2|vz|: failed mean={sev[~conv].mean():.2f} "
            f"converged mean={sev[conv].mean():.2f}"
        )
        record.update(dominant_group_counts=dict(dominant),
                      severity_failed_mean=float(sev[~conv].mean()),
                      severity_converged_mean=float(sev[conv].mean()) if conv.any() else None)
    if args.out:
        write_record(args.out, record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
