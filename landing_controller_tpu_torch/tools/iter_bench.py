"""Cost of one IP iteration of the srbm_lcp stream's segment, by solver
setting.

    python -m landing_controller_tpu_torch.tools.iter_bench [quick|full]

The counterpart of the JAX package's tools/iter_bench.py:38-155: for each
configuration (the base of :func:`.common.srbm_config`, ballistic guess),
``init_state`` of B drops of :func:`.common.legacy_ics` and a first segment
of 50 iterations (``_segment_impl``, the streaming hot loop) make
``compile_s`` (here the kernels' load and the allocator's warm-up), then
the remaining segments of the budget are timed one by one between two
synchronizations of the card.  Lanes that finished still run the full
masked iteration, so ms per batch iteration is the same at any segment.
One JSON line per configuration with the JAX tool's keys, its
``qd_inverse`` launches and batch iterations, then the summary.
``--max-iter`` cuts the budget (200); a budget under 100 takes two
segments of half of it.  ``--out`` writes the record.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .common import clock, counted, counts, legacy_ics, srbm_config, to_host, write_record

SEGMENT = 50
LEAN_GN = {"hessian_mode": "gn", "ladder_scales": (1.0,), "n_linesearch": 2}
# (name, B, settings); the first is the round-2 bench configuration
QUICK_RUNS = [
    ("r2-bench-baseline", 64, {}),
    ("gn-only", 64, {"hessian_mode": "gn"}),
    ("exact-only", 64, {"hessian_mode": "exact"}),
    ("ladder1", 64, {"ladder_scales": (1.0,)}),
    ("ls2", 64, {"n_linesearch": 2}),
    ("refine0", 64, {"refine_steps": 0}),
    ("lean-gn", 64, LEAN_GN),
]
FULL_RUNS = QUICK_RUNS + [
    ("B128", 128, {}),
    ("B256", 256, {}),
    ("lean-gn-B256", 256, LEAN_GN),
    ("loqo", 64, {"mu_strategy": "loqo"}),
    ("backend-scan", 64, {"kkt_backend": "scan"}),
]
# the keys of each configuration's line (iter_bench.py:94-109)
RUN_KEYS = ("name", "B", "ms_per_iter_batch", "us_per_iter_lane", "compile_s", "conv",
            "iters_p50", "iters_p90", "est_solves_s")


def run_config(name, B, cfg_kwargs, device, n_iters=200, seed=0, guess="ballistic"):
    """One configuration: its line printed and returned as a dict."""
    import torch

    from ..api import LandingSolver

    solver = LandingSolver("srbm_lcp", dtype=torch.float32, structured=True,
                           config=srbm_config(max_iter=n_iters, **cfg_kwargs), guess=guess,
                           device=device)
    q, qd = (torch.as_tensor(a, device=device) for a in legacy_ics(B, seed))
    seg = min(SEGMENT, n_iters // 2)
    before = counts()
    t0 = clock(device)
    state = solver.init_state(q, qd)
    t_init = clock(device) - t0
    t0 = clock(device)
    summary, state = solver._segment_impl(q, qd, state, seg)
    t_compile = clock(device) - t0
    # timed segments: all lanes still live in segment 1 (cold start); later
    # segments have frozen lanes (they still cost the same: masked lanes
    # execute the full body), so per-iter time is honest at any segment
    times = []
    n_segs = (n_iters // seg) - 1
    for i in range(n_segs):
        t0 = clock(device)
        summary, state = solver._segment_impl(q, qd, state, seg)
        times.append(clock(device) - t0)
    its, conv = to_host(summary["iterations"], summary["converged"])
    ms_per_iter = 1e3 * np.mean(times) / seg
    out = dict(
        name=name,
        B=B,
        ms_per_iter_batch=round(ms_per_iter, 2),
        us_per_iter_lane=round(1e3 * ms_per_iter / B, 1),
        compile_s=round(t_compile + t_init, 1),
        conv=round(float(conv.mean()), 3),
        iters_p50=float(np.percentile(its, 50)),
        iters_p90=float(np.percentile(its, 90)),
        # effective converged/s if iters were the only cost (streaming upper
        # bound): conv_rate / (avg_iters * iter_time)
        est_solves_s=round(
            float(conv.sum() / (np.minimum(its, n_iters).mean() * ms_per_iter / 1e3 / B * B)),
            2,
        ),
        **counted(before),
    )
    print(json.dumps(out), flush=True)
    return out


def parse_args(argv=None):
    """The command line: the JAX tool's positionals, then the port's options."""
    ap = argparse.ArgumentParser(description="srbm_lcp ms per IP iteration by setting")
    ap.add_argument("mode", nargs="?", default="quick", choices=("quick", "full"))
    ap.add_argument("--max-iter", type=int, default=200, help="iteration budget (default: 200)")
    ap.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    ap.add_argument("--out", default=None, help="record path (JSON)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from .._device import card_line, resolve_device

    device = resolve_device(args.device)
    runs = FULL_RUNS if args.mode == "full" else QUICK_RUNS
    results = [run_config(name, B, kw, device, n_iters=args.max_iter) for name, B, kw in runs]
    print("== summary ==")
    for r in results:
        print(
            f"{r['name']:>16}: {r['ms_per_iter_batch']:7.2f} ms/iter (B={r['B']})"
            f"  conv={r['conv']:.3f} p50={r['iters_p50']:.0f}"
            f" est={r['est_solves_s']}/s compile={r['compile_s']}s"
        )
    if args.out:
        write_record(args.out, {"mode": args.mode, "n_iters": args.max_iter,
                                "card": card_line(device), "runs": results})
    return 0


if __name__ == "__main__":
    sys.exit(main())
