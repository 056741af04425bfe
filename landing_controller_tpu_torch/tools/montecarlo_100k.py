"""Monte-Carlo landing record on one card: the bench's solver over chunked
streaming pools.

    python -m landing_controller_tpu_torch.tools.montecarlo_100k [--n 100000] [--chunk 12800]

The counterpart of the JAX package's tools/montecarlo_100k.py:30-153.  It
streams ``--n`` drop scenarios, drawn by the benchmark's sampler from
``default_rng(2026)``, through the bench's srbm_lcp configuration (ballistic
guess, NN retry, production dt; B lanes, 25-iteration segments, deadlines
(100, 150)) in pools of ``--chunk`` scenarios, whose lane data live on the
card, and aggregates the chunks on the host into one record:

- the success-region map: convergence rate binned over (pitch, v_z), the
  reference's landing-envelope axes (plotting/pitch_xVel.m);
- iteration percentiles (the mean of the chunks' p50 and p90);
- the terminal-state envelope over converged scenarios (not in the JAX
  record, whose docstring names it);
- the card's name and power limit, the pool set-up time and peak device
  memory.

The JSON goes to ``--out`` (default: the port's ``data/montecarlo_100k.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .common import DATA_DIR, write_record

# the success-region map's bin edges (tools/montecarlo_100k.py:119-120)
PITCH_EDGES = np.linspace(-np.pi / 3, np.pi / 3, 13)
VZ_EDGES = np.linspace(-5.0, -0.5, 10)


def success_region(ics, conv):
    """Convergence rate and count per (pitch, v_z) bin of the scenarios'
    initial conditions ``ics`` (n, 12) and convergence mask ``conv``."""
    pitch, vz = ics[:, 4], ics[:, 11]
    H_all, _, _ = np.histogram2d(pitch, vz, bins=[PITCH_EDGES, VZ_EDGES])
    H_conv, _, _ = np.histogram2d(pitch[conv], vz[conv], bins=[PITCH_EDGES, VZ_EDGES])
    with np.errstate(invalid="ignore"):
        rate = np.where(H_all > 0, H_conv / np.maximum(H_all, 1), np.nan)
    return {
        "pitch_edges_rad": [round(float(x), 4) for x in PITCH_EDGES],
        "vz_edges_mps": [round(float(x), 4) for x in VZ_EDGES],
        "rate": [[None if np.isnan(v) else round(float(v), 3) for v in row] for row in rate],
        "count": [[int(v) for v in row] for row in H_all],
    }


def run_chunks(ss, n: int, chunk: int, wall_s: float):
    """Stream ``n`` scenarios through the StreamingSolver ``ss`` (which
    collects z) in pools of ``chunk``, until done or ``wall_s`` has passed;
    returns the aggregated record (without the device keys)."""
    import torch

    t0 = time.time()
    deadline = t0 + wall_s
    ics_l, conv_l, xT_l, p50s, p90s = [], [], [], [], []
    n_fin = n_conv = 0
    setup_s = 0.0
    while n_fin < n and time.time() < deadline - 60:
        P = min(chunk, n - n_fin)
        t1 = time.time()
        stats = ss.run(P, max_wall_s=max(60.0, deadline - time.time()))
        setup_s += time.time() - t1 - stats["wall_s"]
        n_fin += stats["n_finished"]
        n_conv += stats["n_converged"]
        conv = stats["converged_mask"]
        ics_l.append(stats["ics"])
        conv_l.append(conv)
        xT_l.append(ss.solver.problem.unpack(torch.as_tensor(stats["z"][conv])).X[:, -1].numpy())
        p50s.append(stats["iters_p50"])
        p90s.append(stats["iters_p90"])
        print(f"[mc] {n_fin}/{n} finished, conv {n_conv / max(n_fin, 1):.4f}, "
              f"{n_fin / (time.time() - t0):.1f} fin/s, t={time.time() - t0:.0f}s", flush=True)
    wall = time.time() - t0
    ics, conv, xT = np.concatenate(ics_l), np.concatenate(conv_l), np.concatenate(xT_l)
    return {
        "metric": "montecarlo_landing_100k",
        "n_requested": n,
        "n_finished": int(n_fin),
        "n_converged": int(n_conv),
        "convergence_rate": round(n_conv / max(n_fin, 1), 4),
        "wall_s": round(wall, 1),
        "converged_per_sec_per_chip": round(n_conv / wall, 2),
        "iters_p50": float(np.mean(p50s)),
        "iters_p90": float(np.mean(p90s)),
        "config": "srbm_lcp N=21 production-dt, ballistic guess + nn retry",
        "success_region": success_region(ics, conv),
        "terminal_envelope": {
            "min": None if not len(xT) else np.round(xT.min(0).astype(np.float64), 4).tolist(),
            "max": None if not len(xT) else np.round(xT.max(0).astype(np.float64), 4).tolist(),
        },
        "chunk": chunk,
        "pool_setup_s": round(setup_s, 2),
        "reference": "analysis/foot_positions.m:32-43 serial sweep; "
                     "plotting/pitch_xVel.m envelope axes",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Monte-Carlo landing record on one card")
    ap.add_argument("--n", type=int, default=100_000, help="scenarios in all")
    ap.add_argument("--batch", type=int, default=64, help="lanes")
    ap.add_argument("--chunk", type=int, default=12_800, help="scenarios per pool (MC_CHUNK)")
    ap.add_argument("--wall-s", type=float, default=3600.0, help="wall budget (MC_WALL_S)")
    ap.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    ap.add_argument("--out", default=os.path.join(DATA_DIR, "montecarlo_100k.json"))
    args = ap.parse_args(argv)

    import torch

    from .._device import card_line, resolve_device
    from ..bench import bench_solver, bench_stream, make_sampler
    from ..runtime import enable_persistent_cache

    device = resolve_device(args.device)
    enable_persistent_cache()
    # chunked pools: the lane data of a pool live on the card (2 variants x
    # P scenarios); the JAX package sized 12,800 for a 16 GB TPU
    ss = bench_stream(bench_solver(device), make_sampler(2026), args.batch, collect_z=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = run_chunks(ss, args.n, args.chunk, args.wall_s)
    out["card"] = card_line(device)
    out["peak_device_memory_gb"] = (torch.cuda.max_memory_allocated(device) / 1e9
                                    if device.type == "cuda" else None)
    write_record(args.out, out)
    print(json.dumps({k: v for k, v in out.items() if k != "success_region"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
