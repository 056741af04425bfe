"""Tuning sweep of the srbm_lcp solver on cri: converged solves/s by setting
and batch size.

    python -m landing_controller_tpu_torch.tools.tune_sweep [config ...]

The counterpart of the JAX package's tools/tune_sweep.py:38-105: each named
entry of :data:`CONFIGS` (all by default) is one srbm_lcp solver (the
settings of :func:`.common.kino_config` with the entry's, reference guess)
whose ``solve_batch`` runs twice on the same drops, a first pass and a
timed one; ``_B`` sets the batch (64) and ``_sampler`` the drops (legacy,
:func:`.common.legacy_ics`; reference, the production distribution from a
torch generator).  One line per entry: wall, ``comp`` (the first pass),
conv, iterations p50/p90, converged solves/s.  ``--out`` writes the record.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .common import clock, counted, counts, kino_config, sampled_ics, to_host, write_record

_LEAN = dict(ladder_scales=(0.0, 1.0), refine_steps=1, n_linesearch=4)
CONFIGS = {
    "ladder2": dict(ladder_scales=(0.0, 1.0)),
    "ladder2_refine1": dict(ladder_scales=(0.0, 1.0), refine_steps=1),
    "b256": dict(_B=256),
    "loqo": dict(mu_strategy="loqo"),
    "refsampler": dict(_sampler="reference"),
    "maxiter120": dict(max_iter=120),
    "base": dict(),
    "stall_lean": dict(_LEAN),
    "stall_base": dict(),
    "lean_mu2": dict(_LEAN, mu_init=1e-2),
    "lean_kmu01": dict(_LEAN, kappa_mu=0.1),
    "lean_b256": dict(_LEAN, _B=256),
    "lean_ref": dict(_LEAN, _sampler="reference"),
    "lean_mi150": dict(_LEAN, max_iter=150),
    "b512": dict(_B=512),
    "b128": dict(_B=128),
    "lean": dict(_LEAN),
}

# the keys of each entry's record: the values of the JAX tool's line (tune_sweep.py:64-68)
RUN_KEYS = ("B", "wall_s", "comp_s", "conv", "it_p50", "it_p90", "solves_s")


def run_cfg(name, B, device, sampler="legacy", **kw):
    """One entry: its line printed, its record returned."""
    import torch

    from ..api import LandingSolver

    solver = LandingSolver("srbm_lcp", dtype=torch.float32, structured=True,
                           config=kino_config(**kw), device=device)
    q0s, qd0s = sampled_ics(B, sampler=sampler)
    before = counts()
    t0 = clock(device)
    solver.solve_batch(q0s, qd0s)
    tc = clock(device) - t0
    t0 = clock(device)
    sols = solver.solve_batch(q0s, qd0s)
    dt = clock(device) - t0
    conv, its = to_host(sols.converged, sols.iterations)
    print(
        f"{name:40s} B={B:4d} wall={dt:6.2f}s comp={tc:5.0f}s conv={conv.mean():.3f} "
        f"it p50/p90={np.percentile(its,50):3.0f}/{np.percentile(its,90):3.0f} "
        f"solves/s={conv.sum()/dt:7.2f}",
        flush=True,
    )
    return {"B": B, "sampler": sampler, "max_iter": solver.config.max_iter, "wall_s": dt,
            "comp_s": tc, "conv": float(conv.mean()), "it_p50": float(np.percentile(its, 50)),
            "it_p90": float(np.percentile(its, 90)), "solves_s": float(conv.sum() / dt),
            **counted(before)}


def parse_args(argv=None):
    """The command line: the JAX tool's positionals, then the port's options."""
    ap = argparse.ArgumentParser(description="srbm_lcp tuning sweep on cri")
    ap.add_argument("configs", nargs="*", help=f"of {list(CONFIGS)} (all)")
    ap.add_argument("--max-iter", type=int, default=None,
                    help="every entry's iteration cap (default: its own)")
    ap.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    ap.add_argument("--out", default=None, help="record path (JSON)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from .._device import card_line, resolve_device

    device = resolve_device(args.device)
    record = {"card": card_line(device), "configs": {}}
    for name in args.configs or list(CONFIGS):
        kw = dict(CONFIGS[name])
        B = kw.pop("_B", 64)
        sampler = kw.pop("_sampler", "legacy")
        if args.max_iter is not None:
            kw["max_iter"] = args.max_iter
        record["configs"][name] = run_cfg(name, B, device, sampler=sampler, **kw)
    if args.out:
        write_record(args.out, record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
