"""Probe (a script, not a test): two ways to save the traced programs of a
saved solver, timed on the same graphs.

    python tests/probe_artifact_routes.py [--device cpu|cuda] [--n-knots 11]

For the srbm_lcp solver (f32, one scenario) it traces the init and the
iterate programs of ``runtime.artifact.save_solver`` with
``runtime.programs.trace_program`` and prints, for each, its node count and
the seconds of

- the repo's route: write the fx graph and constants
  (``runtime.programs.write_programs``) and read them back;
- ``torch.export``: ``torch.export.export`` of the traced graph (it cannot
  follow the ``torch.func`` transforms itself), ``torch.export.save`` and
  ``torch.export.load``;

and the seconds of one call of the live iteration against the read-back one.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from landing_controller_tpu_torch._tree import tree_flatten  # noqa: E402
from landing_controller_tpu_torch.api import LandingSolver  # noqa: E402
from landing_controller_tpu_torch.runtime.artifact import TRACE_Q, TRACE_QD  # noqa: E402
from landing_controller_tpu_torch.runtime.programs import (  # noqa: E402
    read_programs, trace_program, write_programs)
from landing_controller_tpu_torch.solver.ip import IPConfig  # noqa: E402


def seconds(fn):
    t0 = time.time()
    out = fn()
    return time.time() - t0, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--n-knots", type=int, default=11)
    args = ap.parse_args()
    solver = LandingSolver("srbm_lcp", n_knots=args.n_knots, dtype=torch.float32,
                           device=args.device,
                           config=IPConfig(max_iter=8, hessian_mode="gn", relax_scale=1.0,
                                           kkt_backend="cri"))
    q = torch.tensor([TRACE_Q], device=args.device)
    qd = torch.tensor([TRACE_QD], device=args.device)
    snlp, st = solver.start(q, qd)
    lanes = tuple(t for _, t in tree_flatten(snlp) + tree_flatten(st))

    def init(q, qd):
        a, b = solver.start(q, qd)
        return tuple(t for _, t in tree_flatten(a) + tree_flatten(b))

    def iterate(*leaves):
        return tuple(t for _, t in tree_flatten(solver.program(snlp).step(st)))

    print(f"torch {torch.__version__}, device {args.device}, srbm_lcp N={args.n_knots}, f32, B=1")
    for name, fn, ex in (("init", init, (q, qd)), ("iterate", iterate, lanes)):
        t_trace, (gm, _) = seconds(lambda: trace_program(fn, ex))
        nodes = len(gm.graph.nodes)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "p.bin")
            t_write, _ = seconds(lambda: write_programs(path, b"probe\n", {}, [gm]))

            def read():
                with open(path, "rb") as f:
                    f.readline()
                    f.readline()
                    return read_programs(f, args.device)[0]

            t_read, loaded = seconds(read)
        print(f"{name}: {nodes} nodes, make_fx trace {t_trace:.2f} s; repo route write "
              f"{t_write:.2f} s, read {t_read:.2f} s")
        # torch.export saves every buffer: drop the dead ones (the transforms'
        # shape probes, whose storage is gone)
        used = {n.target for n in gm.graph.nodes if n.op == "get_attr"}
        for key in [k for k in gm._buffers if k not in used]:
            del gm._buffers[key]
        t_export, ep = seconds(lambda: torch.export.export(gm, tuple(t.clone() for t in ex),
                                                           strict=False))
        ep.example_inputs = None
        buf = io.BytesIO()
        t_save, _ = seconds(lambda: torch.export.save(ep, buf))
        buf.seek(0)
        t_load, ep2 = seconds(lambda: torch.export.load(buf).module())
        print(f"{name}: torch.export export {t_export:.2f} s, save {t_save:.2f} s, load "
              f"{t_load:.2f} s ({len(buf.getvalue()) / 1e6:.2f} MB)")
        if name == "iterate":
            for label, call in (("live", lambda: iterate(*lanes)),
                                ("read back", lambda: loaded(*lanes)),
                                ("torch.export", lambda: ep2(*lanes))):
                call()
                t, _ = seconds(call)
                print(f"iterate: one call {label} {t:.4f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
