"""Device time of each kernel by the port's span open at its launch, over a
few eager iterations of a benchmark cell's lanes (a script, not a test;
card only):

    python tests/probe_kernels_by_span.py [--workload eeparam.b512] [--seed N] [--iters 4]

The stream replays its iteration from a captured CUDA graph, inside which
the phases carry no spans, so this runs the stream's iteration eagerly: the
cell's solver (``benchmarks.harness.build_solver``), B lanes of the cell's
drops, three warm-up iterations, then ``--iters`` iterations with the spans
on (``landing_controller_tpu_torch.tracing``) under a CUDA-activity
profile.  Each kernel is tied to its launch by the trace's correlation id
and charged to the innermost span open on the host at the launch.  Prints
the device ms an iteration by span, the 25 largest (span, kernel) pairs,
and for a few name patterns (``gemv``, ``trsm``, ``potrf``) the ms an
iteration in all and inside ``newton.solve``.
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmarks.harness import build_solver, draw, load_cell  # noqa: E402
from landing_controller_tpu_torch import tracing  # noqa: E402
from landing_controller_tpu_torch.parallel.stream import StreamingSolver  # noqa: E402

PATTERNS = ("gemv", "trsm", "potrf")


def kernels_by_span(doc, spans):
    """{(span, kernel name): device ms} from a Chrome trace and the spans."""
    base = int(doc.get("baseTimeNanoseconds", 0))
    launched, kernels = {}, []
    for e in doc["traceEvents"]:
        if e.get("ph") != "X":
            continue
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr is not None:
            launched[corr] = int(round(float(e["ts"]) * 1e3)) + base
        elif e.get("cat") == "kernel":
            kernels.append((e["name"], float(e.get("dur", 0)) * 1e-3, corr))
    closed = [(name, s, e) for name, s, e, _ in spans if e is not None]

    def innermost(t):
        inside = [(s, name) for name, s, e in closed if s <= t < e]
        return max(inside)[1] if inside else "(no span)"

    out: dict = {}
    for name, ms, corr in kernels:
        key = (innermost(launched[corr]) if corr in launched else "(no launch)", name)
        out[key] = out.get(key, 0.0) + ms
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="eeparam.b512")
    ap.add_argument("--seed", type=int, default=1234567891)
    ap.add_argument("--iters", type=int, default=4)
    args = ap.parse_args()
    cell = load_cell(args.workload)
    cfg, B = cell.config, cell.mix["lanes"]
    solver = build_solver(cfg, torch.device("cuda"))
    ss = StreamingSolver(solver, batch=B, segment=cfg["segment"], sampler=None,
                         attempt_iters=tuple(cfg["attempt_iters"]))
    q, qd = draw(cell.mix, args.seed, B, 0)
    t0 = time.time()
    lanes = ss._pool_states(torch.as_tensor(q, device="cuda"), torch.as_tensor(qd, device="cuda"), 0)
    for _ in range(3):
        lanes = ss._iterate(lanes)
    torch.cuda.synchronize()
    print(f"# {args.workload}: B={B}, set-up and 3 warm-up iterations {time.time() - t0:.1f} s", flush=True)
    tracing.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(args.iters):
            with tracing.span("solver.iteration"):
                lanes = ss._iterate(lanes)
        torch.cuda.synchronize()
    tracing.disable()
    path = os.path.join(tempfile.mkdtemp(), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    os.remove(path)
    by = kernels_by_span(doc, tracing.spans())
    n = args.iters
    print(f"# {n} eager iterations, device kernel time {sum(by.values()) / n:.2f} ms an iteration; "
          f"torch {torch.__version__}")
    per_span: dict = {}
    for (span, _), ms in by.items():
        per_span[span] = per_span.get(span, 0.0) + ms
    for span, ms in sorted(per_span.items(), key=lambda kv: -kv[1]):
        print(f"[span] {span}: {ms / n:.3f} ms an iteration")
    for (span, name), ms in sorted(by.items(), key=lambda kv: -kv[1])[:25]:
        print(f"[kernel] {span} | {name[:110]} | {ms / n:.3f} ms an iteration")
    for pat in PATTERNS:
        every = sum(ms for (_, name), ms in by.items() if pat in name)
        solve = sum(ms for (span, name), ms in by.items() if pat in name and span == "newton.solve")
        print(f"[pattern] {pat}: {every / n:.3f} ms an iteration, in newton.solve {solve / n:.3f}")


if __name__ == "__main__":
    main()
