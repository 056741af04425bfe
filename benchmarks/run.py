"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 benchmarks/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Measures ``landing_controller_tpu_torch`` on one NVIDIA card, and nothing of
the JAX package.  Prints the cell's end-to-end metrics (``--trace 0``) or
its per-layer metrics (``--trace 1``) as the last line of standard output,
one JSON object, and each number that decides ``correct`` beside its limit
as the last lines of standard error.  Exits non-zero without printing a
result where the machine has fewer cards than the cell asks for, or where
JAX or the JAX package was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache of the program and of PyTorch stays inside the checkout, at a
# fixed path, so that only a checkout's first run builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)
# one process with few threads: the program's host work is one Python
# thread, and idle worker pools on a shared host only add noise
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmarks.harness import NoCard, import_offenders, run_cell

    torch.set_num_threads(1)

    try:
        result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    except NoCard as err:
        print(f"no result: {err}", file=sys.stderr)
        return 2
    offenders = import_offenders()
    if offenders:
        print(f"no result: the process loaded {', '.join(offenders)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
