"""The numbers that decide ``correct``, read over many seeds: each run gives
the program's readings (the lower ones) and, with ``--control``, the
control's from the same answers (the upper ones): the reference computed in
TF32, the precision below the configuration's float32 with TF32 off, put in
the program's place (see ``harness.judge``).

    python3 benchmarks/control.py --workload <name> --seeds 1,2,3 --seconds 20 \\
        [--control] [--out chiprun_out/control.jsonl]

One JSON line per run (seed, correct, the program's checks and, with
``--control``, the control's) on standard output and in ``--out``.  The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from benchmarks.harness import run_cell

    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        result, checks = run_cell(args.workload, seed, args.seconds, False,
                                  log=lambda *a, **k: None, control=args.control)
        line = {"workload": args.workload, "seed": seed, "correct": result["correct"],
                "attempted": result["attempted"], "metrics": result["metrics"],
                "wall_s": round(time.time() - t, 1)}
        if args.control:
            line.update(program=result["program_checks"], control={k: v for k, (v, _) in checks.items()})
        else:
            line["program"] = {k: v for k, (v, _) in checks.items()}
        line = json.dumps(line)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
