"""The landing benchmark's harness: one cell, one seed, one run.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix, each a file of its own that the harness finds by name:

- ``configs/<config>.json``: the solver as it is run (problem kind, every
  IPConfig field, guesses, stream segment and attempt deadlines, the robot's
  constants, the limits of the comparison that decides ``correct``), with
  ``reference/<config>.py`` beside it;
- ``traffic/<traffic>.json``: the lanes B, the pool P and the drop
  distribution that ``samplers/<generator>.py`` draws from the seed;
- ``metrics/<metric>.py``: one reader per metric of ``BENCHMARK.json``.

The window is a stretch of ``StreamingSolver.run``'s own segment loop over
a pool of P drops with ``collect_z`` on: B lanes act as B clients of a
closed loop, each taking the pool's next drop when its own finishes, a
failed first attempt retrying in place.  The loop starts with every lane on
a fresh drop, so for as long as the longest drop may take (the
configuration's ``ramp_iterations``, its attempts' deadlines summed) it
harvests only early finishers.  The window opens at the first segment end
after that ramp (or where the stream starts its clock, for a ramp of 0) and
closes at the first segment end after ``--seconds`` more; it counts all
the work and all the time in between.  Before it: the solver's build from
the configuration file, the kernels' load (built by nvcc into the
checkout's ``build/kernels`` on a checkout's first run), one warm-up
segment at the cell's own B on a pool of B drops, the measured pool's
set-up, and the ramp.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "landing_controller_tpu")
NOT_A_NUMBER = 1e300  # what a compared number that is not finite reads as


class NoCard(RuntimeError):
    """The cell asks for more cards than the machine has."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    """The Python file ``path`` as a module named ``name`` (file names of
    metrics carry dots, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def import_offenders(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (the port's name only begins with the latter's)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict  # the workloads entry
    config: dict  # configs/<config>.json
    mix: dict  # traffic/<traffic>.json
    end_to_end: list  # BENCHMARK.json entries that this cell reports
    per_layer: list


def load_cell(name: str, bench_path: str | None = None, traffic_dir: str | None = None) -> Cell:
    bench = load_json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    spec = next((w for w in bench["workloads"] if w["name"] == name), None)
    if spec is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == spec["config"])
    config = {**load_json(os.path.join(ROOT, conf["file"])), "name": conf["name"]}
    mix = load_json(os.path.join(traffic_dir or os.path.join(HERE, "traffic"), spec["traffic"] + ".json"))

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name, spec, config, mix, mine(bench["end_to_end"]), mine(bench["per_layer"]))


def draw(mix: dict, seed: int, n: int, stream: int):
    gen = load_module(os.path.join(HERE, "samplers", mix["generator"] + ".py"),
                      "bench_sampler_" + mix["generator"])
    return gen.draw(mix, seed, n, stream)


def build_solver(cfg: dict, device):
    """The configuration's LandingSolver, every setting from the file."""
    import torch

    from landing_controller_tpu_torch.api import LandingSolver
    from landing_controller_tpu_torch.solver.ip import IPConfig

    ip = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["ip"].items()}
    dtype = getattr(torch, cfg["dtype"])
    over = {k: np.asarray(v, np.float64).astype(cfg["dtype"]) for k, v in cfg["theta_overrides"].items()}
    return LandingSolver(cfg["kind"], n_knots=cfg["n_knots"], config=IPConfig(**ip), dtype=dtype,
                         theta_overrides=over or None, structured=cfg["structured"],
                         guess=cfg["guess"], retry_guess=tuple(cfg["retry_guess"]) or None,
                         device=device, nn_path=os.path.join(ROOT, cfg["nn_path"]))


class Feed:
    """The stream's sampler: hands out the arrays it was last given."""

    def __init__(self):
        self.q = self.qd = None

    def __call__(self, n):
        if self.q is None or len(self.q) != n:
            raise RuntimeError(f"the stream asked for {n} drops, the feed holds "
                               f"{None if self.q is None else len(self.q)}")
        return self.q, self.qd


class Deadline(float):
    """``max_wall_s`` of ``StreamingSolver.run`` that the window moves: the
    stream compares its clock with it after every segment's callback, and
    the window sets it, once it opens, to its opening plus ``--seconds``."""

    def __new__(cls, at: float):
        self = super().__new__(cls, at)
        self.at = float(at)
        return self

    def __float__(self):
        return self.at

    def __lt__(self, other):
        return self.at < other

    def __le__(self, other):
        return self.at <= other

    def __gt__(self, other):
        return self.at > other

    def __ge__(self, other):
        return self.at >= other


class Window:
    """The stream's per-segment callback: counts segments, finished and
    converged scenarios after each harvest, opens the window at the first
    harvest after ``ramp`` segments and then sets the stream's deadline,
    and starts and stops the profiler around a bounded stretch of
    segments."""

    def __init__(self, batch, pool, segment, deadlines, tracer=None, ramp=0, seconds=math.inf):
        self.B, self.P, self.segment = batch, pool, segment
        self.deadlines = tuple(deadlines)
        self.ramp = int(ramp)  # segments before the window opens
        self.seconds = float(seconds)
        self.deadline = Deadline(self.seconds if self.ramp == 0 else math.inf)
        self.finished = []  # cumulative finished count after each harvest
        self.converged = []  # cumulative converged count after each harvest
        self.walls = []  # the stream's clock after each harvest
        self.opened = None  # time.time() at which the window opened
        self.tracer = tracer

    def __call__(self, stats):
        now = time.time()
        if self.opened is None and self.ramp == 0:
            self.opened = now - stats["wall_s"]
        self.finished.append(stats["n_finished"])
        self.converged.append(stats["n_converged"])
        self.walls.append(stats["wall_s"])
        if self.opened is None and len(self.walls) == self.ramp:
            self.opened = now
            self.deadline.at = stats["wall_s"] + self.seconds
        if self.tracer is not None:
            self.tracer.at_harvest(len(self.finished) - 1)

    def stretch(self) -> dict:
        """The window's segments, length, finished and converged (all the
        work and time after it opened)."""
        r = self.ramp
        base = (self.walls[r - 1], self.finished[r - 1], self.converged[r - 1]) if r else (0.0, 0, 0)
        if self.opened is None or len(self.walls) <= r:
            return {"segments": 0, "wall_s": 0.0, "n_finished": 0, "n_converged": 0}
        return {"segments": len(self.walls) - r, "wall_s": self.walls[-1] - base[0],
                "n_finished": self.finished[-1] - base[1], "n_converged": self.converged[-1] - base[2]}

    @property
    def segments(self) -> int:
        return len(self.finished)

    def drained(self) -> bool:
        return bool(self.finished) and self.B + self.finished[-1] >= self.P

    def due_harvest(self, i: int):
        """Harvest index by which pool scenario i has used every attempt's
        deadline, or None if it was not started in the window."""
        if i >= self.P:
            return None
        if i < self.B:
            start = 0
        else:
            later = [t for t, n in enumerate(self.finished) if self.B + n > i]
            if not later:
                return None
            start = later[0] + 1
        return start + sum(math.ceil(d / self.segment) for d in self.deadlines) - 1

    def overdue(self, finished_ids) -> int:
        """Scenarios whose whole iteration budget ran out in the window but
        that were never harvested (an answer that never came)."""
        last = self.segments - 1
        done = set(int(i) for i in finished_ids)
        count = 0
        for i in range(min(self.P, self.B + (self.finished[-1] if self.finished else 0))):
            due = self.due_harvest(i)
            if due is not None and due <= last and i not in done:
                count += 1
        return count


class Tracer:
    """Profiles harvest ``first`` + 1 .. ``first`` + ``count`` (whole
    segments; the stream's host read has synchronised at both ends)."""

    def __init__(self, first: int, count: int, segment: int, on_card: bool = True):
        self.first, self.count, self.segment = first, count, segment
        self.on_card = on_card
        self.prof = None
        self.t0 = self.t1 = None
        self.stop_s = 0.0

    def at_harvest(self, t: int):
        import torch

        if t == self.first:
            act = torch.profiler.ProfilerActivity
            self.prof = torch.profiler.profile(activities=[act.CUDA if self.on_card else act.CPU])
            self.prof.start()
            self.t0 = time.perf_counter()
        elif t == self.first + self.count and self.prof is not None and self.t1 is None:
            self.t1 = time.perf_counter()
            self.prof.stop()
            self.stop_s = time.perf_counter() - self.t1

    def result(self):
        from benchmarks.trace import Trace, events_of

        if self.t1 is None:
            return None
        path = os.path.join(ROOT, "build", "bench_cache", "trace.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return Trace(window_s=self.t1 - self.t0, iterations=self.count * self.segment,
                     events=events_of(self.prof, path))


def card_sample():
    """The card's SM clock, power draw, power limit and temperature
    (``nvidia-smi``), or why they could not be read."""
    try:
        out = subprocess.run(["nvidia-smi", "-i", "0", "--format=csv,noheader",
                              "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu"],
                             capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as err:
        return f"unavailable: {err}"
    return out.stdout.strip().splitlines()[0]


def pool_index(pool_q, pool_qd, ics):
    """Pool index of each returned drop (its q, qd rows), -1 where the drop
    is not one the harness handed out."""
    rows = np.concatenate([pool_q, pool_qd], 1).astype(np.float32)
    where = {r.tobytes(): i for i, r in enumerate(rows)}
    return np.array([where.get(np.asarray(r, np.float32).tobytes(), -1) for r in ics], np.int64)


def judge(cell: Cell, pool_q, pool_qd, stats, window: Window, device, block=256, control=False):
    """The comparison that decides ``correct``: every scenario finished
    since the stream started, against the plain reference in float64
    (``kkt_error`` where the configuration gives it a limit).
    Returns (checks {name: (value, limit)}, failed, control checks or None).

    ``control``: also the checks of the control that the limits are set
    against, the reference in TF32 put in the program's place: the TF32
    reference's violation stands for each reported violation, and the
    returned trajectory, rounded to TF32, for each converged answer."""
    import torch

    from benchmarks.reference.landing import to_tf32

    cfg = cell.config
    limits = cfg["limits"]
    ics = stats["ics"]
    n_fin = len(ics)
    ids = pool_index(pool_q, pool_qd, ics) if n_fin else np.zeros(0, np.int64)
    z = np.asarray(stats.get("z", np.zeros((0, 0))), np.float64)
    rep = np.asarray(stats["viol"], np.float64)
    conv = np.asarray(stats["converged_mask"], bool)
    if len(z) != n_fin or len(rep) != n_fin:
        lost, nonfinite, ok = n_fin, 0, np.zeros(n_fin, bool)
    else:
        finite = np.isfinite(z).all(1) & np.isfinite(rep)
        lost = int((ids < 0).sum()) + n_fin - len(set(ids[ids >= 0].tolist()))
        nonfinite = int(((ids >= 0) & ~finite).sum())
        ok = (ids >= 0) & finite
    V = len(cfg["attempt_iters"])
    variants = ([cfg["guess"]] + list(cfg["retry_guess"]))[:V]
    ref_mod = load_module(os.path.join(HERE, "reference", cfg["name"] + ".py"), "bench_ref_" + cfg["name"])
    ref = ref_mod.make(cfg, device)
    ctrl = ref_mod.make(cfg, device, "tf32") if control else None
    memory = (8 << 30) if torch.device(device).type == "cuda" else (1 << 30)  # the KKT fit's blocks
    sides = ["program"] + (["control"] if control else [])
    gaps = {k: [] for k in sides}
    kkt = {k: [] for k in sides}
    conv_ref = []
    keep = np.flatnonzero(ok)
    for b0 in range(0, len(keep), block):
        sel = keep[b0:b0 + block]
        q = torch.as_tensor(pool_q[ids[sel]], dtype=torch.float64, device=device)
        qd = torch.as_tensor(pool_qd[ids[sel]], dtype=torch.float64, device=device)
        zz = torch.as_tensor(z[sel], dtype=torch.float64, device=device)
        ref_v, th, (fs, se, sg) = ref.evaluate(q, qd, zz, variants)  # (b, V)
        ref_v = ref_v.cpu().numpy()
        said = {"program": rep[sel, None]}
        if ctrl is not None:
            said["control"] = ctrl.violation(q, qd, zz, variants).double().cpu().numpy()
        # the cold-guess family whose scales the program used: its violation
        # matches the one the program reports
        best = np.argmin(np.nan_to_num(np.abs(rep[sel, None] - ref_v), nan=np.inf), 1)
        rows = np.arange(len(sel))
        for side in sides:
            gap_v = np.abs(said[side] - ref_v) / np.maximum(1.0, ref_v)
            gaps[side].append(np.min(np.nan_to_num(gap_v, nan=np.inf), 1))
        conv_ref.append(ref_v[rows, best][conv[sel]])
        # the KKT error of each converged answer at the reference's own
        # multipliers, under the scales of its family
        c = np.flatnonzero(conv[sel]) if "kkt_error" in limits else []
        if len(c):
            ct = torch.as_tensor(c, device=device)
            bt = torch.as_tensor(best[c], device=device)
            sub = {k: v[ct] for k, v in th.items()}
            args = (fs[ct, bt], se[ct, bt], sg[ct, bt])
            kkt["program"].append(ref.optimality(zz[ct], sub, *args, memory=memory).cpu().numpy())
            if ctrl is not None:
                kkt["control"].append(ref.optimality(to_tf32(zz[ct]).double(), sub, *args,
                                                     memory=memory).cpu().numpy())

    def worst(parts):
        parts = [p for p in parts if len(p)]
        return float(np.max(np.concatenate(parts))) if parts else 0.0

    def checks_of(side):
        checks = {
            "answered": (int(n_fin == 0), 0),
            "overdue": (window.overdue(ids[ids >= 0]), 0),
            "lost": (lost, 0),
            "nonfinite": (nonfinite, 0),
            "viol_gap": (worst(gaps[side]), limits["viol_gap"]),
            "conv_viol": (worst(conv_ref), cfg["ip"]["constr_viol_tol"]),
        }
        if "kkt_error" in limits:
            checks["kkt_error"] = (worst(kkt[side]), limits["kkt_error"])
        # a gap that is not a number fails its limit; JSON holds no NaN or inf
        return {k: (v if np.isfinite(v) else NOT_A_NUMBER, lim) for k, (v, lim) in checks.items()}

    return checks_of("program"), lost + nonfinite, checks_of("control") if control else None


def run_cell(name, seed, seconds, trace, device="cuda", t_start=None, hooks=None, bench_path=None,
             traffic_dir=None, log=print, control=False):
    """One run of the cell.  Returns (result dict, checks).  ``hooks``
    (tests) may replace the stream or the solver before the window;
    ``device`` "cpu" skips the look for a card; ``control`` puts the
    control in the program's place (see :func:`judge`)."""
    t_start = time.time() if t_start is None else t_start
    cell = load_cell(name, bench_path, traffic_dir)
    import torch

    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.spec["chips"]:
            raise NoCard(f"cell {name} needs {cell.spec['chips']} card(s); torch.cuda sees "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    from landing_controller_tpu_torch.parallel.stream import StreamingSolver

    cfg, mix = cell.config, cell.mix
    B, P = mix["lanes"], mix["pool"]
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t_build = time.time()
    solver = build_solver(cfg, dev)
    if hooks and "solver" in hooks:
        hooks["solver"](solver)
    feed = Feed()
    ss = StreamingSolver(solver, batch=B, segment=cfg["segment"], sampler=feed,
                         attempt_iters=tuple(cfg["attempt_iters"]), collect_z=True)
    if hooks and "stream" in hooks:
        hooks["stream"](ss)
    # warm-up: one segment at the cell's own B, on B drops of another stream
    feed.q, feed.qd = draw(mix, seed, B, stream=1)
    t_warm = time.time()
    ss.run(B, max_wall_s=0.0)
    sync()
    t_pool = time.time()
    pool_q, pool_qd = draw(mix, seed, P, stream=0)
    feed.q, feed.qd = pool_q, pool_qd
    ramp = math.ceil(cfg["ramp_iterations"] / cfg["segment"])
    tracer = Tracer(first=ramp, count=1, segment=cfg["segment"], on_card=dev.type == "cuda") if trace else None
    window = Window(B, P, cfg["segment"], cfg["attempt_iters"], tracer, ramp=ramp, seconds=seconds)
    # the card's clocks and power just before and just after the window (a
    # sampler inside it would take the host's cores from the program)
    card = [card_sample()] if dev.type == "cuda" else []
    stats = ss.run(P, max_wall_s=window.deadline, progress_cb=window)
    sync()
    t_end = time.time()
    if card:
        card.append(card_sample())
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    if window.drained():
        log(f"# pool drained: {P} drops all handed out before the window closed; "
            "a later benchmark change raises the pool", file=sys.stderr)
    if window.opened is None:
        raise RuntimeError(f"the stream stopped after {window.segments} segments, before the window "
                           f"opened ({ramp} segments of ramp)")
    w = {**window.stretch(), "segment": cfg["segment"], "iters_p50": stats["iters_p50"],
         "n_finished_all": stats["n_finished"], "setup_s": window.opened - t_start}
    t_ramp = window.opened - (window.walls[ramp - 1] if ramp else 0.0)
    log(f"# window: {w['segments']} segments of {cfg['segment']} iterations in {w['wall_s']:.3f} s, "
        f"{w['n_finished']} finished, {w['n_converged']} converged (since the stream started: "
        f"{stats['n_finished']} finished, {stats['n_converged']} converged in {stats['wall_s']:.3f} s); "
        f"peak memory {peak} B", file=sys.stderr)
    log(f"# set-up {w['setup_s']:.3f} s: start {t_build - t_start:.1f} s, solver {t_warm - t_build:.1f} s, "
        f"warm-up {t_pool - t_warm:.1f} s, pool of {P} {t_ramp - t_pool:.1f} s, ramp of {ramp} segments "
        f"{window.opened - t_ramp:.1f} s", file=sys.stderr)
    log("# segment seconds: " + " ".join(f"{b - a:.3f}" for a, b in zip([0.0] + window.walls, window.walls)),
        file=sys.stderr)
    for when, sample in zip(("before", "after"), card):
        log(f"# card {when} the window: clocks.sm, power.draw, power.limit, temperature: {sample}",
            file=sys.stderr)
    tr = tracer.result() if tracer is not None else None
    if tr is not None:
        log(f"# trace: {tracer.count} segment(s), {len(tr.events)} events, stop {tracer.stop_s:.1f} s, "
            f"read {time.time() - t_end:.1f} s", file=sys.stderr)
    # free the program's state before the reference runs
    del ss, solver
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ctx = {"window": w, "trace": tr, "config": cfg, "mix": mix, "cell": cell.spec}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        reader = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"), "bench_metric_" + m["name"])
        value = reader.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    t_ref = time.time()
    checks, failed, control_checks = judge(cell, pool_q, pool_qd, stats, window, dev, control=control)
    log(f"# reference: {len(stats['ics'])} drops in {time.time() - t_ref:.1f} s", file=sys.stderr)
    correct = all(v <= lim for v, lim in checks.values())
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell.spec["chips"], "memory_peak_bytes": peak}
    if card:
        device_info["power_limit"] = card[0].split(", ")[2] if card[0].count(", ") == 3 else card[0]
    if tr is not None:
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
    result = {"correct": bool(correct), "attempted": int(stats["n_finished"]), "failed": int(failed),
              "metrics": metrics, "device": device_info}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    if control_checks is not None:
        # the control's run: the control in the program's place decides
        # ``correct``; the program's own checks of the same run beside it
        result["correct"] = all(v <= lim for v, lim in control_checks.values())
        result["program_checks"] = {k: v for k, (v, _) in checks.items()}
        checks = control_checks
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result, checks
