"""Streaming batched solver: continuous scenario throughput.

A batched interior-point solve runs until every lane finishes, so batch wall
time is the slowest lane's.  This solver runs the solve in K-iteration
segments and refills finished lanes with fresh scenarios, so throughput
scales with the average iteration count instead of the maximum.

Four pieces of the design keep the host out of the way:

- the pool's initial lane data (scaled problem + IPState) is precomputed
  once per cold-guess variant, B scenarios per call, before the run;
- harvest and refill are gathers and scatters on the device: finished lanes
  scatter their results into per-scenario slots, and refilled or retrying
  lanes gather their fresh lane data from the pool;
- the host reads one small packed stats tensor per segment;
- on a card, one masked iteration of the solver (the structured step's or
  the dense KKT step's) is captured once as a CUDA graph
  (:class:`_IterationGraph`) and replayed ``segment`` times a segment, so
  an iteration costs one launch instead of thousands.

The step of pool size P (:meth:`StreamingSolver.get_step`) is ``segment``
masked IP iterations followed by one harvest-and-refill; it can be saved
(:meth:`StreamingSolver.export_step`: the per-variant pool init, the
iteration and the harvest and refill, as ``torch.export`` programs) and
loaded by another process (:meth:`StreamingSolver.load_step`), whose
:meth:`StreamingSolver.run` then runs the loaded programs.

A scenario whose first attempt fails is re-solved in place down the
solver's retry chain (variant k uses ``retry_guess[k-1]``), each attempt
under its own iteration deadline; its recorded iteration count is the sum
over attempts.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Callable

import numpy as np
import torch

from torch.utils._python_dispatch import _get_current_dispatch_mode

from .._tree import tree_cat, tree_flatten, tree_map, tree_stack, tree_where
from ..solver.ip import IPState
from ..solver.scaling import ScaledNLP
from ..tracing import count, counters, finish_device_reads, span, start_device_reads

# the saved step's file: this line, one JSON header line, then the programs
STEP_MAGIC = b"LCSTRMT2\n"


@dataclasses.dataclass(frozen=True)
class _Lanes:
    """Per lane: the scaled problem's tensors (parameters and scales) and the
    solver state; only tensors, so that a saved program takes and returns it."""

    theta: object  # the solver's params_type (LandingParams, EEParamParams)
    z_scale: torch.Tensor
    f_scale: torch.Tensor
    eq_scale: torch.Tensor
    ineq_scale: torch.Tensor
    state: IPState

    @staticmethod
    def of(snlp: ScaledNLP, state: IPState) -> "_Lanes":
        return _Lanes(theta=snlp.theta, z_scale=snlp.z_scale, f_scale=snlp.f_scale,
                      eq_scale=snlp.eq_scale, ineq_scale=snlp.ineq_scale, state=state)

    def snlp(self, problem) -> ScaledNLP:
        return ScaledNLP(problem=problem, theta=self.theta, z_scale=self.z_scale,
                         f_scale=self.f_scale, eq_scale=self.eq_scale, ineq_scale=self.ineq_scale)


@dataclasses.dataclass(frozen=True)
class _StreamCarry:
    lane_sid: torch.Tensor  # (B,) scenario id per lane (P = retired/dump)
    lane_variant: torch.Tensor  # (B,) cold-guess variant (retry policy)
    lane_prev_iters: torch.Tensor  # (B,) iterations spent in earlier attempts
    lanes: _Lanes
    cursor: torch.Tensor  # next unassigned pool index
    active: torch.Tensor  # (B,) lane owns an unharvested scenario
    # packed per-scenario results, (5, P+1): finished flag, converged flag,
    # iterations, constraint violation, attempts; column P is the dump slot
    res: torch.Tensor
    res_z: torch.Tensor  # (P+1, n_vars) harvested solutions (collect_z) or (P+1, 0)


class _IterationGraph:
    """One masked IP iteration of B lanes, captured as a CUDA graph over
    static lane buffers (``lanes``).  :meth:`load` copies a carry's lanes in;
    each :meth:`replay` runs the iteration on them and, as the graph's last
    operations, copies the new state back, so the buffers advance in place.

    Before the capture a few eager iterations run on a side stream (results
    dropped), as CUDA graph capture wants, which also builds every cached
    constant and kernel the iteration uses.  The counters those iterations
    and the capture add are taken back, and what one captured iteration
    counted on the host (``qd_inverse.launches``) is added at each replay,
    so that :func:`..tracing.counters` reads what the eager iterations
    would; a device counter (``dense_kkt.emergency``) counts in the graph
    itself."""

    WARMUP = 3

    def __init__(self, iterate, lanes: _Lanes):
        self.lanes = tree_map(torch.clone, lanes)
        self._leaves = [t for _, t in tree_flatten(self.lanes)]
        state = [t for _, t in tree_flatten(self.lanes.state)]
        before = counters()
        side = torch.cuda.Stream(device=lanes.state.z.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                iterate(self.lanes)
        torch.cuda.current_stream().wait_stream(side)
        warm = counters()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            out = iterate(self.lanes)
            torch._foreach_copy_(state, [t for _, t in tree_flatten(out.state)])
        self.counts = counters() - warm
        for name, n in (counters() - before).items():
            count(name, -n)
        count("stream.graph_captures")

    def load(self, lanes: _Lanes) -> _Lanes:
        torch._foreach_copy_(self._leaves, [t for _, t in tree_flatten(lanes)])
        return self.lanes

    def replay(self) -> _Lanes:
        self.graph.replay()
        for name, n in self.counts.items():
            count(name, n)
        return self.lanes


class StreamingSolver:
    """Continuous-throughput wrapper over one LandingSolver.

    sampler(n) -> (q (n, 6), qd (n, 6)) numpy arrays of fresh scenarios; by
    default :func:`..warmstart.reference.sample_drop_scenario` drawing from
    one ``torch.Generator`` seeded 0 (successive calls continue its stream).

    A scenario gets one attempt per entry of ``attempt_iters``; a single
    deadline records every scenario after its first attempt.

    The live step runs its iterations as replays of one captured CUDA graph
    (:class:`_IterationGraph`, one per lane shape, dtype and device) where
    the lanes are CUDA tensors and no trace or other capture is under way,
    on the structured and the dense path alike; everywhere else (the CPU, a
    loaded step, a trace) it runs them eagerly.  The counters
    ``stream.graph_captures``, ``stream.graph_replays`` and
    ``stream.eager_iterations`` say which ran.
    """

    def __init__(
        self,
        solver,
        batch: int = 64,
        segment: int = 50,
        sampler: Callable | None = None,
        attempt_iters: tuple = (100, 150),
        collect_z: bool = False,
    ):
        if sampler is None:
            from ..warmstart.reference import sample_drop_scenario

            generator = torch.Generator().manual_seed(0)

            def sampler(n):
                q, qd = sample_drop_scenario(n, generator, device="cpu")
                return q.numpy(), qd.numpy()

        self.solver = solver
        self.batch = batch
        self.segment = segment
        self.sampler = sampler
        self.attempt_iters = tuple(attempt_iters)
        n_chain = len(solver.retry_guess or ("default",))
        if len(self.attempt_iters) > 1 + n_chain:
            raise ValueError(
                f"{len(self.attempt_iters)} attempt deadlines but only {1 + n_chain} "
                f"cold-guess families (guess + retry chain {solver.retry_guess})"
            )
        self.n_attempts = len(self.attempt_iters)
        self.collect_z = collect_z
        self._step_cache: dict = {}
        self._graphs: dict = {}  # captured iterations, by the lanes' shapes
        self._init_aot = None  # the loaded pool init (load_step)

    # ------------------------------------------------------------------
    def _pool_states(self, q, qd, variant: int) -> _Lanes:
        """Initial lane data of B scenarios for one cold-guess variant."""
        if self._init_aot is not None:
            return self._init_aot(q, qd, torch.full((q.shape[0],), variant, device=q.device))
        return _Lanes.of(*self.solver.init_lanes(q, qd, variant))

    def _pool_lanes(self, pool_q, pool_qd) -> _Lanes:
        """Initial lane data of every pool scenario, leading axes (V, P_pad)."""
        B = self.batch
        per_variant = []
        for v in range(self.n_attempts):
            chunks = [self._pool_states(pool_q[c0 : c0 + B], pool_qd[c0 : c0 + B], v)
                      for c0 in range(0, pool_q.shape[0], B)]
            per_variant.append(tree_cat(chunks))
        return tree_stack(per_variant)

    def _iterate(self, lanes: _Lanes) -> _Lanes:
        """One masked IP iteration of the lanes (the saved iteration program)."""
        with span("solver.rebuild"):
            prog = self.solver.program(lanes.snlp(self.solver.problem))
        return dataclasses.replace(lanes, state=prog.step(lanes.state))

    def _graph(self, lanes: _Lanes) -> "_IterationGraph | None":
        """The captured iteration for these lanes (captured at the first
        call), or None where the iteration runs eagerly."""
        z = lanes.state.z
        if not (z.is_cuda and type(z) is torch.Tensor) \
                or _get_current_dispatch_mode() is not None or torch.compiler.is_compiling() \
                or torch.cuda.is_current_stream_capturing():
            return None
        key = tuple((name, t.shape, t.dtype) for name, t in tree_flatten(lanes)) + (z.device,)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = _IterationGraph(self._iterate, lanes)
        return graph

    def _compose(self, iterate, harvest, live: bool = False):
        """The step ``(pool, carry) -> carry``: ``segment`` masked iterations
        of the lanes, then one harvest and refill.  ``live``: ``iterate`` is
        :meth:`_iterate`, which may run as a captured graph."""

        def step(pool, carry):
            lanes = carry.lanes
            graph = self._graph(lanes) if live else None
            if graph is not None:
                lanes = graph.load(lanes)
            for _ in range(self.segment):
                with span("solver.iteration"):
                    lanes = graph.replay() if graph is not None else iterate(lanes)
            count("ip.iterations", self.segment)
            count("stream.graph_replays" if graph is not None else "stream.eager_iterations",
                  self.segment)
            with span("stream.harvest"):
                return harvest(pool, dataclasses.replace(carry, lanes=lanes))

        return step

    def get_step(self, P: int):
        """The [segment -> harvest -> refill] step of pool size P (cached):
        the loaded programs after :meth:`load_step`, else the live ones."""
        step = self._step_cache.get(P)
        if step is None:
            step = self._step_cache[P] = self._compose(
                self._iterate, lambda pool, carry: self._harvest(pool, carry, P), live=True)
        return step

    # -------------------------------------------------- saved step programs
    def artifact_key(self, P: int) -> str:
        """Hash binding a saved step to the program it holds: the solver's
        kind, robot, problem and IP configs, guess families and network,
        dtype, device type, path and theta overrides, the stream's batch,
        segment, pool size, deadlines and collect_z, and the torch version.
        A file whose key differs is refused."""
        from .._tree import to_numpy

        s = self.solver
        parts = [
            s.kind, s.robot, str(s.problem.config), str(s.config), s.guess, str(s.retry_guess),
            str(s._nn_path), str(s.dtype), s.device.type, str(s.structured),
            str({k: to_numpy(v).tolist() for k, v in sorted(s.theta_overrides.items())}),
            f"B{self.batch}", f"seg{self.segment}", f"P{P}", f"att{self.attempt_iters}",
            f"cz{self.collect_z}", torch.__version__,
        ]
        return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]

    def export_step(self, path: str, P: int) -> None:
        """Save the step of pool size P to ``path``: the pool init of B
        scenarios (the cold-guess variant a (B,) input, which picks each
        lane's family branch-free), one masked iteration, and the harvest
        and refill, traced on the solver's device (the counterpart of the
        JAX package's ``export_step``).  A kind whose parameters the saved
        step cannot carry raises ``NotImplementedError``."""
        from ..runtime.artifact import TRACE_Q, TRACE_QD, register_stream_serialization
        from ..runtime.programs import trace_program, write_programs

        register_stream_serialization(self.solver)
        B, V = self.batch, self.n_attempts
        s = self.solver
        q = torch.tensor(TRACE_Q, dtype=s.dtype, device=s.device).expand(B, 6).clone()
        qd = torch.tensor(TRACE_QD, dtype=s.dtype, device=s.device).expand(B, 6).clone()
        variant = torch.zeros(B, dtype=torch.int64, device=s.device)
        traced = [trace_program(lambda q, qd, v: _Lanes.of(*s.init_lanes(q, qd, v)),
                                (q, qd, variant))]
        lanes = _Lanes.of(*s.init_lanes(q, qd, 0))
        pool = tree_stack([tree_cat([lanes] * -(-P // B))] * V)
        carry = self._make_carry(pool, P)
        traced.append(trace_program(self._iterate, (carry.lanes,)))
        traced.append(trace_program(lambda pool, carry: self._harvest(pool, carry, P),
                                    (pool, carry)))
        header = {"key": self.artifact_key(P), "P": P, "B": B, "V": V,
                  "programs": ["init", "iterate", "harvest"],
                  "out_specs": [torch.utils._pytree.treespec_dumps(spec) for _, spec in traced]}
        write_programs(path, STEP_MAGIC, header, [gm for gm, _ in traced])

    def load_step(self, path: str, P: int) -> bool:
        """Load a step saved by :meth:`export_step` for pool size P; then
        :meth:`run` runs its programs.  Returns False where the file is not
        a saved step, its key differs or its number of attempts does; any
        other fault (a truncated or damaged file, a program that does not
        load) raises, and so does a kind whose parameters the saved step
        cannot carry (``NotImplementedError``)."""
        from ..runtime.artifact import register_stream_serialization
        from ..runtime.programs import Program, read_programs

        register_stream_serialization(self.solver)
        with open(path, "rb") as f:
            if f.readline() != STEP_MAGIC:
                return False
            header = json.loads(f.readline())
            if header["key"] != self.artifact_key(P) or header["V"] != self.n_attempts:
                return False
            modules = read_programs(f, self.solver.device)
        init, iterate, harvest = (Program(m, torch.utils._pytree.treespec_loads(spec))
                                  for m, spec in zip(modules, header["out_specs"], strict=True))
        self._init_aot = init
        self._step_cache[P] = self._compose(iterate, harvest)
        return True

    def _harvest(self, pool: _Lanes, carry: _StreamCarry, P: int) -> _StreamCarry:
        """After a segment: settle the lanes, harvest the finished ones into
        their scenario slots and refill them from the pool, all on the device."""
        B = self.batch
        V = self.n_attempts
        dev = carry.res.device
        att = torch.as_tensor(self.attempt_iters[:V] or (10**9,), device=dev)
        with span("solver.rebuild"):
            snlp = carry.lanes.snlp(self.solver.problem)
            prog = self.solver.program(snlp)
        result = prog.finish(carry.lanes.state)
        new_state = prog.settle(carry.lanes.state, result)
        conv = result.converged
        # per-attempt deadline: lanes past their budget are failed now
        deadline = att[torch.clamp(carry.lane_variant, 0, V - 1)]
        timed_out = ~new_state.done & (new_state.it >= deadline) & ~conv
        done = (new_state.done | timed_out) & carry.active
        # failed attempts re-solve in place down the retry chain
        retrying = done & ~conv & (carry.lane_variant < V - 1)
        fin = done & ~retrying
        total_iters = result.iterations + carry.lane_prev_iters

        # ---- harvest: scatter finished lanes into their scenario slots
        sid_sc = torch.where(fin, carry.lane_sid, torch.full_like(carry.lane_sid, P))
        res = carry.res.clone()
        res[0, sid_sc] = 1.0
        res[1, sid_sc] = conv.to(res.dtype)
        res[2, sid_sc] = total_iters.to(res.dtype)
        res[3, sid_sc] = result.constr_viol.to(res.dtype)
        res[4, sid_sc] = (carry.lane_variant + 1).to(res.dtype)
        res_z = carry.res_z
        if self.collect_z:
            res_z = res_z.clone()
            res_z[sid_sc] = snlp.from_scaled(result.z)

        # ---- refill finished lanes from the pool (prefix-sum ranks)
        ranks = torch.cumsum(fin.to(torch.int64), 0) - 1
        new_sid = carry.cursor + ranks
        refill = fin & (new_sid < P)
        idx = torch.clamp(torch.where(refill, new_sid, torch.zeros_like(new_sid)), 0, P - 1)
        lane_sid = torch.where(
            refill, new_sid, torch.where(fin, torch.full_like(new_sid, P), carry.lane_sid)
        )
        next_variant = torch.clamp(carry.lane_variant + 1, 0, V - 1)
        zero = torch.zeros_like(carry.lane_variant)
        lane_variant = torch.where(
            refill, zero, torch.where(retrying, next_variant, carry.lane_variant)
        )
        lane_prev_iters = torch.where(
            refill, zero, torch.where(retrying, total_iters, carry.lane_prev_iters)
        )

        # fresh lane data for refilled lanes (variant 0 of their new
        # scenario) and retrying lanes (next variant of their scenario),
        # gathered from the precomputed pool
        reinit = refill | retrying
        retry_sid = torch.clamp(carry.lane_sid, 0, P - 1)

        def pick(leaf):
            r = retrying.reshape((B,) + (1,) * (leaf.dim() - 2))
            return torch.where(r, leaf[next_variant, retry_sid], leaf[0, idx])

        fresh = tree_map(pick, pool)
        lanes = tree_where(reinit, fresh, dataclasses.replace(carry.lanes, state=new_state))
        return _StreamCarry(
            lane_sid=lane_sid,
            lane_variant=lane_variant,
            lane_prev_iters=lane_prev_iters,
            lanes=lanes,
            cursor=torch.clamp(carry.cursor + fin.sum(), max=P),
            active=(carry.active & ~fin) | refill,
            res=res,
            res_z=res_z,
        )

    def _make_carry(self, pool: _Lanes, P: int) -> _StreamCarry:
        B = self.batch
        dev = pool.state.z.device
        ar = torch.arange(B, device=dev)
        first = torch.clamp(ar, max=P - 1)
        active0 = ar < P
        v0 = torch.zeros(B, dtype=torch.int64, device=dev)
        n_vars = self.solver.problem.n_vars if self.collect_z else 0
        return _StreamCarry(
            lane_sid=torch.where(active0, ar, torch.full_like(ar, P)),
            lane_variant=v0,
            lane_prev_iters=v0,
            lanes=tree_map(lambda leaf: leaf[0, first], pool),
            cursor=torch.tensor(min(B, P), device=dev),
            active=active0,
            res=torch.zeros((5, P + 1), dtype=self.solver.dtype, device=dev),
            res_z=torch.zeros((P + 1, n_vars), dtype=self.solver.dtype, device=dev),
        )

    # ------------------------------------------------------------------
    def run(self, n_scenarios: int, max_wall_s: float | None = None,
            progress_cb: Callable | None = None):
        """Solve n_scenarios scenarios; returns a stats dict.

        The pool is sampled and its lane data precomputed up front (set-up,
        outside ``wall_s``); lanes are refilled until the pool drains, then
        the remaining lanes drain.  ``progress_cb(stats)``, if given, is
        called after every segment, the last one included, with the
        cumulative stats so far (the JAX package reads them one segment
        behind the device; here the one host read per segment serves both,
        and the sequence of calls is the same)."""
        B = self.batch
        P = int(n_scenarios)
        with span("stream.pool"):
            q_np, qd_np = self.sampler(P)
            solver = self.solver
            pool_q = torch.as_tensor(np.asarray(q_np), dtype=solver.dtype, device=solver.device)
            pool_qd = torch.as_tensor(np.asarray(qd_np), dtype=solver.dtype, device=solver.device)
            ics = np.concatenate([np.asarray(q_np), np.asarray(qd_np)], axis=1)

            pad = -P % B
            q_pad = torch.cat([pool_q, pool_q[-1:].expand(pad, 6)]) if pad else pool_q
            qd_pad = torch.cat([pool_qd, pool_qd[-1:].expand(pad, 6)]) if pad else pool_qd
            pool = self._pool_lanes(q_pad, qd_pad)
            carry = self._make_carry(pool, P)

        step = self.get_step(P)
        t0 = time.time()
        while True:
            with span("stream.segment"):
                carry = step(pool, carry)
            with span("stream.read"):
                # the one host read per segment, which brings the device
                # counters along
                reads = start_device_reads()
                res_np = carry.res.cpu().numpy()
                finish_device_reads(reads)
            if progress_cb is not None:
                with span("stream.callback"):
                    progress_cb(self._stats(res_np, ics, P, B, t0))
            if res_np[0, :P].sum() >= P:
                break
            if max_wall_s is not None and time.time() - t0 > max_wall_s:
                break
        out = self._stats(res_np, ics, P, B, t0)
        count("stream.finished", out["n_finished"])
        count("stream.retried", out["n_retried"])
        if self.collect_z:
            out["z"] = carry.res_z.cpu().numpy()[:P][res_np[0, :P] > 0.5]
        return out

    @staticmethod
    def _stats(res_np, ics, P, B, t0):
        wall = time.time() - t0
        fin = res_np[0, :P] > 0.5
        conv = res_np[1, :P][fin] > 0.5
        its = res_np[2, :P][fin]
        return {
            "wall_s": wall,
            "n_started": int(min(P, fin.sum() + B)),
            "n_finished": int(fin.sum()),
            "n_converged": int(conv.sum()),
            "n_retried": int((res_np[4, :P][fin] > 1.5).sum()),
            "convergence_rate": float(conv.mean()) if conv.size else 0.0,
            "converged_per_sec": float(conv.sum() / wall),
            "iters_p50": float(np.percentile(its, 50)) if its.size else -1.0,
            "iters_p90": float(np.percentile(its, 90)) if its.size else -1.0,
            "ics": ics[fin],
            "converged_mask": conv,
            "viol": res_np[3, :P][fin],
        }
