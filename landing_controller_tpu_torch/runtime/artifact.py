"""Saved solvers, the saved stream step's types, and the kernels' build cache.

The counterpart of the JAX package's ``runtime/artifact.py``.  There, a
saved solve is a ``jax.export`` blob of the whole jitted solve, which a
fresh process runs without the problem's Python code (the reference's
``.casadi`` file, generate_landingCtrller_IPOPT_warmstart.m:278-366).

The port's solve has a host loop that the graph cannot hold: every
``_SYNC_EVERY`` iterations it reads whether any lane still runs
(``solver/ip.py``).  So a saved solver (:func:`save_solver`) holds three
programs over flat tensors, and :func:`load_solver` runs the same loop
around them:

- ``init(q, qd)``: the scaled problem's tensors and a fresh IPState
  (``LandingSolver.start``);
- ``iterate(lanes)``: one masked IP iteration (``IPProgram.step``);
- ``finish(lanes)``: the fields of :class:`..solution.LandingSolution`.

Each program is traced by :func:`.programs.trace_program` (``make_fx``
lowers the ``torch.func`` transforms to plain aten ops) and saved as its
graph and constants (:mod:`.programs`).  The graph holds the kernels as the
custom ops ``landing_controller_tpu_torch::qd_inverse`` and
``::chol_inverse`` (:mod:`..ops.pallas_blocks`, which this module imports
so that a loading process has them registered): on the card the loaded
program launches the hand-written kernel, on the CPU the plain version.
The programs are device-specific, as JAX's blob is platform-specific: save
on the card to run on the card.  Loading imports neither the problems, the
solver nor :mod:`..api`.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch
from torch.utils import _pytree

from .._device import resolve_device
from ..ops import _build
from ..ops import pallas_blocks  # noqa: F401  (registers the kernels' custom ops)
from ..solution import LandingSolution
from ..tracing import count
from .programs import read_programs, trace_program, write_programs

MAGIC = b"LCTORCH1\n"
# the drop a solver is traced at: the programs hold no branch on values, so
# any finite scenario gives the same graph
TRACE_Q = (0.0, 0.0, 0.5, 0.0, 0.0, 0.0)
TRACE_QD = (0.0, 0.0, 0.0, 0.0, 0.0, -1.0)


def enable_persistent_cache(cache_dir: str | None = None) -> str:
    """Point the kernels' build directory at ``cache_dir``, else at
    ``$LANDING_CTRL_CACHE`` (the variable the JAX package reads), else at
    ``<repo>/build/kernels``; idempotent; returns the directory.

    The port's one compile step is ``nvcc`` of ``csrc/*.cu`` (the libraries
    are named by a hash of their sources, :mod:`..ops._build`), so that is
    what persists between processes; PyTorch runs the solve eagerly and
    has no compiled graph to cache.  Unlike the JAX function it seeds
    nothing from ``bench_cache/``: those files are TPU XLA executables,
    which the port cannot use."""
    if cache_dir is None:
        cache_dir = os.environ.get("LANDING_CTRL_CACHE", _build.DEFAULT_BUILD_DIR)
    _build.BUILD_DIR = os.path.abspath(cache_dir)
    return _build.BUILD_DIR


def register_stream_serialization(solver=None) -> None:
    """Register the dataclasses that cross the saved stream step's program
    boundary (``StreamingSolver.export_step``) as pytree nodes with
    serialized names, so that their flatten and unflatten specs can be
    written to the step's file and read back; idempotent.  The step's format
    carries the landing kinds' parameters (``LandingParams``): given a
    ``solver`` of another ``params_type`` (the eeparam kind's), it raises
    ``NotImplementedError``."""
    from ..parallel.stream import _Lanes, _StreamCarry
    from ..problems.landing import LandingParams
    from ..solver.ip import IPState

    if solver is not None and solver.params_type is not LandingParams:
        raise NotImplementedError(
            f"a saved stream step of kind {solver.kind!r} ({solver.params_type.__name__}) is not "
            "implemented; its stream runs the live step")
    for cls in (IPState, LandingParams, _Lanes, _StreamCarry):
        if cls not in _pytree.SUPPORTED_NODES:
            torch.export.register_dataclass(
                cls, serialized_type_name=f"landing_controller_tpu_torch.{cls.__name__}")


def _values(pairs) -> tuple:
    return tuple(t for _, t in pairs)


def save_solver(solver, path: str, batch: int | None = None) -> None:
    """Save ``solver``'s solve for fixed shapes to ``path``: ``batch=None``
    the single-scenario solve ``(q (6,), qd (6,))``, ``batch=B`` the solve
    of ``(B, 6)`` inputs.  The programs run on the solver's device and in
    its dtype."""
    from .._tree import tree_flatten, tree_unflatten
    from ..solver.ip import _SYNC_EVERY

    B = 1 if batch is None else batch
    q = torch.tensor(TRACE_Q, dtype=solver.dtype, device=solver.device).expand(B, 6).clone()
    qd = torch.tensor(TRACE_QD, dtype=solver.dtype, device=solver.device).expand(B, 6).clone()
    snlp0, state0 = solver.start(q, qd)
    scaled, state = tree_flatten(snlp0), tree_flatten(state0)
    lanes = _values(scaled + state)
    n_scaled = len(scaled)

    def batched(x):
        return x if batch is not None else x[None]

    def init(q, qd):
        snlp, st = solver.start(batched(q), batched(qd))
        return _values(tree_flatten(snlp) + tree_flatten(st))

    def unflatten(leaves):
        return tree_unflatten(snlp0, leaves[:n_scaled]), tree_unflatten(state0, leaves[n_scaled:])

    def iterate(*leaves):
        snlp, st = unflatten(leaves)
        return _values(tree_flatten(solver.program(snlp).step(st)))

    def finish(*leaves):
        sol = solver.finish(*unflatten(leaves))
        return tuple(t if batch is not None else t[0]
                     for t in (getattr(sol, f.name) for f in dataclasses.fields(sol)))

    example = (q, qd) if batch is not None else (q[0], qd[0])
    modules = [trace_program(fn, args)[0]
               for fn, args in ((init, example), (iterate, lanes), (finish, lanes))]
    header = {
        "programs": ["init", "iterate", "finish"],
        "lanes": [name for name, _ in scaled] + [f"state.{name}" for name, _ in state],
        "n_scaled": n_scaled,
        "solution": [f.name for f in dataclasses.fields(LandingSolution)],
        "max_iter": solver.config.max_iter,
        "sync_every": _SYNC_EVERY,
        "batch": batch,
        "dtype": str(solver.dtype).removeprefix("torch."),
        "device": solver.device.type,
        "torch": torch.__version__,
    }
    write_programs(path, MAGIC, header, modules)


def load_solver(path: str, device="cuda"):
    """Load a saved solver: returns ``fn(q, qd) -> LandingSolution``, which
    runs the iterations that ``LandingSolver.solve`` / ``solve_batch`` runs.
    ``device`` must be the one the solver was saved on (the card unless the
    caller asks for the CPU).  ``fn.header`` is the file's header and
    ``fn.programs`` the loaded (init, iterate, finish) over flat tensors."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path} is not a saved landing solver")
        header = json.loads(f.readline())
        if header["device"] != device.type:
            raise ValueError(f"{path} was saved on {header['device']}, asked to run on "
                             f"{device.type}: save it on the device that runs it")
        init, iterate, finish = read_programs(f, device)
    dtype = getattr(torch, header["dtype"])
    n_scaled, max_iter, sync = header["n_scaled"], header["max_iter"], header["sync_every"]
    state_names = header["lanes"][n_scaled:]
    i_it, i_done = state_names.index("state.it"), state_names.index("state.done")

    def solve(q, qd) -> LandingSolution:
        q = torch.as_tensor(q, dtype=dtype, device=device)
        qd = torch.as_tensor(qd, dtype=dtype, device=device)
        lanes = init(q, qd)
        scaled, state = lanes[:n_scaled], lanes[n_scaled:]
        # the loop of solver.ip.solve: a host read every `sync` iterations
        taken = 0
        while taken < max_iter:
            n = min(sync, max_iter - taken)
            for _ in range(n):
                state = iterate(*scaled, *state)
            count("ip.iterations", n)
            taken += sync
            if not bool(((state[i_it] < max_iter) & ~state[i_done]).any()):
                break
        return LandingSolution(*finish(*scaled, *state))

    solve.header = header
    solve.programs = (init, iterate, finish)
    return solve
