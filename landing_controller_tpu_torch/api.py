"""High-level solve API: problem transcription + scaling + IP solver.

Example::

    solver = LandingSolver()                        # kinodynamic, on the GPU
    sol = solver.solve(q_init, qd_init)             # one scenario
    sols = solver.solve_batch(q_inits, qd_inits)    # (B, 6) batch

``LandingSolver(kind)`` solves ``kinodynamic`` (the production problem, the
default), ``kinodynamic_voltage``, ``srbm_lcp``, ``sliding``, ``ccc`` and
``contact_scheduled``: on the stage-structured path (``kkt_backend`` "cri",
the port's default, "cr" or "scan"), or with ``structured=False`` on the dense
KKT path, which ``kinodynamic_voltage`` always takes; and ``eeparam``, the
free-contact-timing NLP of :mod:`.problems.eeparam` (spline coefficients and
phase durations, not knot states), always on the dense path, from the same
drops (q, qd) as the landing kinds.  :class:`EEParamSolver` is the eeParam
solve taking its parameters directly.

The solver runs on the card unless constructed with ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable

import numpy as np
import torch

from ._device import resolve_device
from ._tree import tree_map
from .models import get_robot_params
from .dynamics.legs import leg_torques
from .problems.eeparam import (
    EEParamConfig,
    EEParamParams,
    default_eeparam_params,
    eeparam_params_from_drops,
    eeparam_problem,
)
from .problems.landing import (
    LandingParams,
    ccc_problem,
    contact_scheduled_problem,
    kinodynamic_problem,
    kinodynamic_voltage_problem,
    sliding_problem,
    srbm_lcp_problem,
)
from .solution import LandingSolution
from .solver.ip import IPConfig, IPProgram, IPState, init_state, ip_program, solve
from .solver.scaling import ScaledNLP, landing_z_scale, scale_problem
from .solver.structured import make_structured_newton_step
from .warmstart.reference import (
    ballistic_guess,
    ccc_params,
    contact_scheduled_params,
    initial_guess_from_reference,
    kinodynamic_params,
    srbm_lcp_params,
)

# the committed warm-start network, the port's own copy of the JAX package's
DEFAULT_NN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                               "nn_TO_landing.npz")


# the JAX structured step's forcing variants select TPU or interpret paths,
# which the port does not have
_NOT_PORTED_BACKENDS = ("cri_pallas", "cri_ref", "cri_pallas_interpret")


def _landing_ip_config(dtype, structured, dense_delta_c=1e-8) -> IPConfig:
    """The JAX package's defaults, except the structured backend: the port's
    default is "cri", the path of the hand-written kernel (the JAX default
    config leaves IPConfig's "scan")."""
    f32 = dtype == torch.float32
    return IPConfig(
        max_iter=250,
        hessian_mode="hybrid",
        mu_min=1e-5 if f32 else 1e-6,
        sigma_max=1e5 if f32 else 1e8,
        tol=2e-4 if f32 else 1e-4,
        relax_scale=1.0,
        delta_c=1e-6 if structured else dense_delta_c,
        refine_steps=(3 if structured else 2) if f32 else 1,
        kkt_backend="cri",
    )


def _eeparam_ip_config(dtype, structured=False) -> IPConfig:
    """The eeParam solve's settings (the JAX package's): no complementarity
    rows, GN curvature, a 2-candidate ladder, 7 refinement sweeps in f32 (its
    batched f32 path plateaus at kkt ~3e-3 on some lanes with 3-5)."""
    f32 = dtype == torch.float32
    return IPConfig(
        max_iter=200,
        hessian_mode="gn",
        relax_scale=0.0,
        delta_c=1e-6,
        mu_min=1e-5 if f32 else 1e-6,
        tol=2e-4 if f32 else 1e-4,
        sigma_max=1e5 if f32 else 1e8,
        ladder_scales=(0.0, 1.0),
        refine_steps=7 if f32 else 1,
    )


def _landing_problem(problem_fn):
    def make(robot, robot_params, n_knots, problem_config):
        if problem_config is not None:
            raise ValueError("problem_config is the eeparam kind's; the landing kinds take n_knots")
        return problem_fn(robot_params, n_knots=n_knots), n_knots
    return make


def _eeparam_problem(robot, robot_params, n_knots, problem_config):
    if robot != "mc3D":
        raise ValueError(f"kind 'eeparam' takes the mc3D constants of its reference, not {robot!r}")
    prob = eeparam_problem(problem_config)
    n_colloc = prob.config.n_colloc
    if n_knots != n_colloc:
        raise ValueError(f"kind 'eeparam' has {n_colloc} collocation times; n_knots={n_knots}")
    return prob, n_colloc


def _landing_params(params_fn):
    return lambda prob, q, qd, n_knots, robot: params_fn(q, qd, n_knots=n_knots, robot=robot)


def _nn_guess(solver, prob, theta):
    from .warmstart.nn import nn_warmstart_guess

    mlp, stats = solver._nn
    return nn_warmstart_guess(mlp, stats, theta.q_init, theta.qd_init, prob)


# guess name -> (its family (solver, problem, theta) -> z0 (B, n), the
# default retry family's name)
_LANDING_GUESSES = {
    "reference": (lambda solver, prob, th: initial_guess_from_reference(prob, th), "ballistic"),
    "ballistic": (lambda solver, prob, th: ballistic_guess(prob, th), "reference"),
    "nn": (_nn_guess, "ballistic"),
}


def _landing_solution(solver, snlp: ScaledNLP, res) -> LandingSolution:
    prob = solver.problem
    z = snlp.from_scaled(res.z)
    v = prob.unpack(z)
    lam_u, y_u = snlp.duals_from_scaled(res.lam, res.y)
    if prob.config.kinodynamic:
        tau = leg_torques(solver.robot_params, v.jpos, v.X[:, :-1, 3:6], v.U[..., 12:])
    else:
        tau = z.new_zeros(v.U.shape[:-1] + (12,))
    return LandingSolution(
        X=v.X, jpos=v.jpos, U=v.U, tau=tau, z=z,
        converged=res.converged, iterations=res.iterations, kkt_error=res.kkt_error,
        constr_viol=res.constr_viol, cost=res.cost,
        s=snlp.slacks_from_scaled(res.s), lam=lam_u, y=y_u,
    )


def _eeparam_solution(solver, snlp: ScaledNLP, res) -> EEParamSolution:
    z = snlp.from_scaled(res.z)
    return EEParamSolution(v=solver.problem.unpack(z), z=z, converged=res.converged,
                           iterations=res.iterations, kkt_error=res.kkt_error,
                           constr_viol=res.constr_viol, cost=res.cost)


@dataclasses.dataclass(frozen=True)
class _Kind:
    """What :class:`LandingSolver` looks up for a problem kind."""

    # (robot, robot_params, n_knots, problem_config) -> (problem, n_knots)
    problem: Callable
    # (problem, q (B, 6), qd (B, 6), n_knots, robot) -> parameters of B lanes
    params: Callable
    params_type: type
    guesses: dict  # as _LANDING_GUESSES
    ip_config: Callable  # (dtype, structured) -> the default IPConfig
    solution: Callable  # (solver, snlp, IP result) -> the solution
    z_scale: Callable = landing_z_scale  # problem -> (n,) variable scales
    dense: bool = False  # no knot-stage structure: the dense KKT path only
    fixed: tuple = ()  # parameters that the problem's grid fixes: no theta_overrides


def _landing_kind(problem_fn, params_fn, **kw) -> _Kind:
    kw.setdefault("ip_config", _landing_ip_config)
    return _Kind(problem=_landing_problem(problem_fn), params=_landing_params(params_fn),
                 params_type=LandingParams, guesses=_LANDING_GUESSES, solution=_landing_solution,
                 **kw)


_KINDS = {
    "kinodynamic": _landing_kind(kinodynamic_problem, kinodynamic_params),
    # voltage rows couple adjacent knots' jpos
    "kinodynamic_voltage": _landing_kind(kinodynamic_voltage_problem, kinodynamic_params,
                                         dense=True),
    "srbm_lcp": _landing_kind(srbm_lcp_problem, srbm_lcp_params),
    "ccc": _landing_kind(ccc_problem, ccc_params),
    "contact_scheduled": _landing_kind(
        contact_scheduled_problem, contact_scheduled_params,
        ip_config=functools.partial(_landing_ip_config, dense_delta_c=1e-6)),
    "sliding": _landing_kind(sliding_problem, srbm_lcp_params),
    # spline coefficients and phase durations, which span the horizon; the
    # cold guess is the problem's own (the network predicts knot
    # trajectories); the static horizon fixes the grid (check_params)
    "eeparam": _Kind(
        problem=_eeparam_problem,
        params=lambda prob, q, qd, n_knots, robot: eeparam_params_from_drops(
            q, qd, prob.config.horizon),
        params_type=EEParamParams,
        guesses={"reference": (lambda solver, prob, th: prob.initial_guess(th), "reference")},
        ip_config=_eeparam_ip_config, solution=_eeparam_solution,
        z_scale=lambda prob: np.ones(prob.n_vars), dense=True, fixed=("horizon",)),
}


class LandingSolver:
    """Landing trajectory optimizer for one problem family.

    ``kind="eeparam"``: ``n_knots`` must be the problem's number of
    collocation times (10 at the published settings), ``problem_config`` an
    :class:`.problems.eeparam.EEParamConfig` (default: the published
    settings, whose horizon ``theta_overrides`` may not change), every guess
    "reference" (the problem's own initial guess), and :meth:`finish` gives
    an :class:`EEParamSolution`."""

    def __init__(
        self,
        kind: str = "kinodynamic",
        n_knots: int = 21,
        robot: str = "mc3D",
        config: IPConfig | None = None,
        dtype=torch.float32,
        theta_overrides: dict | None = None,
        structured: bool = True,
        guess: str = "reference",
        retry_guess=None,
        device="cuda",
        nn_path: str | None = None,
        problem_config: EEParamConfig | None = None,
    ):
        if kind not in _KINDS:
            raise KeyError(f"unknown problem kind '{kind}'; available: {sorted(_KINDS)}")
        self._kind = _KINDS[kind]
        # retry_guess: the alternate cold-guess family chain that the
        # streaming solver's per-lane variant selects (variant k uses chain[k-1])
        if isinstance(retry_guess, str):
            retry_chain = tuple(retry_guess.split(","))
        else:
            retry_chain = tuple(retry_guess or ())
        for g in (guess,) + retry_chain:
            if g not in ("reference", "ballistic", "nn"):
                raise KeyError(f"unknown guess '{g}' (reference | ballistic | nn)")
            if g not in self._kind.guesses:
                raise ValueError(f"guess '{g}' for kind '{kind}', which takes {sorted(self._kind.guesses)}")
        fixed = sorted(set(theta_overrides or {}) & set(self._kind.fixed))
        if fixed:
            raise ValueError(f"kind '{kind}' fixes {fixed} in its problem's grid: set them through "
                             "problem_config, not theta_overrides")
        self.device = resolve_device(device)
        # full f32 matmuls: the counterpart of the JAX solver's
        # matmul_precision="highest"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.kind = kind
        self.robot = robot
        self.guess = guess
        self.retry_guess = retry_chain or None
        self.dtype = dtype
        self.theta_overrides = dict(theta_overrides or {})
        self.structured = structured and not self._kind.dense
        self.params_type = self._kind.params_type
        self.robot_params = get_robot_params(robot)
        self._problem_config = problem_config
        self.problem, self.n_knots = self._kind.problem(robot, self.robot_params, n_knots,
                                                        problem_config)
        if config is None:
            config = self._kind.ip_config(dtype, self.structured)
        if self.structured and config.kkt_backend in _NOT_PORTED_BACKENDS:
            raise NotImplementedError(
                f"kkt_backend={config.kkt_backend!r} forces a TPU or interpret path of the JAX "
                "package; the port has 'cri', 'cr' and 'scan'"
            )
        self.config = config
        self._z_scale = torch.as_tensor(self._kind.z_scale(self.problem), dtype=dtype,
                                        device=self.device)
        self._relax_mask = torch.as_tensor(self.problem.relax_mask(), dtype=dtype,
                                           device=self.device)
        self._nn = None
        self._nn_path = nn_path
        if guess == "nn" or "nn" in retry_chain:
            from .warmstart.nn import N_KNOTS, load_warmstart

            if self.n_knots != N_KNOTS:
                raise ValueError(
                    f"nn guess predicts the production N={N_KNOTS} grid, got n_knots={self.n_knots}"
                )
            self._nn = load_warmstart(nn_path or DEFAULT_NN_PATH, dtype=dtype, device=self.device)

    # ------------------------------------------------------------ params
    def _as_batch(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def build_params(self, q_init, qd_init):
        """(B, 6) scenarios -> the kind's parameters (``params_type``) of B
        lanes."""
        theta = self._kind.params(self.problem, self._as_batch(q_init), self._as_batch(qd_init),
                                  self.n_knots, self.robot)
        if self.theta_overrides:
            theta = dataclasses.replace(theta, **{
                k: self._as_batch(v).expand_as(getattr(theta, k)).clone()
                for k, v in self.theta_overrides.items()
            })
        return theta

    def _cold_guess(self, theta, variant=None):
        """Cold-start z0 (B, n).  ``variant``: None or 0 selects the
        configured guess, k >= 1 the k-th retry family; an int applies to
        every lane, a (B,) tensor selects per lane (all families computed,
        picked branch-free)."""
        prob, guesses = self.problem, self._kind.guesses
        names = (self.guess,) + (self.retry_guess or (guesses[self.guess][1],))

        def family(name):
            return guesses[name][0](self, prob, theta)

        if variant is None or isinstance(variant, int):
            return family(names[variant or 0])
        out = family(names[0])
        for i, name in enumerate(names[1:]):
            out = torch.where((variant == i + 1)[:, None], family(name), out)
        return out

    def scaled_problem(self, theta, z0) -> ScaledNLP:
        return scale_problem(self.problem, theta, z0, z_scale=self._z_scale)

    def _newton_step(self, theta, snlp):
        """The structured step, or None for the solver's dense default."""
        if not self.structured:
            return None
        return make_structured_newton_step(self.problem, theta, self.config, snlp)

    # ------------------------------------------------------------ solves
    def program(self, snlp: ScaledNLP) -> IPProgram:
        """The interior-point program (init, one iteration, final
        diagnostics) of the lanes of ``snlp``."""
        return ip_program(snlp.cost, snlp.eq, snlp.ineq, self.config,
                          relax_mask=self._relax_mask,
                          newton_step_fn=self._newton_step(snlp.theta, snlp))

    def start(self, q_init, qd_init, z0=None, warm=None) -> tuple:
        """The scaled problem and fresh IPState of B scenarios, as a full
        solve starts them.  z0: optional primal warm start (B, n); warm:
        optional unscaled (s, lam, y)."""
        return self._start(self.build_params(q_init, qd_init), z0, warm)

    def _start(self, theta, z0=None, warm=None) -> tuple:
        z0 = self._cold_guess(theta) if z0 is None else self._as_batch(z0)
        snlp = self.scaled_problem(theta, z0)
        s0 = lam0 = y0 = None
        if warm is not None:
            s_u, lam_u, y_u = (self._as_batch(w) for w in warm)
            s0 = torch.clamp(snlp.slacks_to_scaled(s_u), min=1e-12)
            lam0, y0 = snlp.duals_to_scaled(lam_u, y_u)
            lam0 = torch.clamp(lam0, min=1e-10)
        return snlp, init_state(snlp.cost, snlp.eq, snlp.ineq, snlp.to_scaled(z0), self.config,
                                y0, lam0, s0)

    def finish(self, snlp: ScaledNLP, state: IPState) -> LandingSolution:
        """The LandingSolution (eeparam: EEParamSolution) of the lanes at
        ``state``."""
        return self._solution(snlp, self.program(snlp).finish(state))

    def _solution(self, snlp: ScaledNLP, res) -> LandingSolution:
        return self._kind.solution(self, snlp, res)

    def _solve_impl(self, q_init, qd_init, z0=None, warm=None) -> LandingSolution:
        """Solve B scenarios (see :meth:`start` for z0 and warm)."""
        return self._solve_theta(self.build_params(q_init, qd_init), z0, warm)

    def _solve_theta(self, theta, z0=None, warm=None) -> LandingSolution:
        """Solve the B lanes of the parameters ``theta``."""
        snlp, state = self._start(theta, z0, warm)
        res = solve(snlp.cost, snlp.eq, snlp.ineq, state.z, self.config, state0=state,
                    relax_mask=self._relax_mask,
                    newton_step_fn=self._newton_step(snlp.theta, snlp))
        return self._solution(snlp, res)

    def init_lanes(self, q_init, qd_init, variant=None):
        """(ScaledNLP, fresh IPState) of B scenarios, without stepping."""
        theta = self.build_params(q_init, qd_init)
        z0 = self._cold_guess(theta, variant)
        snlp = self.scaled_problem(theta, z0)
        _, state = self._segment_impl(None, None, None, 0, snlp=snlp, z0=z0)
        return snlp, state

    def _segment_impl(self, q_init, qd_init, state, segment_iters: int, variant=None,
                      snlp: ScaledNLP | None = None, z0=None):
        """Run at most ``segment_iters`` further IP iterations of B lanes
        from a carried IPState (``state=None`` initializes).  The scaled
        problem is rebuilt from the scenarios' cold guesses unless the
        caller passes the ``snlp`` it was initialized with."""
        if snlp is None:
            theta = self.build_params(q_init, qd_init)
            z0 = self._cold_guess(theta, variant)
            snlp = self.scaled_problem(theta, z0)
        zs0 = state.z if z0 is None else snlp.to_scaled(z0)
        step_fn = self._newton_step(snlp.theta, snlp)
        res, new_state = solve(
            snlp.cost, snlp.eq, snlp.ineq, zs0, self.config,
            relax_mask=self._relax_mask, newton_step_fn=step_fn,
            state0=state, segment_iters=segment_iters, return_state=True,
        )
        summary = {
            "z": snlp.from_scaled(res.z),
            "converged": res.converged,
            "done": new_state.done,
            "iterations": res.iterations,
            "kkt_error": res.kkt_error,
            "constr_viol": res.constr_viol,
            "cost": res.cost,
        }
        return summary, new_state

    def init_state(self, q_init, qd_init, variant=None):
        """Fresh IPState for (B, 6) scenarios without stepping."""
        return self.init_lanes(q_init, qd_init, variant)[1]

    def warm_variant(self, mu_init: float = 1e-2, **cfg_overrides) -> "LandingSolver":
        """A clone of this solver tuned for primal warm starts: a
        near-feasible z0 does not need the full cold barrier path, so the
        clone restarts at a reduced ``mu_init``."""
        cfg = dataclasses.replace(self.config, mu_init=mu_init, **cfg_overrides)
        return LandingSolver(
            self.kind,
            n_knots=self.n_knots,
            robot=self.robot,
            config=cfg,
            dtype=self.dtype,
            theta_overrides=self.theta_overrides,
            structured=self.structured,
            guess=self.guess,
            retry_guess=self.retry_guess,
            device=self.device,
            nn_path=self._nn_path,
            problem_config=self._problem_config,
        )

    def solve(self, q_init, qd_init, z0=None, warm=None) -> LandingSolution:
        """Solve one scenario: q_init, qd_init (6,).  warm: unscaled
        (s, lam, y) or a previous LandingSolution."""
        if isinstance(warm, LandingSolution):
            warm = (warm.s, warm.lam, warm.y)
        lift = lambda x: None if x is None else self._as_batch(x)[None]  # noqa: E731
        warm = None if warm is None else tuple(lift(w) for w in warm)
        sol = self._solve_impl(lift(q_init), lift(qd_init), lift(z0), warm)
        return tree_map(lambda t: t[0], sol)

    def solve_batch(self, q_inits, qd_inits) -> LandingSolution:
        """Solve a (B, 6) batch of scenarios (leading axis = scenario)."""
        return self._solve_impl(q_inits, qd_inits)


@dataclasses.dataclass(frozen=True)
class EEParamSolution:
    v: object  # EEParamVars (base polynomials, durations, force/posn splines)
    z: torch.Tensor
    converged: torch.Tensor
    iterations: torch.Tensor
    kkt_error: torch.Tensor
    constr_viol: torch.Tensor
    cost: torch.Tensor


class EEParamSolver:
    """Solver for the phase-based free-contact-timing NLP
    (problems/eeparam.py; the reference's quadruped_SRBM_eeParam.m:26-409)
    from its parameters: ``LandingSolver("eeparam")`` (the dense KKT path),
    which takes drops::

        s = EEParamSolver()                      # f32, on the GPU
        sol = s.solve(s.build_params())          # the default drop
        sols = s.solve_batch(thetas)             # EEParamParams of B lanes
    """

    def __init__(self, config=None, ip_config: IPConfig | None = None, dtype=torch.float32,
                 device="cuda"):
        config = config or EEParamConfig()
        self._solver = LandingSolver("eeparam", n_knots=config.n_colloc, config=ip_config, dtype=dtype,
                                     device=device, problem_config=config)
        self.device = self._solver.device
        self.problem = self._solver.problem
        self.dtype = dtype
        self.config = self._solver.config

    def build_params(self, r_init=None, rdot_init=None, theta_init=None, thetadot_init=None):
        """EEParamParams for drop scenarios (defaults: the reference's values,
        quadruped_SRBM_eeParam.m:412-447).  Each given value is (3,) or
        (B, 3); the result has a leading batch of 1 or B."""
        over = {k: torch.as_tensor(v, dtype=self.dtype, device=self.device)
                for k, v in {"r_init": r_init, "rdot_init": rdot_init, "theta_init": theta_init,
                             "thetadot_init": thetadot_init}.items() if v is not None}
        B = max([1] + [v.shape[0] for v in over.values() if v.dim() == 2])
        theta = default_eeparam_params(self.dtype, self.device, batch=B)
        return dataclasses.replace(theta, **{k: v.expand(B, 3).clone() for k, v in over.items()})

    def _solve_impl(self, theta) -> EEParamSolution:
        return self._solver._solve_theta(tree_map(lambda t: t.to(dtype=self.dtype, device=self.device),
                                                  theta))

    def solve(self, theta) -> EEParamSolution:
        """Solve one scenario: EEParamParams of one lane (as build_params
        gives it); the solution has no batch dimension."""
        if theta.r_init.dim() == 1:
            theta = tree_map(lambda t: t[None], theta)
        if theta.batch != 1:
            raise ValueError(f"solve takes one scenario, got {theta.batch}; use solve_batch")
        self.problem.check_params(theta)
        return tree_map(lambda t: t[0], self._solve_impl(theta))

    def solve_batch(self, thetas) -> EEParamSolution:
        """Solve B scenarios (EEParamParams with a leading batch axis on every
        field); the half-static horizon is checked on every lane, since a
        lane whose theta.horizon differs from the static config would be
        solved on the wrong time grid."""
        self.problem.check_params(thetas)
        return self._solve_impl(thetas)
