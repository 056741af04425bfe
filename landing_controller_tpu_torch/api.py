"""High-level solve API: problem transcription + scaling + IP solver.

Example::

    solver = LandingSolver()                        # kinodynamic, on the GPU
    sol = solver.solve(q_init, qd_init)             # one scenario
    sols = solver.solve_batch(q_inits, qd_inits)    # (B, 6) batch

``LandingSolver(kind)`` solves ``kinodynamic`` (the production problem, the
default), ``kinodynamic_voltage``, ``srbm_lcp``, ``sliding``, ``ccc`` and
``contact_scheduled``: on the stage-structured path (``kkt_backend`` "cri",
the port's default, "cr" or "scan"), or with ``structured=False`` on the dense
KKT path, which ``kinodynamic_voltage`` always takes.  :class:`EEParamSolver`
solves the free-contact-timing NLP of :mod:`.problems.eeparam` on the dense
path.

The solver runs on the card unless constructed with ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ._device import resolve_device
from ._tree import tree_map
from .models import get_robot_params
from .dynamics.legs import leg_torques
from .problems.eeparam import default_eeparam_params, eeparam_problem
from .problems.landing import (
    LandingProblem,
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


_PROBLEMS = {
    "kinodynamic": (kinodynamic_problem, kinodynamic_params),
    "kinodynamic_voltage": (kinodynamic_voltage_problem, kinodynamic_params),
    "srbm_lcp": (srbm_lcp_problem, srbm_lcp_params),
    "ccc": (ccc_problem, ccc_params),
    "contact_scheduled": (contact_scheduled_problem, contact_scheduled_params),
    "sliding": (sliding_problem, srbm_lcp_params),
}
# the JAX structured step's forcing variants select TPU or interpret paths,
# which the port does not have
_NOT_PORTED_BACKENDS = ("cri_pallas", "cri_ref", "cri_pallas_interpret")


class LandingSolver:
    """Landing trajectory optimizer for one problem family."""

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
    ):
        if kind not in _PROBLEMS:
            raise KeyError(f"unknown problem kind '{kind}'; available: {sorted(_PROBLEMS)}")
        # retry_guess: the alternate cold-guess family chain that the
        # streaming solver's per-lane variant selects (variant k uses chain[k-1])
        if isinstance(retry_guess, str):
            retry_chain = tuple(retry_guess.split(","))
        else:
            retry_chain = tuple(retry_guess or ())
        for g in (guess,) + retry_chain:
            if g not in ("reference", "ballistic", "nn"):
                raise KeyError(f"unknown guess '{g}' (reference | ballistic | nn)")
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
        # voltage rows couple adjacent knots' jpos: dense path only
        self.structured = structured and kind != "kinodynamic_voltage"
        problem_fn, self._params_fn = _PROBLEMS[kind]
        self.robot_params = get_robot_params(robot)
        self.problem: LandingProblem = problem_fn(self.robot_params, n_knots=n_knots)
        f32 = dtype == torch.float32
        if config is None:
            # the JAX package's defaults, except the structured backend: the
            # port's default is "cri", the path of the hand-written kernel
            # (the JAX default config leaves IPConfig's "scan")
            config = IPConfig(
                max_iter=250,
                hessian_mode="hybrid",
                mu_min=1e-5 if f32 else 1e-6,
                sigma_max=1e5 if f32 else 1e8,
                tol=2e-4 if f32 else 1e-4,
                relax_scale=1.0,
                delta_c=1e-6 if (self.structured or kind == "contact_scheduled") else 1e-8,
                refine_steps=(3 if self.structured else 2) if f32 else 1,
                kkt_backend="cri",
            )
        if self.structured and config.kkt_backend in _NOT_PORTED_BACKENDS:
            raise NotImplementedError(
                f"kkt_backend={config.kkt_backend!r} forces a TPU or interpret path of the JAX "
                "package; the port has 'cri', 'cr' and 'scan'"
            )
        self.config = config
        self._z_scale = torch.as_tensor(landing_z_scale(self.problem), dtype=dtype,
                                        device=self.device)
        self._relax_mask = torch.as_tensor(self.problem.relax_mask(), dtype=dtype,
                                           device=self.device)
        self._nn = None
        self._nn_path = nn_path
        if guess == "nn" or "nn" in retry_chain:
            from .warmstart.nn import N_KNOTS, load_warmstart

            if n_knots != N_KNOTS:
                raise ValueError(
                    f"nn guess predicts the production N={N_KNOTS} grid, got n_knots={n_knots}"
                )
            self._nn = load_warmstart(nn_path or DEFAULT_NN_PATH, dtype=dtype, device=self.device)

    # ------------------------------------------------------------ params
    def _as_batch(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def build_params(self, q_init, qd_init):
        """(B, 6) scenarios -> LandingParams of B lanes."""
        theta = self._params_fn(self._as_batch(q_init), self._as_batch(qd_init),
                                n_knots=self.problem.config.n_knots, robot=self.robot)
        if self.theta_overrides:
            theta = dataclasses.replace(theta, **{
                k: self._as_batch(v).expand_as(getattr(theta, k)).clone()
                for k, v in self.theta_overrides.items()
            })
        return theta

    def _family(self, name):
        if name == "nn":
            from .warmstart.nn import nn_warmstart_guess

            mlp, stats = self._nn
            return lambda prob, th: nn_warmstart_guess(mlp, stats, th.q_init, th.qd_init, prob)
        if name == "ballistic":
            return ballistic_guess
        return initial_guess_from_reference

    def _cold_guess(self, theta, variant=None):
        """Cold-start z0 (B, n).  ``variant``: None or 0 selects the
        configured guess, k >= 1 the k-th retry family; an int applies to
        every lane, a (B,) tensor selects per lane (all families computed,
        picked branch-free)."""
        prob = self.problem
        default_alt = {"nn": "ballistic", "ballistic": "reference", "reference": "ballistic"}[self.guess]
        names = (self.guess,) + (self.retry_guess or (default_alt,))
        if variant is None or isinstance(variant, int):
            return self._family(names[variant or 0])(prob, theta)
        out = self._family(names[0])(prob, theta)
        for i, name in enumerate(names[1:]):
            out = torch.where((variant == i + 1)[:, None], self._family(name)(prob, theta), out)
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
        theta = self.build_params(q_init, qd_init)
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
        """The LandingSolution of the lanes at ``state``."""
        return self._solution(snlp, self.program(snlp).finish(state))

    def _solution(self, snlp: ScaledNLP, res) -> LandingSolution:
        prob = self.problem
        z = snlp.from_scaled(res.z)
        v = prob.unpack(z)
        lam_u, y_u = snlp.duals_from_scaled(res.lam, res.y)
        if prob.config.kinodynamic:
            tau = leg_torques(self.robot_params, v.jpos, v.X[:, :-1, 3:6], v.U[..., 12:])
        else:
            tau = z.new_zeros(v.U.shape[:-1] + (12,))
        return LandingSolution(
            X=v.X, jpos=v.jpos, U=v.U, tau=tau, z=z,
            converged=res.converged, iterations=res.iterations, kkt_error=res.kkt_error,
            constr_viol=res.constr_viol, cost=res.cost,
            s=snlp.slacks_from_scaled(res.s), lam=lam_u, y=y_u,
        )

    def _solve_impl(self, q_init, qd_init, z0=None, warm=None) -> LandingSolution:
        """Solve B scenarios (see :meth:`start` for z0 and warm)."""
        snlp, state = self.start(q_init, qd_init, z0, warm)
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
            n_knots=self.problem.config.n_knots,
            robot=self.robot,
            config=cfg,
            dtype=self.dtype,
            theta_overrides=self.theta_overrides,
            structured=self.structured,
            guess=self.guess,
            retry_guess=self.retry_guess,
            device=self.device,
            nn_path=self._nn_path,
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
    (problems/eeparam.py; the reference's quadruped_SRBM_eeParam.m:26-409).

    The decision vector is spline coefficients and phase durations rather
    than knot states, so this family lives outside :class:`LandingSolver`
    with the same ergonomics, on the dense KKT path::

        s = EEParamSolver()                      # f32, on the GPU
        sol = s.solve(s.build_params())          # the default drop
        sols = s.solve_batch(thetas)             # EEParamParams of B lanes
    """

    def __init__(self, config=None, ip_config: IPConfig | None = None, dtype=torch.float32,
                 device="cuda"):
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.problem = eeparam_problem(config)
        self.dtype = dtype
        f32 = dtype == torch.float32
        if ip_config is None:
            # the JAX package's settings: no complementarity rows, GN curvature,
            # a 2-candidate ladder, 7 refinement sweeps in f32 (its batched f32
            # path plateaus at kkt ~3e-3 on some lanes with 3-5)
            ip_config = IPConfig(
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
        self.config = ip_config
        self._relax_mask = torch.as_tensor(self.problem.relax_mask(), dtype=dtype,
                                           device=self.device)

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
        prob = self.problem
        theta = tree_map(lambda t: t.to(dtype=self.dtype, device=self.device), theta)
        z0 = prob.initial_guess(theta)
        snlp = scale_problem(prob, theta, z0)
        res = solve(snlp.cost, snlp.eq, snlp.ineq, snlp.to_scaled(z0), self.config,
                    relax_mask=self._relax_mask)
        z = snlp.from_scaled(res.z)
        return EEParamSolution(v=prob.unpack(z), z=z, converged=res.converged,
                               iterations=res.iterations, kkt_error=res.kkt_error,
                               constr_viol=res.constr_viol, cost=res.cost)

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
