"""High-level solve API: problem transcription + scaling + IP solver.

Example::

    solver = LandingSolver()                        # kinodynamic, on the GPU
    sol = solver.solve(q_init, qd_init)             # one scenario
    sols = solver.solve_batch(q_inits, qd_inits)    # (B, 6) batch

``LandingSolver(kind)`` solves ``kinodynamic`` (the production problem, the
default), ``srbm_lcp``, ``sliding``, ``ccc`` and ``contact_scheduled`` on the
stage-structured ``cri`` path.

The solver runs on the card unless constructed with ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ._tree import tree_map
from .models import get_robot_params
from .dynamics.legs import leg_torques
from .problems.landing import (
    LandingProblem,
    ccc_problem,
    contact_scheduled_problem,
    kinodynamic_problem,
    sliding_problem,
    srbm_lcp_problem,
)
from .solver.ip import IPConfig, solve
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

# the committed warm-start artifact, read as a data file by path
DEFAULT_NN_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "landing_controller_tpu", "data", "nn_TO_landing.npz",
)


@dataclasses.dataclass(frozen=True)
class LandingSolution:
    X: torch.Tensor  # (B, N, 12) base trajectory
    jpos: torch.Tensor  # (B, N-1, 12) joint angles (empty for the srbm family)
    U: torch.Tensor  # (B, N-1, 24) foot positions + GRFs
    tau: torch.Tensor  # (B, N-1, 12) Jacobian-transpose joint torques (zeros for the srbm family)
    z: torch.Tensor  # flat solution (reference layout)
    converged: torch.Tensor
    iterations: torch.Tensor
    kkt_error: torch.Tensor
    constr_viol: torch.Tensor
    cost: torch.Tensor
    # warm-start state (unscaled): inequality slacks and multipliers,
    # equality multipliers
    s: torch.Tensor
    lam: torch.Tensor
    y: torch.Tensor


_PROBLEMS = {
    "kinodynamic": (kinodynamic_problem, kinodynamic_params),
    "srbm_lcp": (srbm_lcp_problem, srbm_lcp_params),
    "ccc": (ccc_problem, ccc_params),
    "contact_scheduled": (contact_scheduled_problem, contact_scheduled_params),
    "sliding": (sliding_problem, srbm_lcp_params),
}
# voltage rows couple adjacent knots' jpos: dense KKT path only, not ported
_NOT_PORTED = ("kinodynamic_voltage",)


def resolve_device(device) -> torch.device:
    """The solver's device; "cuda" requires a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


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
        if kind in _NOT_PORTED:
            raise NotImplementedError(f"problem kind '{kind}' is not ported to PyTorch yet")
        if kind not in _PROBLEMS:
            raise KeyError(f"unknown problem kind '{kind}'; available: {sorted(_PROBLEMS)}")
        if not structured:
            raise NotImplementedError("the dense KKT path is not ported to PyTorch yet")
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
        problem_fn, self._params_fn = _PROBLEMS[kind]
        self.robot_params = get_robot_params(robot)
        self.problem: LandingProblem = problem_fn(self.robot_params, n_knots=n_knots)
        f32 = dtype == torch.float32
        if config is None:
            config = IPConfig(
                max_iter=250,
                hessian_mode="hybrid",
                mu_min=1e-5 if f32 else 1e-6,
                sigma_max=1e5 if f32 else 1e8,
                tol=2e-4 if f32 else 1e-4,
                relax_scale=1.0,
                delta_c=1e-6,
                refine_steps=3 if f32 else 1,
                kkt_backend="cri",
            )
        if config.kkt_backend != "cri":
            raise NotImplementedError(
                f"kkt_backend={config.kkt_backend!r}: the PyTorch port has 'cri' only"
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

    # ------------------------------------------------------------ solves
    def _solve_impl(self, q_init, qd_init, z0=None, warm=None) -> LandingSolution:
        """Solve B scenarios.  z0: optional primal warm start (B, n);
        warm: optional unscaled (s, lam, y)."""
        prob = self.problem
        theta = self.build_params(q_init, qd_init)
        z0 = self._cold_guess(theta) if z0 is None else self._as_batch(z0)
        snlp = self.scaled_problem(theta, z0)
        step_fn = make_structured_newton_step(prob, theta, self.config, snlp)
        s0 = lam0 = y0 = None
        if warm is not None:
            s_u, lam_u, y_u = (self._as_batch(w) for w in warm)
            s0 = torch.clamp(snlp.slacks_to_scaled(s_u), min=1e-12)
            lam0, y0 = snlp.duals_to_scaled(lam_u, y_u)
            lam0 = torch.clamp(lam0, min=1e-10)
        res = solve(snlp.cost, snlp.eq, snlp.ineq, snlp.to_scaled(z0), self.config,
                    s0=s0, lam0=lam0, y0=y0, relax_mask=self._relax_mask,
                    newton_step_fn=step_fn)
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
        step_fn = make_structured_newton_step(self.problem, snlp.theta, self.config, snlp)
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
