"""Receding-horizon replanning, the 100 Hz warm-restart primitive.

The reference's replan flow saves (X*, U*, jpos*, lam_g*) and re-solves the
same horizon from a new measured state with warm initialization
(landing_optimization.m:395-435, KNITRO ``strat_warm_start``).  Here the full
primal-dual state (z, s, lam, y) carries between solves on the device:

- the previous solution is re-anchored: its knot-0 state is replaced by the
  measured state (the equality rows pin it anyway; re-anchoring keeps the
  initial defect small so the warm solve stays in Newton's basin);
- slacks and multipliers pass through (rescaled to the new solve's row
  scaling by the API);
- the solve runs under a capped-iteration warm config: the iteration cap is
  the real-time watchdog (the reference's ``maxtime_real`` / ``maxit``).

Two tiers: a tracking ``replan`` (mu restarts near its floor, tight cap), and
a ``recover`` on non-convergence (the barrier/MPCC homotopy re-opened,
mu_init 1e-2, larger cap, stale duals dropped).

Every method takes one scenario (q (6,)) or a batch (q (B, 6)) and returns
a LandingSolution of the same shape.
"""

from __future__ import annotations

import dataclasses

import torch

from .._tree import tree_map, tree_where
from ..solver.ip import IPConfig


@dataclasses.dataclass(frozen=True)
class ReplanState:
    """Primal-dual warm-start state carried between replans (unscaled)."""

    z: torch.Tensor
    s: torch.Tensor
    lam: torch.Tensor
    y: torch.Tensor


def warm_config(iter_cap: int = 30, dtype=torch.float32, mu_init: float = 1e-4) -> IPConfig:
    """Capped-iteration warm-solve config (the 10 ms-budget analogue of the
    reference's maxit / maxtime_real watchdogs)."""
    f32 = dtype == torch.float32
    return IPConfig(
        max_iter=iter_cap,
        mu_init=mu_init,
        mu_min=1e-5 if f32 else 1e-6,
        tol=2e-4 if f32 else 1e-4,
        sigma_max=1e5 if f32 else 1e8,
        refine_steps=2 if f32 else 1,
        relax_scale=1.0,
        delta_c=1e-6 if f32 else 1e-8,
        kkt_backend="cri",
        hessian_mode="hybrid",
    )


class Replanner:
    """Receding-horizon replanner over one problem kind.

    Usage::

        rp = Replanner("srbm_lcp", iter_cap=30, device="cpu")
        sol = rp.plan(q0, qd0)                  # full solve (cold/offline)
        sol2 = rp.replan(Replanner.carry(sol), q_meas, qd_meas)
    """

    def __init__(self, kind: str = "srbm_lcp", n_knots: int = 21, iter_cap: int = 30,
                 recover_cap: int = 120, dtype=torch.float32, robot: str = "mc3D",
                 plan_config: IPConfig | None = None, **solver_kw):
        from ..api import LandingSolver

        self.dtype = dtype
        self.solver_warm = LandingSolver(kind, n_knots=n_knots, robot=robot, dtype=dtype,
                                         config=warm_config(iter_cap, dtype), **solver_kw)
        # recovery tier: homotopy re-opened (mu_init 1e-2) so shifted LCP
        # active sets can re-form, with a larger cap
        self.solver_recover = LandingSolver(kind, n_knots=n_knots, robot=robot, dtype=dtype,
                                            config=warm_config(recover_cap, dtype, mu_init=1e-2),
                                            **solver_kw)
        self.solver_plan = LandingSolver(kind, n_knots=n_knots, robot=robot, dtype=dtype,
                                         config=plan_config, **solver_kw)

    @staticmethod
    def _run(solver, q, qd, z0=None, warm=None):
        """solver._solve_impl on one scenario or a batch."""
        q, qd = solver._as_batch(q), solver._as_batch(qd)
        if q.dim() == 2:
            return solver._solve_impl(q, qd, z0, warm)
        lift = lambda x: None if x is None else solver._as_batch(x)[None]  # noqa: E731
        warm = None if warm is None else tuple(lift(w) for w in warm)
        return tree_map(lambda t: t[0], solver._solve_impl(q[None], qd[None], lift(z0), warm))

    def _anchor(self, state: ReplanState, q_meas, qd_meas):
        """The carried primal with its knot-0 state set to the measurement."""
        z0 = state.z.clone()
        z0[..., 0:6] = torch.as_tensor(q_meas, dtype=z0.dtype, device=z0.device)
        z0[..., 6:12] = torch.as_tensor(qd_meas, dtype=z0.dtype, device=z0.device)
        return z0

    def plan(self, q_init, qd_init):
        """Full-budget solve (the offline plan / first solve)."""
        return self._run(self.solver_plan, q_init, qd_init)

    def replan(self, state: ReplanState, q_meas, qd_meas):
        """One warm, iteration-capped re-solve from a measured state: the
        carried primal re-anchored, the carried (s, lam, y) passed through."""
        return self._run(self.solver_warm, q_meas, qd_meas, z0=self._anchor(state, q_meas, qd_meas),
                         warm=(state.s, state.lam, state.y))

    def recover(self, state: ReplanState, q_meas, qd_meas):
        """Recovery re-solve after a tracking replan failed: the carried primal
        as the guess, the barrier/MPCC homotopy re-opened, the stale duals
        discarded (after an active-set shift they mislead more than help)."""
        return self._run(self.solver_recover, q_meas, qd_meas,
                         z0=self._anchor(state, q_meas, qd_meas))

    def step(self, state: ReplanState, q_meas, qd_meas):
        """One MPC tick: tracking replan, recovery where it did not converge.
        Returns (solution, new_state).  Reading the convergence flags is the
        one host sync per tick."""
        sol = self.replan(state, q_meas, qd_meas)
        if not bool(sol.converged.all()):
            rec = self.recover(state, q_meas, qd_meas)
            sol = tree_where(sol.converged, sol, rec) if sol.converged.dim() else rec
        return sol, self.carry(sol)

    @staticmethod
    def carry(sol) -> ReplanState:
        return ReplanState(z=sol.z, s=sol.s, lam=sol.lam, y=sol.y)


__all__ = ["ReplanState", "Replanner", "warm_config"]
