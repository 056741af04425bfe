"""Warm-start cascade: SRBM-LCP solve -> kinodynamic solve, batch-first.

The reference's production flow (landing_optimization.m:300-322 and the
training-data factory, generate_training_data_automated.m:121-176) solves the
cheap SRBM-LCP problem first and seeds the kinodynamic solve with its
(X, U).  Here both stages are the port's interior-point solver; joint angles
of the "full" seed come from closed-form IK on the stage-1 foot positions
with a Newton polish (the reference leaves jpos at its default).
"""

from __future__ import annotations

import numpy as np
import torch

from .._tree import tree_map
from ..dynamics.legs import foot_positions_world, inverse_kinematics, inverse_kinematics_newton
from ..problems.landing import LandingVars
from .reference import ballistic_guess


def kinodynamic_guess_from_srbm(kino_problem, robot_params, X, U, jpos_clip=None):
    """The kinodynamic initial guess (B, n) from stage-1 (SRBM) solutions
    X (B, N, 12), U (B, N-1, 24): jpos by closed-form IK (XYZ convention, the
    production FK convention) on the stage-1 foot positions with three Newton
    polish steps, clipped into the joint-limit box ``jpos_clip`` = (min, max)
    (each (B or 1, 12)), and the feet re-derived from the clipped angles, so
    the guess starts FK-consistent (the +-1 cm fk_band rows are
    equality-like)."""
    x, c = X[:, :-1, :6], U[..., :12]
    jpos = inverse_kinematics(robot_params, x, c, convention="xyz")
    jpos = inverse_kinematics_newton(robot_params, x, c, jpos, convention="xyz", iters=3)
    if jpos_clip is not None:
        jpos = torch.clamp(jpos, jpos_clip[0][:, None], jpos_clip[1][:, None])
    c_fk = foot_positions_world(robot_params, x, jpos).reshape(c.shape)
    return kino_problem.pack(LandingVars(X=X, jpos=jpos, U=torch.cat([c_fk, U[..., 12:]], -1)))


def cascade_seed(kino_problem, robot_params, theta, X, U, seed_mode: str = "x_grf",
                 jpos_clip=None):
    """Stage 2's initial guess (B, n) from stage-1 solutions X, U for the
    kinodynamic parameters ``theta``: "x_grf" takes the stage-1 base
    trajectory and GRFs with the ballistic guess's feet and home jpos;
    "full" is :func:`kinodynamic_guess_from_srbm`."""
    if seed_mode == "full":
        return kinodynamic_guess_from_srbm(kino_problem, robot_params, X, U, jpos_clip)
    if seed_mode != "x_grf":
        raise ValueError(f"unknown seed_mode {seed_mode!r} (x_grf | full)")
    vb = kino_problem.unpack(ballistic_guess(kino_problem, theta))
    U = torch.cat([vb.U[..., :12], U[..., 12:]], -1)
    return kino_problem.pack(LandingVars(X=X, jpos=vb.jpos, U=U))


def make_cascade(srbm_solver, kino_solver, warm_mu_init: float | None = None,
                 seed_mode: str = "x_grf"):
    """Compose two LandingSolvers into one cascade solve.

    Returns ``fn(q_init, qd_init) -> (kino_solution, srbm_solution)`` for
    scenarios (B, 6) or one scenario (6,); ``fn.stage1`` and ``fn.stage2`` are
    the solvers it runs.

    - ``seed_mode="x_grf"`` (default): stage 2 takes the stage-1 base
      trajectory and GRF schedule with the ballistic guess's feet and home
      jpos (the JAX package's ablation, tools/cascade_sweep.py: 0.680 against
      cold 0.648 and full seeding 0.602 on the TPU; stage-1 feet sit on the
      kinematic-box and FK-band walls);
    - ``seed_mode="full"``: X, IK feet and jpos, and GRFs
      (:func:`kinodynamic_guess_from_srbm`).

    ``warm_mu_init``: barrier restart of stage 2; None keeps the solver's
    cold ``mu_init``.

    Stage 1 is rebuilt on stage 2's dt schedule where they differ: the
    kinodynamic stage runs on the production non-uniform grid while the
    srbm_lcp parameters default to a uniform one, and a seed on the other
    grid puts the contact pattern at the wrong times (the JAX package
    measured cascade convergence 0.29 against 0.72 cold)."""
    if seed_mode not in ("x_grf", "full"):
        raise ValueError(f"unknown seed_mode {seed_mode!r} (x_grf | full)")
    n_srbm = srbm_solver.problem.config.n_knots
    n_kino = kino_solver.problem.config.n_knots
    if n_srbm != n_kino:
        raise ValueError(
            f"cascade stages must share n_knots (srbm={n_srbm}, kino={n_kino}); a dt override "
            "across mismatched grids cannot be built"
        )
    zeros = np.zeros((1, 6))
    kino_theta0 = kino_solver.build_params(zeros, zeros)
    jl = (kino_theta0.jpos_min, kino_theta0.jpos_max)
    dt_kino = kino_theta0.dt[0].cpu().numpy()
    srbm_dt = srbm_solver.build_params(zeros, zeros).dt[0].cpu().numpy()
    if srbm_dt.shape != dt_kino.shape or not np.allclose(srbm_dt, dt_kino):
        from ..api import LandingSolver

        srbm_solver = LandingSolver(
            srbm_solver.kind,
            n_knots=n_srbm,
            robot=srbm_solver.robot,
            config=srbm_solver.config,
            dtype=srbm_solver.dtype,
            theta_overrides={**srbm_solver.theta_overrides, "dt": dt_kino},
            structured=srbm_solver.structured,
            guess=srbm_solver.guess,
            device=srbm_solver.device,
        )
    stage2 = kino_solver if warm_mu_init is None else kino_solver.warm_variant(warm_mu_init)

    def cascade(q_init, qd_init):
        q = stage2._as_batch(q_init)
        qd = stage2._as_batch(qd_init)
        single = q.dim() == 1
        if single:
            q, qd = q[None], qd[None]
        sol1 = srbm_solver._solve_impl(q, qd)
        z0 = cascade_seed(stage2.problem, stage2.robot_params, stage2.build_params(q, qd),
                          sol1.X, sol1.U, seed_mode, jl)
        sol2 = stage2._solve_impl(q, qd, z0=z0)
        if single:
            return tree_map(lambda t: t[0], sol2), tree_map(lambda t: t[0], sol1)
        return sol2, sol1

    cascade.stage1 = srbm_solver
    cascade.stage2 = stage2
    return cascade


__all__ = ["cascade_seed", "kinodynamic_guess_from_srbm", "make_cascade"]
