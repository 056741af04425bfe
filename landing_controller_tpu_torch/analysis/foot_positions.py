"""Touchdown foot-position envelope analysis.

Port of the reference's `analysis/foot_positions.m`:

- per-leg touchdown knot = first knot with f_z > 1 N (``find(...,1)``,
  foot_positions.m:36-39);
- at each leg's touchdown knot: foot position relative to the CoM rotated
  into the body frame, the same position relative to the hip, the CoM
  velocity in the body frame, and the alignment heuristic
  ``dot(v_hat, p_hat)`` between the normalized body-frame CoM velocity and
  the normalized hip-relative foot position (foot_positions.m:56-75);
- a sweep driver that re-solves the CCC envelope problem over one IC
  dimension in one batched solve and collects the per-leg touchdown
  quantities: the data behind the reference's ``data/<fixed>_<sweep>.mat``
  files and the ``plotting/pitch_xVel.m`` overlay figures.

The per-solution analysis is host code (numpy).  The reference uses the
legacy ZYX rotation (rpyToRotMat) in this analysis; so does this module.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .._tree import to_numpy, tree_map
# body-frame hip locations (get_robot_params.m hipSrbmLocation; the
# reference hardcodes them in foot_positions.m:26-29)
from ..warmstart.reference import HIP_SRBM


def _rot_zyx(rpy):
    """rpyToRotMat (ZYX body-to-world, rpyToRotMat.m): rz(y)'ry(p)'rx(r)'."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


class TouchdownAnalysis(NamedTuple):
    td: np.ndarray  # (4,) touchdown knot per leg (-1 = never lands)
    p_body: np.ndarray  # (4, 3) foot rel. CoM, body frame, at touchdown
    p_hip: np.ndarray  # (4, 3) foot rel. hip, body frame, at touchdown
    v_body: np.ndarray  # (4, 3) CoM velocity, body frame, at touchdown
    dot_v_p: np.ndarray  # (4,) alignment heuristic dot(v_hat, p_hat)


def touchdown_indices(f, thresh: float = 1.0) -> np.ndarray:
    """Per-leg first knot with f_z > thresh (find(f_star(3k,:)>1,1),
    foot_positions.m:36-39).  -1 if the leg never lands."""
    f = np.asarray(f)
    td = np.full(4, -1, dtype=int)
    for leg in range(4):
        hits = np.nonzero(f[3 * leg + 2, :] > thresh)[0]
        if hits.size:
            td[leg] = int(hits[0])
    return td


def touchdown_analysis(X, p, f) -> TouchdownAnalysis:
    """Per-leg touchdown quantities (foot_positions.m:56-75).

    X: (12, N) base states [r; rpy; omega_body; v_world]; p: (12, N-1)
    world foot positions; f: (12, N-1) world GRFs.
    """
    X, p, f = np.asarray(X), np.asarray(p), np.asarray(f)
    td = touchdown_indices(f)
    p_body = np.zeros((4, 3))
    p_hip = np.zeros((4, 3))
    v_body = np.zeros((4, 3))
    dot_v_p = np.zeros(4)
    for leg in range(4):
        k = td[leg]
        if k < 0:
            p_body[leg] = p_hip[leg] = v_body[leg] = np.nan
            dot_v_p[leg] = np.nan
            continue
        b_R_w = _rot_zyx(X[3:6, k]).T
        p_body[leg] = b_R_w @ (p[3 * leg : 3 * leg + 3, k] - X[0:3, k])
        v_body[leg] = b_R_w @ X[9:12, k]
        p_hip[leg] = p_body[leg] - HIP_SRBM[leg]
        vn = np.linalg.norm(v_body[leg])
        pn = np.linalg.norm(p_hip[leg])
        dot_v_p[leg] = (
            float(v_body[leg] @ p_hip[leg] / (vn * pn)) if vn > 0 and pn > 0 else np.nan
        )
    return TouchdownAnalysis(td=td, p_body=p_body, p_hip=p_hip, v_body=v_body, dot_v_p=dot_v_p)


def analyze_solution(sol) -> TouchdownAnalysis:
    """TouchdownAnalysis from one scenario's LandingSolution (no batch
    dimension; U = [c(12); f(12)] rows)."""
    X = to_numpy(sol.X).T  # (12, N)
    U = to_numpy(sol.U)  # (N-1, 24)
    return touchdown_analysis(X, U[:, :12].T, U[:, 12:].T)


def sweep_foot_positions(solver, q_init, qd_init, sweep_dim: int, sweep_values):
    """foot_positions.m sweep driver: vary one qd dimension, solve, analyze.

    Returns a list of dicts (one per sweep value): the value, the solution
    convergence flag, and the TouchdownAnalysis.  One ``solve_batch`` over
    the sweep (the reference's serial for-loop, foot_positions.m:32-43).
    """
    vals = np.asarray(sweep_values, dtype=np.float64)
    B = len(vals)
    q0s = np.tile(np.asarray(q_init, np.float64), (B, 1))
    qd0s = np.tile(np.asarray(qd_init, np.float64), (B, 1))
    qd0s[:, sweep_dim] = vals
    sols = solver.solve_batch(q0s, qd0s)
    conv = to_numpy(sols.converged)
    return [
        {
            "value": float(vals[i]),
            "converged": bool(conv[i]),
            "analysis": analyze_solution(tree_map(lambda t, i=i: t[i], sols)),
        }
        for i in range(B)
    ]


def load_reference_sweep(path: str):
    """Load one of the reference's committed data/<fixed>_<sweep>.mat
    envelope files into [(X, q, f, p, td), ...] numpy tuples."""
    import scipy.io as sio

    d = sio.loadmat(path, squeeze_me=True, struct_as_record=False)
    out = []
    for s in np.atleast_1d(d["opt_sol"]):
        out.append(
            {
                "X": np.asarray(s.X_star),
                "q": np.asarray(s.q_star),
                "f": np.asarray(s.f_star),
                "p": np.asarray(s.p_star),
                "td": np.asarray(s.td).reshape(-1).astype(int) - 1,  # 1-based
            }
        )
    return out
