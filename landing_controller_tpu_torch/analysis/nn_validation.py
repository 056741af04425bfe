"""NLP-vs-NN trajectory validation: the reference's overlay diagnostic
(generate_data/nn_data_validation.m:20-47).

The reference dumps NLP and NN trajectories to CSV and overlays them by
eye; here :func:`nn_vs_nlp` solves the kinodynamic NLP and evaluates the
warm-start MLP on the same initial condition, returning both trajectories
plus per-group error metrics, and :func:`plot_nn_overlay` renders the
overlay panel.
"""

from __future__ import annotations

import numpy as np
import torch

from .._tree import to_numpy
from ..warmstart.nn import nn_warmstart_guess


def nn_vs_nlp(mlp, stats, solver, q_init, qd_init):
    """Solve the NLP and predict with the NN on one initial condition (6,).

    solver: a kinodynamic LandingSolver; mlp, stats on its device and dtype.
    Returns a dict with the solved and predicted (X, U, jpos) as numpy arrays
    plus error metrics (base-state, foothold, GRF and joint-angle RMSE).
    """
    prob = solver.problem
    sol = solver.solve(q_init, qd_init)
    with torch.no_grad():
        z_nn = nn_warmstart_guess(mlp, stats, solver._as_batch(q_init)[None],
                                  solver._as_batch(qd_init)[None], prob)
    v = prob.unpack(z_nn)
    X_s, U_s, J_s = to_numpy(sol.X), to_numpy(sol.U), to_numpy(sol.jpos)
    X_n, U_n, J_n = to_numpy(v.X[0]), to_numpy(v.U[0]), to_numpy(v.jpos[0])

    def rmse(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2)))

    return {
        "converged": bool(sol.converged),
        "X_nlp": X_s, "U_nlp": U_s, "jpos_nlp": J_s,
        "X_nn": X_n, "U_nn": U_n, "jpos_nn": J_n,
        "rmse_base_pos": rmse(X_s[:, :3], X_n[:, :3]),
        "rmse_base_ori": rmse(X_s[:, 3:6], X_n[:, 3:6]),
        "rmse_feet": rmse(U_s[:, :12], U_n[:, :12]),
        "rmse_grf": rmse(U_s[:, 12:], U_n[:, 12:]),
        "rmse_jpos": rmse(J_s, J_n),
    }


def plot_nn_overlay(result, dts=None, save_path=None):
    """Overlay panel: NLP (solid) vs NN prediction (dashed) for base
    states, foot heights, and normal GRFs (nn_data_validation.m:20-47)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    X_s, X_n = result["X_nlp"], result["X_nn"]
    U_s, U_n = result["U_nlp"], result["U_nn"]
    n = X_s.shape[0]
    t = np.arange(n) if dts is None else np.concatenate([[0], np.cumsum(dts)])
    tu = t[:-1]
    fig, axes = plt.subplots(2, 2, figsize=(10, 7))
    ax = axes[0, 0]
    for i, lab in ((2, "z"), (0, "x")):
        ax.plot(t, X_s[:, i], label=f"NLP {lab}")
        ax.plot(t, X_n[:, i], "--", label=f"NN {lab}")
    ax.set_title("base position"); ax.legend(fontsize=7); ax.grid(alpha=0.3)
    ax = axes[0, 1]
    for i, lab in ((3, "roll"), (4, "pitch")):
        ax.plot(t, X_s[:, i], label=f"NLP {lab}")
        ax.plot(t, X_n[:, i], "--", label=f"NN {lab}")
    ax.set_title("base orientation"); ax.legend(fontsize=7); ax.grid(alpha=0.3)
    ax = axes[1, 0]
    for leg in range(4):
        ax.plot(tu, U_s[:, 3 * leg + 2], f"C{leg}")
        ax.plot(tu, U_n[:, 3 * leg + 2], f"C{leg}", ls="--")
    ax.set_title("foot heights (NLP solid / NN dashed)"); ax.grid(alpha=0.3)
    ax = axes[1, 1]
    for leg in range(4):
        ax.plot(tu, U_s[:, 12 + 3 * leg + 2], f"C{leg}")
        ax.plot(tu, U_n[:, 12 + 3 * leg + 2], f"C{leg}", ls="--")
    ax.set_title("normal GRFs (NLP solid / NN dashed)"); ax.grid(alpha=0.3)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=110, bbox_inches="tight")
    return fig
