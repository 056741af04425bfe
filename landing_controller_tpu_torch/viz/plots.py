"""Matplotlib summary panels mirroring the reference's diagnostics.

``plot_results`` reproduces utilities_landing/plot_results.m:1-144 — a 4x3
tiled layout: per-leg GRFs (z, x, y), foot x/y positions, CoM position /
velocity / orientation, Jacobian-transpose torques against the +-[18,18,28]
limits, and motor voltages against the battery limit using the same
back-EMF model (plot_results.m:23-38).

``plot_envelope`` renders success-region maps from batched sweeps — the
analogue of plotting/pitch_xVel.m.  matplotlib is imported by the plotting
functions only; ``motor_voltages`` needs numpy alone.
"""

from __future__ import annotations

import numpy as np
import torch


def motor_voltages(model, tau, jpos, dts):
    """Motor terminal voltage estimate per joint (plot_results.m:23-38).

    tau: (N-1, 12) joint torques; jpos: (N-1, 12); dts: (N-1,).
    v = tau/(gr * 1.5 kt) * Rm + qdot * gr * kt * 2.
    """
    tau = np.asarray(tau)
    jpos = np.asarray(jpos)
    n = tau.shape[0]
    gr = np.tile(np.asarray(model.gear_ratio), 4)
    kt = np.tile(np.asarray(model.kt), 4)
    rm = np.tile(np.asarray(model.rm), 4)
    joint_vel = np.zeros_like(tau)
    joint_vel[: n - 1] = np.diff(jpos, axis=0) / np.asarray(dts)[: n - 1, None]
    current = tau / gr / (1.5 * kt)
    back_emf = joint_vel * gr * kt * 2.0
    return current * rm + back_emf


def plot_results(model, t_star, X, U, jpos, tau=None, save_path=None):
    """Summary panel figure for one landing trajectory.

    X: (N,12), U: (N-1,24), jpos: (N-1,12), tau: (N-1,12) (computed from the
    analytic Jacobians if not given, by the port's ``leg_torques`` over the
    knots in float64 on the CPU).  Returns the matplotlib figure.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    X = np.asarray(X)
    U = np.asarray(U)
    jpos = np.asarray(jpos)
    t = np.asarray(t_star)
    tk = t[:-1]
    f = U[:, 12:].reshape(-1, 4, 3)
    c = U[:, :12].reshape(-1, 4, 3)
    legs = ["FR", "FL", "BR", "BL"]

    if tau is None:
        from ..dynamics.legs import leg_torques

        as_t = lambda a: torch.as_tensor(np.asarray(a, float))  # noqa: E731
        tau = leg_torques(model.params, as_t(jpos), as_t(X[:-1, 3:6]), as_t(U[:, 12:])).numpy()
    tau = np.asarray(tau)

    fig, axes = plt.subplots(5, 3, figsize=(15, 16))
    for axis, comp, title in zip(axes[0], [2, 0, 1], ["Vertical", "X", "Y"]):
        for leg in range(4):
            axis.plot(tk, f[:, leg, comp], label=legs[leg])
        axis.set_title(f"{title} ground reaction forces")
        axis.set_xlabel("Time (s)")
        axis.set_ylabel("Force (N)")
        axis.legend(fontsize=7)

    for axis, comp, title in zip(axes[1], [0, 1, 2], ["X", "Y", "Z"]):
        for leg in range(4):
            axis.plot(tk, c[:, leg, comp], label=legs[leg])
        axis.set_title(f"Foot {title} positions")
        axis.set_xlabel("Time (s)")
        axis.set_ylabel("Position (m)")

    titles = ["CoM Position", "CoM Velocity", "CoM Orientation"]
    datas = [X[:, 0:3], X[:, 9:12], np.rad2deg(X[:, 3:6])]
    labels = [["X", "Y", "Z"], ["X", "Y", "Z"], ["Roll", "Pitch", "Yaw"]]
    for axis, data, title, lab in zip(axes[2], datas, titles, labels):
        for i in range(3):
            axis.plot(t, data[:, i], label=lab[i])
        axis.set_title(title)
        axis.set_xlabel("Time (s)")
        axis.legend(fontsize=7)

    # torques vs limits (one wide panel)
    gs = axes[3, 0].get_gridspec()
    for a in axes[3]:
        a.remove()
    ax_t = fig.add_subplot(gs[3, :])
    colors = ["r", "g", "b"]
    tau_lim = np.asarray(model.tau_max[:3])
    for j, col in enumerate(colors):
        for leg in range(4):
            ax_t.plot(tk, tau[:, 3 * leg + j], col + "-", lw=1)
        ax_t.axhline(tau_lim[j], color=col, ls="--")
        ax_t.axhline(-tau_lim[j], color=col, ls="--")
    ax_t.set_title("Torque limits (r=abad, g=hip, b=knee)")
    ax_t.set_xlabel("Time (s)")
    ax_t.set_ylabel("Torque (Nm)")

    # voltages vs battery limit
    for a in axes[4]:
        a.remove()
    ax_v = fig.add_subplot(gs[4, :])
    v = motor_voltages(model, tau, jpos, np.diff(t))
    for i in range(12):
        ax_v.plot(tk, v[:, i], lw=1)
    ax_v.axhline(model.battery_v, color="k", ls="--")
    ax_v.axhline(-model.battery_v, color="k", ls="--")
    ax_v.set_ylim(-26, 26)
    ax_v.set_title("Voltage limits")
    ax_v.set_xlabel("Time (s)")
    ax_v.set_ylabel("Voltage (V)")

    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=110)
    return fig


def plot_envelope(x_vals, y_vals, success, x_label, y_label, save_path=None):
    """Success-region map over a 2-D scenario grid (pitch_xVel.m analogue).

    success: (len(y_vals), len(x_vals)) boolean/float convergence mask.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    im = ax.pcolormesh(
        np.asarray(x_vals), np.asarray(y_vals), np.asarray(success, dtype=float),
        shading="nearest", cmap="RdYlGn", vmin=0, vmax=1,
    )
    fig.colorbar(im, ax=ax, label="success rate")
    ax.set_xlabel(x_label)
    ax.set_ylabel(y_label)
    ax.set_title("Landing success envelope")
    if save_path:
        fig.savefig(save_path, dpi=110)
    return fig
