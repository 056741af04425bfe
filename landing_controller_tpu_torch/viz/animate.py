"""3D landing-trajectory animation — the `showmotion` analogue.

The reference ships Featherstone's interactive `showmotion` viewer
(spatial_v2/Animation/showmotion.m, buildShowMotionModelMC3D.m:1-82) and
every experiment script ends by animating the solved landing
(main_scripts/landing_optimization.m "showmotion(model, t*, q*)").  This
module is the headless equivalent: it renders the quadruped
(body box + 3-link legs from the same closed-form chain the NLP uses),
the ground plane, and optional GRF arrows, and writes a GIF/MP4 — the
physical-plausibility check of SURVEY.md §4.3 in a form that works in CI.

NumPy and Matplotlib on the host (visualization is off the compute path);
matplotlib is imported by :func:`animate_landing` only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dynamics.legs import SIDE_SIGN, SIDE_SIGN_XYZ
from ..dynamics.rotations import rpy_to_rot_xyz


def _rot(rpy) -> np.ndarray:
    """Body-to-world rotation of one (3,) rpy, in float64 numpy."""
    return rpy_to_rot_xyz(torch.as_tensor(np.asarray(rpy, float))).numpy()


def _chain_points(params, q_base, jpos):
    """Per-leg [abad pivot, knee, foot] world positions, (4, 3, 3).

    Same chain as dynamics.legs.foot_positions_hip (abad Rx -> hip Ry ->
    knee Ry, get_forward_kin_foot.m) with the intermediate knee point kept.
    """
    q = np.asarray(jpos, float).reshape(4, 3)
    side = np.asarray(SIDE_SIGN)
    l1, l2, l3 = params.l1, params.l2, params.l3
    s1, s2, s3 = np.sin(q[:, 0]), np.sin(q[:, 1]), np.sin(q[:, 2])
    c1, c2, c3 = np.cos(q[:, 0]), np.cos(q[:, 1]), np.cos(q[:, 2])
    c23 = c2 * c3 - s2 * s3
    s23 = s2 * c3 + c2 * s3

    knee = np.stack(
        [l2 * s2, side * l1 * c1 + s1 * (l2 * c2), side * l1 * s1 - c1 * (l2 * c2)],
        axis=-1,
    )
    foot = np.stack(
        [
            l3 * s23 + l2 * s2,
            side * l1 * c1 + s1 * (l2 * c2 + l3 * c23),
            side * l1 * s1 - c1 * (l2 * c2 + l3 * c23),
        ],
        axis=-1,
    )
    abad = np.asarray(SIDE_SIGN_XYZ) * np.asarray(params.abad_location)  # (4,3)
    pts_body = np.stack([np.zeros_like(abad), knee, foot], axis=1) + abad[:, None, :]
    R = _rot(q_base[3:6])
    return np.asarray(q_base[:3], float) + pts_body @ R.T


def _body_corners(params, q_base):
    """World positions of the 8 body-box corners, (8, 3)."""
    hx, hy = params.body_length / 2.0, params.body_width / 2.0
    hz = params.body_height / 2.0
    corners = np.array(
        [[sx * hx, sy * hy, sz * hz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    )
    R = _rot(q_base[3:6])
    return np.asarray(q_base[:3], float) + corners @ R.T


_BOX_EDGES = [
    (0, 1), (2, 3), (4, 5), (6, 7),  # z edges
    (0, 2), (1, 3), (4, 6), (5, 7),  # y edges
    (0, 4), (1, 5), (2, 6), (3, 7),  # x edges
]


def draw_frame(ax, params, q_base, jpos, f_grf=None, force_scale=0.002):
    """Draw one robot configuration onto a 3D axis."""
    pts = _chain_points(params, q_base, jpos)  # (4,3,3)
    box = _body_corners(params, q_base)
    for i, j in _BOX_EDGES:
        ax.plot(*zip(box[i], box[j]), color="#444444", lw=1.2)
    colors = ["#d62728", "#1f77b4", "#2ca02c", "#9467bd"]
    for leg in range(4):
        ax.plot(pts[leg, :, 0], pts[leg, :, 1], pts[leg, :, 2], "-o", color=colors[leg], lw=2, ms=2.5)
    if f_grf is not None:
        f = np.asarray(f_grf, float).reshape(4, 3)
        feet = pts[:, 2, :]
        for leg in range(4):
            if np.linalg.norm(f[leg]) > 1.0:
                ax.quiver(
                    feet[leg, 0], feet[leg, 1], feet[leg, 2],
                    f[leg, 0] * force_scale, f[leg, 1] * force_scale, f[leg, 2] * force_scale,
                    color="#ff7f0e", lw=1.5, arrow_length_ratio=0.15,
                )


def animate_landing(
    params,
    t,
    X,
    jpos,
    U=None,
    save_path="landing.gif",
    fps=20,
    elev=18.0,
    azim=-60.0,
    stride=1,
):
    """Render a solved landing trajectory to a GIF (or MP4 if ffmpeg exists).

    t: (N,) knot times; X: (N, 12) base states [xyz rpy | omega v];
    jpos: (N, 12) or (N-1, 12) joint angles; U: optional (N-1, 24)
    [foot pos | GRF] controls for force arrows.  Returns ``save_path``.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    t = np.asarray(t, float)
    X = np.asarray(X, float)
    jpos = np.asarray(jpos, float)
    n = X.shape[0]
    frames = list(range(0, n, stride))

    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(111, projection="3d")

    span = 0.6
    z_max = max(1.0, float(X[:, 2].max()) + 0.2)
    cx, cy = float(X[:, 0].mean()), float(X[:, 1].mean())

    def render(k):
        ax.clear()
        j = jpos[min(k, jpos.shape[0] - 1)]
        f = None
        if U is not None and k < len(U):
            f = np.asarray(U[k], float)[12:24]
        draw_frame(ax, params, X[k, :6], j, f_grf=f)
        # ground plane
        gx = np.linspace(cx - span, cx + span, 2)
        gy = np.linspace(cy - span, cy + span, 2)
        gxx, gyy = np.meshgrid(gx, gy)
        ax.plot_surface(gxx, gyy, np.zeros_like(gxx), alpha=0.15, color="#8c8c8c")
        ax.set_xlim(cx - span, cx + span)
        ax.set_ylim(cy - span, cy + span)
        ax.set_zlim(0.0, z_max)
        ax.set_box_aspect((1, 1, z_max / (2 * span)))
        ax.view_init(elev=elev, azim=azim)
        ax.set_title(f"t = {t[min(k, len(t) - 1)]:.3f} s")
        return []

    anim = animation.FuncAnimation(fig, render, frames=frames, blit=False)
    if str(save_path).endswith(".mp4"):
        try:
            writer = animation.FFMpegWriter(fps=fps)
        except Exception:
            save_path = str(save_path)[:-4] + ".gif"
            writer = animation.PillowWriter(fps=fps)
    else:
        writer = animation.PillowWriter(fps=fps)
    anim.save(save_path, writer=writer)
    plt.close(fig)
    return save_path
