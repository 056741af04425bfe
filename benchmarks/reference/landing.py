"""Plain PyTorch reference of the landing NLPs, in float64 (or, as the
control of the comparison that decides ``correct``, in TF32).

It works out again, from the drop conditions the harness hands to both
sides, what the program's set-up derives (the parameter sets, the dt
schedule, the state and foot references, the kinematic boxes, each cold
guess, the variable and row scales), evaluates every equality and
inequality row of the NLP at the trajectory the program returned, and gives
the constraint violation as the solver defines it (the scaled rows, the
bound relaxation, the larger of the equality and inequality parts).  It
imports nothing of the program.  It is a frozen copy, written out in plain
tensors, of:

- the rows: ``problems/landing.py:240-560`` (dynamics defects, head rows,
  contact, complementarity, no-slip, kinematic boxes, leg length, friction,
  state and terminal boxes; kinodynamic: torques, FK band, joint limits);
- the dynamics and kinematics: ``dynamics/srbm.py:47-70``,
  ``dynamics/rotations.py:77-118``, ``dynamics/legs.py:49-150``;
- the parameter sets: ``warmstart/reference.py:120-225``
  (generate_landingCtrller_IPOPT_warmstart.m:168-225,
  landing_optimization.m:203-297);
- the cold guesses: ``warmstart/reference.py:316-383`` (ballistic,
  reference) and ``warmstart/nn.py:105-281`` (the network, read from the
  committed ``data/nn_TO_landing.npz``, a raw file both sides read);
- the scaling: ``solver/scaling.py:78-131`` (row scales min(1, 50 /
  ||row gradient * d||_inf) at the cold guess) and the violation of
  ``solver/ip.py:639-650``.

Robot constants (mass, inertia, link lengths) come from the configuration
file.  Every function takes a leading batch of scenarios.

``precision="tf32"`` computes the same in float32 with every matrix product
(rotations of vectors and of the hips and feet, the torque map, the
network's layers) taken in TF32, the precision below the configuration's
float32 with TF32 off: the inputs of each product rounded to TF32's 10-bit
mantissa and the products summed in float32.  The row scales are taken in
float32 without that rounding (they are min(1, 50 / |gradient|) and move by
TF32's rounding alone).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import jvp, vmap

G = 9.81
FOOT_SIGN = ((1, -1, 1), (1, 1, 1), (-1, -1, 1), (-1, 1, 1))
LEG_SIDE = (-1.0, 1.0, -1.0, 1.0)
Q_LEG_HOME = (0.0, -0.8, 1.6)
G_MAX = 50.0  # the row-scaling target, solver/scaling.py:78

# the parameter sets of the two NLPs (warmstart/reference.py:120-225); qn is
# the terminal cost's weight diagonal
PARAMS = {
    "srbm_lcp": dict(
        q_term_ref=(0, 0, 0.275, 0, 0, 0), foot_ref=(0.2, 0.1, -0.2), rotated_foot_ref=False,
        q_min=(-10, -10, 0.1, -10, -10, -10), q_max=(10, 10, 1.0, 10, 10, 10),
        qd_min=(-10, -10, -10, -40, -40, -40), qd_max=(10, 10, 10, 40, 40, 40),
        q_term_min=(-10, -10, 0.2, -0.1, -0.1, -10), q_term_max=(10, 10, 5, 0.1, 0.1, 10),
        qd_term_min=(-10, -10, -10, -40, -40, -40), qd_term_max=(10, 10, 10, 40, 40, 40),
        mu=1.0, l_leg_max=0.35, f_max=200.0, horizon=0.6,
        lcp_eps=1e-3, noslip_eps=1e-2, qn=(0, 0, 100, 100, 100, 0, 10, 10, 10, 10, 10, 10)),
    "kinodynamic": dict(
        q_term_ref=(0, 0, 0.25, 0, 0, 0), foot_ref=(0.2, 0.2, -0.3), rotated_foot_ref=True,
        q_min=(-10, -10, 0.075, -10, -10, -10), q_max=(10, 10, 1.0, 10, 10, 10),
        qd_min=(-10, -10, -10, -40, -40, -40), qd_max=(10, 10, 10, 40, 40, 40),
        q_term_min=(-10, -10, 0.15, -0.1, -0.1, -10), q_term_max=(10, 10, 5, 0.1, 0.1, 10),
        qd_term_min=(-10, -10, -10, -0.5, -0.5, -0.5), qd_term_max=(10, 10, 10, 0.5, 0.5, 0.5),
        mu=0.75, l_leg_max=0.4, f_max=300.0,
        jpos_min=(-math.pi / 3, -math.pi / 2, 0.0), jpos_max=(math.pi / 3, math.pi / 2, 3 * math.pi / 4),
        foot_init=(0.2, 0.15, -0.3), kin_box=(0.125, 0.10, -0.075, -0.4, 0.05),
        tau_max=(18.0, 18.0, 28.0), fk_band=0.01, lcp_eps=1e-3, noslip_eps=1e-3,
        qn=(0, 0, 100, 10, 10, 0, 10, 10, 10, 10, 10, 10)),
}
SRBM_BOX = (0.15, 0.15, 0.30, 0.05)  # x, y, z, z offset (problems/landing.py:128-132)
FRICTION_PYRAMID = 0.71


def _mat(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rot_xyz(rpy):
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr, cp, sp, cy, sy = r.cos(), r.sin(), p.cos(), p.sin(), y.cos(), y.sin()
    return _mat([[cp * cy, -cp * sy, sp],
                 [cr * sy + sr * sp * cy, cr * cy - sr * sp * sy, -sr * cp],
                 [sr * sy - cr * sp * cy, sr * cy + cr * sp * sy, cr * cp]])


def rot_zyx(rpy):
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr, cp, sp, cy, sy = r.cos(), r.sin(), p.cos(), p.sin(), y.cos(), y.sin()
    return _mat([[cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                 [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                 [-sp, cp * sr, cp * cr]])


def binv(rpy):
    t, s = rpy[..., 1], rpy[..., 2]
    cp, sp, ct, tt = s.cos(), s.sin(), t.cos(), t.tan()
    z, o = torch.zeros_like(s), torch.ones_like(s)
    return _mat([[cp / ct, sp / ct, z], [-sp, cp, z], [cp * tt, sp * tt, o]])


def to_tf32(x):
    """x rounded to TF32 (8 exponent bits, 10 mantissa bits; halves away
    from zero), as float32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class Reference:
    """The rows, guesses, scales and violation of one configuration."""

    def __init__(self, cfg: dict, nn_path: str, device="cpu", precision="float64"):
        self.cfg = cfg
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision {precision!r}: float64 or tf32")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64
        self._round = False  # round products' inputs to TF32 (rows and guesses, not scales)
        self.kind = cfg["kind"]
        if self.kind not in PARAMS:
            raise KeyError(f"no reference rows for kind {self.kind!r}")
        self.kino = self.kind == "kinodynamic"
        self.p = PARAMS[self.kind]
        self.n = cfg["n_knots"]
        self.dev = torch.device(device)
        t = lambda v: torch.as_tensor(np.asarray(v, np.float64), device=self.dev).to(self.dtype)  # noqa: E731
        rb = cfg["robot"]
        self.robot = {k: t(rb[k]) for k in ("mass", "ib", "ib_inv")}
        self.hips = t(rb["hip_srbm_location"])
        self.abad = t(np.asarray(FOOT_SIGN, np.float64) * np.asarray(rb["abad_location"]))
        self.links = (rb["l1"], rb["l2"], rb["l3"], rb["knee_link_y_offset"])
        self.t = t
        dt = cfg["theta_overrides"].get("dt")
        if dt is None and self.kino:
            dt = [0.05] + [0.02] * 15 + [0.05, 0.05, 0.1, 0.2]  # landing_optimization.m:28
        self.dt = t(dt) if dt is not None else t(np.full(self.n - 1, self.p["horizon"] / (self.n - 1)))
        self.br = cfg["ip"]["bound_relax_factor"]
        with np.load(nn_path) as d:
            k = int(d["n_layers"])
            self.nn = [(t(d[f"w{i}"]), t(d[f"b{i}"])) for i in range(k)]
            self.nn_stats = {key[6:]: t(d[key]) for key in d.files if key.startswith("stats_")}
        nx, nj = 12 * self.n, (12 if self.kino else 0) * (self.n - 1)
        self.n_vars = nx + nj + 24 * (self.n - 1)
        d = np.concatenate([np.tile([1.0] * 6 + [5.0] * 6, self.n), np.ones(nj),
                            np.tile([1.0] * 12 + [50.0] * 12, self.n - 1)])
        self.z_scale = t(d)

    # ------------------------------------------------------------ products
    def _in(self, a):
        return to_tf32(a) if self._round else a

    def mv(self, M, v):
        """M @ v over the last axes (TF32 inputs where rounding is on)."""
        return (self._in(M) * self._in(v)[..., None, :]).sum(-1)

    def mm(self, A, B):
        """A @ B over the last two axes, broadcast (TF32 inputs where rounding is on)."""
        return (self._in(A)[..., :, :, None] * self._in(B)[..., None, :, :]).sum(-2)

    def xdot(self, x, u, rot):
        """SRBM state derivative (dynamics/srbm.py:47-60)."""
        r, rpy, om, v = x[..., 0:3], x[..., 3:6], x[..., 6:9], x[..., 9:12]
        c = u[..., :12].unflatten(-1, (4, 3))
        f = u[..., 12:].unflatten(-1, (4, 3))
        R = rot(rpy)
        rb = self.robot
        vdot = f.sum(-2) / rb["mass"] + torch.tensor([0.0, 0.0, -G], dtype=x.dtype, device=x.device)
        tau = torch.linalg.cross(c - r[..., None, :], f).sum(-2)
        omdot = rb["ib_inv"] * (self.mv(R.transpose(-1, -2), tau) - torch.linalg.cross(om, rb["ib"] * om))
        rpydot = self.mv(binv(rpy), self.mv(R, om))
        return torch.cat([v, rpydot, omdot, vdot], -1)

    # ------------------------------------------------------------ layout
    def unpack(self, z):
        n, B = self.n, z.shape[0]
        nx, nj = 12 * n, (12 if self.kino else 0) * (n - 1)
        X = z[:, :nx].reshape(B, n, 12)
        jpos = z[:, nx:nx + nj].reshape(B, n - 1, nj // (n - 1) if nj else 0)
        U = z[:, nx + nj:].reshape(B, n - 1, 24)
        return X, jpos, U

    def pack(self, X, jpos, U):
        B = X.shape[0]
        parts = [X.reshape(B, -1)] + ([jpos.reshape(B, -1)] if self.kino else []) + [U.reshape(B, -1)]
        return torch.cat(parts, -1)

    # ------------------------------------------------------------ params
    def params(self, q, qd):
        """The NLP's parameters of B drops (dict of tensors)."""
        p, n, t = self.p, self.n, self.t
        B = q.shape[0]
        w = torch.linspace(0.0, 1.0, n, dtype=q.dtype, device=q.device)[:, None]
        x_ref = torch.cat([q[:, None] * (1 - w) + t(p["q_term_ref"]) * w, qd[:, None] * (1 - w)], -1)
        foot = t(np.asarray(FOOT_SIGN, np.float64) * np.asarray(p["foot_ref"]))
        if p["rotated_foot_ref"]:
            R_ref = rot_xyz(x_ref[:, :-1, 3:6])
            c_knots = (x_ref[:, :-1, None, 0:3] + self.mm(foot, R_ref.transpose(-1, -2))).reshape(B, n - 1, 12)
        else:
            c_knots = x_ref[:, :-1, 0:3].repeat(1, 1, 4) + foot.reshape(12)
        th = {"q": q, "qd": qd, "x_ref": x_ref,
              "u_ref": torch.cat([c_knots, torch.zeros_like(c_knots)], -1)}
        if self.kino:
            R0 = rot_xyz(q[:, 3:6])
            p0 = t(np.asarray(FOOT_SIGN, np.float64) * np.asarray(p["foot_init"]))
            th["c_init"] = (q[:, None, 0:3] + self.mm(p0, R0.transpose(-1, -2))).reshape(B, 12)
            v_body = self.mv(R0.transpose(-1, -2), qd[:, 3:6])
            th["kin_box"] = torch.stack([torch.clamp(v_body[:, 0].abs() * (0.15 / 2.0), max=0.15),
                                         torch.clamp(v_body[:, 1].abs() * (0.25 / 2.0), max=0.25)], -1)
        return th

    # ------------------------------------------------------------ rows
    def cost(self, z, th):
        """Terminal quadratic cost (problems/landing.py:241-251), (B,)."""
        X, _, _ = self.unpack(z)
        err = X[:, -1] - th["x_ref"][:, -1]
        return (self.t(self.p["qn"]) * err * err).sum(-1)

    def cost_grad(self, z, th):
        """d cost / dz of each trajectory, (B, n) (the cost is one per row of z)."""
        return torch.func.grad(lambda zz: self.cost(zz, th).sum())(z)

    def eq(self, z, th):
        X, _, U = self.unpack(z)
        B = z.shape[0]
        parts = [X[:, 0] - torch.cat([th["q"], th["qd"]], -1)]
        if self.kino:
            parts.append(U[:, 0, :12] - th["c_init"])
        rot = rot_xyz if self.kino else rot_zyx
        d = X[:, 1:] - X[:, :-1] - self.xdot(X[:, :-1], U, rot) * self.dt[:, None]
        parts.append(d.reshape(B, -1))
        return torch.cat(parts, -1)

    def ineq(self, z, th):
        X, jpos, U = self.unpack(z)
        p, t = self.p, self.t
        B, K = z.shape[0], self.n - 1
        x = X[:, :-1]
        c = U[..., :12].unflatten(-1, (4, 3))
        f = U[..., 12:].unflatten(-1, (4, 3))
        fz, cz = f[..., 2], c[..., 2]
        c_next = torch.cat([c[:, 1:], c[:, -1:]], 1)
        dc = (c_next - c) * fz[..., None]
        m = (torch.arange(K, device=z.device) < K - 1).to(z.dtype)[None, :, None, None]
        eps = p["noslip_eps"]
        ns_hi = (m * (eps - dc) + (1 - m)).flatten(-2)
        ns_lo = (m * (dc + eps) + (1 - m)).flatten(-2)
        lcp = p["lcp_eps"] - fz * cz
        R = (rot_xyz if self.kino else rot_zyx)(x[..., 3:6])
        p_rel = c - (x[..., None, 0:3] + self.mm(self.hips, R.transpose(-1, -2)))
        px, py, pz = p_rel[..., 0], p_rel[..., 1], p_rel[..., 2]
        leg_len = p["l_leg_max"] ** 2 - (p_rel * p_rel).sum(-1)
        lim = FRICTION_PYRAMID * p["mu"] * fz
        fric = torch.cat([lim - f[..., 0], f[..., 0] + lim, lim - f[..., 1], f[..., 1] + lim], -1)
        if self.kino:
            x0, y0, z_up, z_lo, y_in = p["kin_box"]
            kbx = x0 + th["kin_box"][:, None, 0:1]
            kby = (y0 + th["kin_box"][:, None, 1:2]).expand(B, K, 4)
            right = t(LEG_SIDE) < 0
            y_upper = torch.where(right, torch.full_like(kby, y_in), kby)
            y_lower = torch.where(right, -kby, torch.full_like(kby, -y_in))
            box = torch.cat([kbx - px, px + kbx, y_upper - py, py - y_lower, z_up - pz, pz - z_lo], -1)
            tau = self.leg_torques(jpos, x[..., 3:6], f)
            tau_max = t(p["tau_max"] * 4)
            feet = self.feet_world(x, jpos)
            fk_err = (c - feet).flatten(-2)
            band = p["fk_band"]
            jmin, jmax = t(p["jpos_min"] * 4), t(p["jpos_max"] * 4)
            rows = [fz, cz, lcp, ns_hi, ns_lo, box, leg_len, tau_max - tau, tau + tau_max, fric,
                    x[..., 2:3] - p["q_min"][2], band - fk_err, fk_err + band, jpos - jmin, jmax - jpos]
        else:
            bx, by, bz, boff = SRBM_BOX
            box = torch.cat([bx - px, px + bx, by - py, py + by, -(pz + boff), pz + boff + bz], -1)
            q, qdk = x[..., :6], x[..., 6:]
            state = torch.cat([q - t(p["q_min"]), t(p["q_max"]) - q, qdk - t(p["qd_min"]),
                               t(p["qd_max"]) - qdk], -1)
            rows = [fz, p["f_max"] - fz, cz, lcp, ns_hi, ns_lo, box, leg_len, fric, state]
        xn = X[:, -1]
        term = torch.cat([xn[:, :6] - t(p["q_term_min"]), t(p["q_term_max"]) - xn[:, :6],
                          xn[:, 6:] - t(p["qd_term_min"]), t(p["qd_term_max"]) - xn[:, 6:]], -1)
        return torch.cat([torch.cat(rows, -1).reshape(B, -1), term], -1)

    # ------------------------------------------------------------ legs
    def _trig(self, jpos):
        qj = jpos.unflatten(-1, (4, 3))
        s, c = qj.sin(), qj.cos()
        s1, s2, s3, c1, c2, c3 = s[..., 0], s[..., 1], s[..., 2], c[..., 0], c[..., 1], c[..., 2]
        return s1, s2, c1, c2, s2 * c3 + c2 * s3, c2 * c3 - s2 * s3

    def feet_world(self, x, jpos):
        """World foot positions from the base pose and joint angles (legs.py:49-86)."""
        l1, l2, l3, _ = self.links
        side = self.t(LEG_SIDE)
        s1, s2, c1, c2, s23, c23 = self._trig(jpos)
        leg = l2 * c2 + l3 * c23
        p_hip = torch.stack([l3 * s23 + l2 * s2, side * l1 * c1 + s1 * leg, side * l1 * s1 - c1 * leg], -1)
        R = rot_xyz(x[..., 3:6])
        return x[..., None, 0:3] + self.mv(R[..., None, :, :], self.abad + p_hip)

    def leg_torques(self, jpos, rpy, f):
        """tau = J' (-R_w2b f) per leg (legs.py:89-131)."""
        l1, l2, l3, l4 = self.links
        l14 = l1 + l4
        side = self.t(LEG_SIDE)
        s1, s2, c1, c2, s23, c23 = self._trig(jpos)
        zero = torch.zeros_like(s1)
        J = _mat([[zero, l3 * c23 + l2 * c2, l3 * c23],
                  [l3 * c1 * c23 + l2 * c1 * c2 - l14 * s1 * side, -l3 * s1 * s23 - l2 * s1 * s2,
                   -l3 * s1 * s23],
                  [l3 * s1 * c23 + l2 * c2 * s1 + l14 * side * c1, l3 * c1 * s23 + l2 * c1 * s2,
                   l3 * c1 * s23]])
        R = rot_xyz(rpy)
        f_body = -self.mv(R.transpose(-1, -2)[..., None, :, :], f)
        return self.mv(J.transpose(-1, -2), f_body).flatten(-2)

    # ------------------------------------------------------------ guesses
    def guess(self, name, th):
        return {"ballistic": self.ballistic_guess, "reference": self.reference_guess,
                "nn": self.nn_guess}[name](th)

    def _jpos_home(self, B):
        shape = (B, self.n - 1, 12 if self.kino else 0)
        return self.t(Q_LEG_HOME * 4).expand(shape) if self.kino else torch.zeros(shape, dtype=self.dtype,
                                                                                  device=self.dev)

    def reference_guess(self, th):
        return self.pack(th["x_ref"], self._jpos_home(th["q"].shape[0]), th["u_ref"])

    def ballistic_guess(self, th):
        """warmstart/reference.py:316-371."""
        q0, qd0 = th["q"], th["qd"]
        B, n = q0.shape[0], self.n
        dt = self.dt.expand(B, n - 1)
        t_knot = torch.cat([torch.zeros_like(dt[:, :1]), torch.cumsum(dt, -1)], -1)
        g, z_stand = -9.81, 0.275
        z_b = q0[:, 2:3] + qd0[:, 5:6] * t_knot + 0.5 * g * t_knot ** 2
        vz_b = qd0[:, 5:6] + g * t_knot
        fly = z_b > z_stand
        t_td = torch.where(fly, t_knot, torch.zeros_like(t_knot)).amax(-1, keepdim=True)
        t_end = t_knot[:, -1:]
        wb = torch.clamp((t_knot - t_td) / torch.clamp(t_end - t_td, min=1e-3), 0.0, 1.0)
        t_fl = torch.minimum(t_knot, t_td)[..., None]
        xy = q0[:, None, 0:2] + qd0[:, None, 3:5] * t_fl
        z_tr = torch.where(fly, z_b, torch.full_like(z_b, z_stand))
        rpy = (q0[:, None, 3:6] + qd0[:, None, 0:3] * t_fl) * (1.0 - wb[..., None])
        f3 = fly[..., None]
        v_xy = torch.where(f3, qd0[:, None, 3:5], qd0[:, None, 3:5] * (1 - wb[..., None]))
        v_z = torch.where(fly, vz_b, torch.clamp(vz_b, max=0.0) * (1 - wb))
        om = torch.where(f3, qd0[:, None, 0:3], qd0[:, None, 0:3] * (1 - wb[..., None]))
        X = torch.cat([xy, z_tr[..., None], rpy, om, v_xy, v_z[..., None]], -1)
        R = rot_xyz(rpy[:, :-1])
        feet = X[:, :-1, None, 0:3] + self.mm(self.hips, R.transpose(-1, -2))
        feet = torch.cat([feet[..., :2], torch.zeros_like(feet[..., 2:])], -1)
        stance_k = fly[:, :-1].sum(-1)
        td_feet = feet[torch.arange(B, device=q0.device), torch.clamp(stance_k, max=n - 2)]
        k = torch.arange(n - 1, device=q0.device)
        feet = torch.where((k[None] >= stance_k[:, None])[..., None, None], td_feet[:, None], feet)
        t_stop = torch.clamp(t_end - t_td, min=0.1)
        vz_td = qd0[:, 5:6] + g * t_td
        fz = self.robot["mass"] * (9.81 - vz_td / t_stop) / 4.0
        fz = torch.minimum(torch.clamp(fz, min=1.0), torch.full_like(fz, self.p["f_max"]))
        fz = torch.where(fly[:, :-1], torch.zeros_like(fz), fz)
        grf = torch.cat([torch.zeros(B, n - 1, 4, 2, dtype=fz.dtype, device=fz.device),
                         fz[..., None, None].expand(B, n - 1, 4, 1)], -1)
        U = torch.cat([feet.reshape(B, n - 1, 12), grf.reshape(B, n - 1, 12)], -1)
        return self.pack(X, self._jpos_home(B), U)

    def nn_guess(self, th):
        """The warm-start network's guess (warmstart/nn.py:105-113, 229-281)."""
        st = self.nn_stats
        q, qd = th["q"], th["qd"]
        B, n = q.shape[0], self.n
        h = (torch.cat([q[:, 3:6], qd], -1) - st["mean_input"]) / st["std_input"]
        for i, (w, b) in enumerate(self.nn):
            h = self.mm(h[:, None], w)[:, 0] + b
            if i < len(self.nn) - 1:
                h = torch.relu(h)
        nx, nu, nj = 12 * n, 24 * (n - 1), 12 * (n - 1)
        X = h[:, :nx].reshape(B, n, 12) * st["std_X"] + st["mean_X"]
        U_n = h[:, nx:nx + nu].reshape(B, n - 1, 24)
        jpos = h[:, nx + nu:nx + nu + nj].reshape(B, n - 1, 12) * st["std_jpos"] + st["mean_jpos"]
        td = torch.clamp(torch.round(h[:, nx + nu + nj:]), 0, n - 1).to(torch.int64)
        c = U_n[..., :12] * st["std_c"] + st["mean_c"]
        f_al = (U_n[..., 12:] * (st["mass"] * 9.81)).reshape(B, n - 1, 4, 3)
        idx = torch.arange(n - 1, device=q.device)[None, :, None] - td[:, None, :]
        f = torch.gather(f_al, 1, torch.clamp(idx, 0, n - 2)[..., None].expand(f_al.shape))
        f = torch.where((idx >= 0)[..., None], f, torch.zeros_like(f))
        shift = q[:, 0:2] - X[:, 0, 0:2]
        X = torch.cat([X[..., 0:2] + shift[:, None], X[..., 2:]], -1)
        c = c.reshape(B, n - 1, 4, 3)
        c = torch.cat([c[..., 0:2] + shift[:, None, None], c[..., 2:]], -1).reshape(B, n - 1, 12)
        X = torch.cat([torch.cat([q, qd], -1)[:, None], X[:, 1:]], 1)
        U = torch.cat([c, f.reshape(B, n - 1, 12)], -1)
        return self.pack(X, jpos if self.kino else jpos[..., :0], U)

    # ------------------------------------------------------------ scaling
    def row_scales(self, fn, z0, chunk=128):
        """min(1, 50 / ||d(row)/dz * d||_inf) per row at z0 (B, m), by
        forward-mode columns of the Jacobian."""
        B, n = z0.shape
        best = None
        for c0 in range(0, n, chunk):
            cols = torch.arange(c0, min(n, c0 + chunk), device=z0.device)
            tang = torch.zeros(len(cols), B, n, dtype=z0.dtype, device=z0.device)
            tang[torch.arange(len(cols)), :, cols] = self.z_scale[cols][:, None]
            jc = vmap(lambda v: jvp(fn, (z0,), (v,))[1])(tang).abs().amax(0)
            best = jc if best is None else torch.maximum(best, jc)
        return torch.clamp(G_MAX / torch.clamp(best, min=1e-8), max=1.0)

    def evaluate(self, q, qd, z, variants):
        """The solver's violation of each returned trajectory z (B, n) under
        the scales of each cold-guess family in ``variants``: (violation
        (B, V), the parameters, the scales (f_scale (B, V), eq row scales
        (B, V, m_eq), ineq row scales (B, V, m_ineq)))."""
        q, qd, z = (a.to(self.dtype) for a in (q, qd, z))
        self._round = self.tf32
        th = self.params(q, qd)
        E, g = self.eq(z, th), self.ineq(z, th)
        z0s = [self.guess(name, th) for name in variants]
        self._round = False
        out, fs, se, sg = [], [], [], []
        for z0 in z0s:
            gf = self.cost_grad(z0, th) * self.z_scale
            fs.append(torch.clamp(G_MAX / torch.clamp(gf.abs().amax(-1), min=1e-8), max=1.0))
            se.append(self.row_scales(lambda zz: self.eq(zz, th), z0))
            sg.append(self.row_scales(lambda zz: self.ineq(zz, th), z0))
            out.append(torch.maximum((E * se[-1]).abs().amax(-1),
                                     torch.clamp(-(g * sg[-1] + self.br), min=0.0).amax(-1)))
        return torch.stack(out, -1), th, (torch.stack(fs, -1), torch.stack(se, 1), torch.stack(sg, 1))

    def violation(self, q, qd, z, variants):
        """The solver's violation of each returned trajectory z (B, n) under
        the row scales of each cold-guess family in ``variants``: (B, V)."""
        return self.evaluate(q, qd, z, variants)[0]

    # ------------------------------------------------------------ optimality
    def jacobian(self, fn, z, chunk=128):
        """d fn(z) / dz, (B, m, n), by forward-mode columns."""
        B, n = z.shape
        cols = []
        for c0 in range(0, n, chunk):
            idx = torch.arange(c0, min(n, c0 + chunk), device=z.device)
            tang = torch.zeros(len(idx), B, n, dtype=z.dtype, device=z.device)
            tang[torch.arange(len(idx)), :, idx] = 1.0
            cols.append(vmap(lambda v: jvp(fn, (z,), (v,))[1])(tang))
        return torch.cat(cols, 0).permute(1, 2, 0)

    def optimality(self, z, th, f_scale, eq_scale, ineq_scale, rounds=30, memory=1 << 31):
        """The KKT error of each trajectory z (B, n) at multipliers the
        reference fits itself, in the solver's scaled space (variables over
        ``z_scale``, the cost times f_scale, the rows times their scales):
        max(|dual residual|_inf / s_d, |g_i lam_i|_inf / s_c), as
        solver/ip.py:143-153 defines it with mu = 0, (B,).

        The multipliers minimise |a - G' mu|^2 + sum_i (g_i mu_i)^2 over mu
        with mu_i >= 0 on the inequality rows, where a is the cost's scaled
        gradient, G the scaled rows' Jacobian and g the scaled inequality
        rows (relaxed by the bound relaxation): the least-squares sum of the
        solver's dual residual and complementarity, solved by a primal-dual
        active set (at most ``rounds`` Cholesky solves; multipliers still
        negative then are set to 0).  Any multipliers give an upper bound on
        the best KKT error, so a sound answer reads near the solver's own
        tolerance and one that is not stationary reads high, whatever the
        program's own multipliers were."""
        z = z.to(torch.float64)
        B, n = z.shape
        me = eq_scale.shape[-1]
        m = me + ineq_scale.shape[-1]
        step = max(1, memory // (4 * 8 * m * m))
        if B > step:
            return torch.cat([self.optimality(z[i:i + step], {k: v[i:i + step] for k, v in th.items()},
                                              f_scale[i:i + step], eq_scale[i:i + step],
                                              ineq_scale[i:i + step], rounds, memory)
                              for i in range(0, B, step)])
        d = self.z_scale
        a = f_scale[:, None] * self.cost_grad(z, th) * d
        G = torch.cat([self.jacobian(lambda zz: self.eq(zz, th), z) * eq_scale[..., None],
                       self.jacobian(lambda zz: self.ineq(zz, th), z) * ineq_scale[..., None]], 1) * d
        g = self.ineq(z, th) * ineq_scale + self.br
        K = G @ G.transpose(1, 2)
        rhs = (G @ a[..., None])[..., 0]
        diag = K.diagonal(dim1=1, dim2=2).amax(-1, keepdim=True)
        pen = torch.cat([torch.zeros_like(rhs[:, :me]), g * g], -1)
        # a primal-dual active set: rows held at 0 are those whose
        # multiplier would come out negative or whose gradient pushes it
        # below 0; a held row is solved as a large diagonal
        held = torch.zeros_like(pen, dtype=torch.bool)
        for _ in range(rounds):
            D = torch.where(held, 1e8 * diag, pen) + 1e-11 * diag
            mu = torch.cholesky_solve(rhs[..., None], torch.linalg.cholesky(K + torch.diag_embed(D)))[..., 0]
            mu = torch.where(held, 0.0, mu)
            nu = (K @ mu[..., None])[..., 0] + pen * mu - rhs
            new = torch.where(held, nu > 0, mu < 0)
            new[:, :me] = False
            if bool((new == held).all()):
                break
            held = new
        mu = torch.cat([mu[:, :me], mu[:, me:].clamp(min=0.0)], -1)
        lam = mu[:, me:]
        r = a - (G.transpose(1, 2) @ mu[..., None])[..., 0]
        s_d = torch.clamp(mu.abs().sum(-1) / m, min=100.0) / 100.0
        s_c = torch.clamp(lam.abs().sum(-1) / lam.shape[-1], min=100.0) / 100.0
        return torch.maximum(r.abs().amax(-1) / s_d, (g * lam).abs().amax(-1) / s_c)
