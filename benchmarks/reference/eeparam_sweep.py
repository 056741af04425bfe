"""Plain PyTorch reference of ``configs/eeparam_sweep.json``: the phase-based
end-effector landing NLP with free contact timing (quadruped_SRBM_eeParam.m
and its utilities_eeParam/*.m), in float64 (or, as the control of the
comparison that decides ``correct``, in TF32).  It imports nothing of the
program.

From the drops the harness hands to both sides it works out the NLP's
parameters, the cold guess, the variable, cost and row scales, and it
evaluates the cost, every equality and inequality row and the violation the
solver reports at the returned decision vector.  Written from the reference:

- decision vector (the program's layout, row-major): base position and
  Euler-angle polynomials of ``n_base`` segments of ``dt_base`` s, order 5,
  highest power first and over the segment's physical local time (:56-70);
  the phase durations of each leg; per leg a chain of cubic Hermite force
  splines [x0, x0', x1, x1'] (flight, then ``n_force_stance`` in stance) and
  of foot-position splines (``n_posn_swing`` in flight, one in stance)
  (:74-104);
- rows: the flight force spline held at 0 and the stance foot spline held
  still on the ground (structure pins), durations summing to T (:204),
  initial state and gravity as the initial acceleration (:231-238),
  terminal height, attitude and velocity (:241-253), value, rate and
  acceleration continuity of the base segments (:257-283), value and slope
  continuity of each spline chain (:287-305), the SRBM dynamics at the
  collocation times min(k dt, T) (:326-389: body rates from Euler rates by
  the matrix of BmatF.m and its derivative, legacy ZYX rotation); stance
  force bounds and friction at the spline nodes (:188-196), duration
  bounds (:205), the kinematic box and leg length at the collocation times
  (:390-404);
- the drop's set-up (:412-447): r = q[:3], Euler angles q[3:6], rdot =
  qd[3:6], Euler rates Binv(angles) qd[:3];
- the scales (IPOPT's gradient-based scaling, the reference's
  ``nlp_scaling_max_gradient`` 50): no variable scaling, each row and the
  cost times min(1, 50 / |gradient|_inf) at the cold guess; the violation
  max(|scaled equality rows|, the most negative scaled inequality row
  relaxed by ``bound_relax_factor``).

Departures, each the program's as well: the base's angular-velocity
continuity row compares angular rates (the source compares a linear-rate
end value with an angular-rate start, :264); the friction pyramid's lower
sides carry mu (0.71 mu fz, where :194-195 omit it); the cold guess is the
program's ballistic one (the source starts from zeros); a spline's local
time divides by its duration floored at 1e-4; a tiny regularization 1e-8
|z|^2 is the cost of this feasibility problem.

``precision="tf32"`` computes the same in float32 with every matrix-vector
product (the rate matrices, the rotations of vectors and of the hips) taken
with its inputs rounded to TF32, the precision below the configuration's
float32 with TF32 off; the scales are taken in float32 without that
rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmarks.reference.landing import G_MAX, Reference, binv, rot_zyx, to_tf32

GRAVITY = 9.81


def _hermite(h, d, s):
    """Cubic Hermite [x0, x0', x1, x1'] (..., 4) over a spline of duration d
    at the local time s in [0, 1]."""
    s2, s3 = s * s, s * s * s
    return (h[..., 0] * (2 * s3 - 3 * s2 + 1) + d * h[..., 1] * (s3 - 2 * s2 + s)
            + h[..., 2] * (3 * s2 - 2 * s3) + d * h[..., 3] * (s3 - s2))


class EEParamReference:
    """Parameters, cold guess, rows, scales and violation of the eeParam
    configuration; every function takes a leading batch of drops."""

    # d fn(z) / dz by forward-mode columns, as the landing reference takes it
    jacobian = Reference.jacobian

    def __init__(self, cfg: dict, device="cpu", precision="float64"):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision {precision!r}: float64 or tf32")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64
        self._round = False
        self.dev = torch.device(device)
        e = cfg["eeparam"]
        self.T = e["horizon"]
        self.dt, self.db = e["dt_dyn"], e["dt_base"]
        self.n_base = int(round(self.T / self.db))
        self.n_coef = e["order_base"] + 1
        self.n_fs, self.n_ps = e["n_force_stance"], e["n_posn_swing"]
        self.n_colloc = int(round(self.T / self.dt)) + 2
        self.min_phase = e["min_phase"]
        self.kin_box, self.z_off = e["kin_box"], e["kin_box_z_offset"]
        self.reg = e["reg"]
        self.p = cfg["params"]
        self.t = lambda v: torch.as_tensor(np.asarray(v, np.float64), device=self.dev).to(self.dtype)  # noqa: E731
        self.hips = self.t(e["hip_srbm_location"])
        rb = cfg["robot"]
        self.mass, self.ib, self.ib_inv = rb["mass"], self.t(rb["ib"]), self.t(rb["ib_inv"])
        self.br = cfg["ip"]["bound_relax_factor"]
        nf, npn = 1 + self.n_fs, self.n_ps + 1
        self.shapes = {"lin": (self.n_base, 3, self.n_coef), "ang": (self.n_base, 3, self.n_coef),
                       "dur": (4, 2), "force": (4, nf, 3, 4), "posn": (4, npn, 3, 4)}
        self.n_vars = int(sum(np.prod(s) for s in self.shapes.values()))
        self.z_scale = torch.ones(self.n_vars, dtype=self.dtype, device=self.dev)
        k = torch.arange(self.n_colloc, dtype=torch.float64)
        self.ts = torch.clamp(k * self.dt, max=self.T).to(self.dtype).to(self.dev)

    # ------------------------------------------------------------ layout
    def unpack(self, z):
        out, off = {}, 0
        for key, shape in self.shapes.items():
            n = int(np.prod(shape))
            out[key] = z[:, off:off + n].reshape((z.shape[0],) + shape)
            off += n
        return out

    def pack(self, v):
        return torch.cat([v[key].reshape(v[key].shape[0], -1) for key in self.shapes], -1)

    # ------------------------------------------------------------ params
    def params(self, q, qd):
        """The NLP's parameters of B drops (dict of tensors)."""
        B = q.shape[0]
        rpy = q[:, 3:6]
        full = lambda v: self.t(v).to(q.dtype).expand(B, *np.shape(v))  # noqa: E731
        return {"r_init": q[:, 0:3], "theta_init": rpy, "rdot_init": qd[:, 3:6],
                "thetadot_init": (binv(rpy) * qd[:, None, 0:3]).sum(-1),
                "r_des": full(self.p["r_des"]), "theta_des": full(self.p["theta_des"]),
                "mu": full(self.p["mu"]), "l_leg_max": full(self.p["l_leg_max"]),
                "f_max": full(self.p["f_max"])}

    def guess(self, name, th):
        """The cold guess: the ballistic arc down to the target height,
        touchdown as the end of every leg's flight phase, stance forces at
        a quarter of the weight, feet under the hips."""
        if name != "reference":
            raise KeyError(f"guess {name!r}: the eeParam configuration has its one cold guess, 'reference'")
        r0, v0, r_des = th["r_init"], th["rdot_init"], th["r_des"]
        B, dtype = r0.shape[0], r0.dtype
        g, T = GRAVITY, self.T
        drop = torch.clamp(v0[:, 2] ** 2 + 2 * g * (r0[:, 2] - r_des[:, 2]), min=0.0)
        t_td = torch.clamp((v0[:, 2] + drop.sqrt()) / g, min=0.05)
        t_td = torch.minimum(t_td, torch.full_like(t_td, T - 0.05))
        t0 = torch.arange(self.n_base, dtype=dtype, device=r0.device) * self.db  # segment starts
        fly = t0[None] < t_td[:, None]
        lin = torch.zeros(B, self.n_base, 3, self.n_coef, dtype=dtype, device=r0.device)
        lin[..., 0, -1] = r0[:, None, 0]
        lin[..., 1, -1] = r0[:, None, 1]
        z_ball = r0[:, 2:3] + v0[:, 2:3] * t0 - 0.5 * g * t0 ** 2
        lin[..., 2, -1] = torch.where(fly, z_ball, r_des[:, 2:3].expand(B, self.n_base))
        lin[..., 2, -2] = torch.where(fly, v0[:, 2:3] - g * t0, torch.zeros_like(z_ball))
        lin[..., 2, -3] = torch.where(fly, torch.full_like(z_ball, -0.5 * g), torch.zeros_like(z_ball))
        ang = torch.zeros_like(lin)
        ang[..., -1] = th["theta_init"][:, None]
        dur = torch.stack([t_td, T - t_td], -1)[:, None].expand(B, 4, 2)
        force = torch.zeros((B,) + self.shapes["force"], dtype=dtype, device=r0.device)
        force[:, :, 1:, 2, 0] = force[:, :, 1:, 2, 2] = self.mass * GRAVITY / 4
        posn = torch.zeros((B,) + self.shapes["posn"], dtype=dtype, device=r0.device)
        for node in (0, 2):
            posn[:, :, :, 0:2, node] = self.hips[None, :, None, 0:2].to(dtype)
        return self.pack({"lin": lin, "ang": ang, "dur": dur, "force": force, "posn": posn})

    # ------------------------------------------------------------ pieces
    def _in(self, a):
        return to_tf32(a) if self._round else a

    def mv(self, M, v):
        return (self._in(M) * self._in(v)[..., None, :]).sum(-1)

    @staticmethod
    def poly(c, t, deriv=0):
        """d^deriv/dt^deriv of the polynomial c (..., k), highest power first."""
        k = c.shape[-1]
        out = torch.zeros_like(c[..., 0])
        for i in range(k - deriv):
            power = k - 1 - i
            mult = 1.0
            for j in range(deriv):
                mult *= power - j
            out = out + mult * c[..., i] * t ** (power - deriv)
        return out

    def base(self, v, t):
        """Base position, Euler angles and their first two derivatives at the
        times t (T,): six (B, T, 3)."""
        seg = torch.clamp(torch.floor(t / self.db).to(torch.int64), 0, self.n_base - 1)
        tau = (t - seg.to(t.dtype) * self.db)[None, :, None]
        lin, ang = v["lin"][:, seg], v["ang"][:, seg]
        return tuple(self.poly(c, tau, d) for c in (lin, ang) for d in (0, 1, 2))

    def chain(self, coefs, durs, t):
        """Each leg's spline chain at the times t (T,): coefs (B, 4, n, 3, 4),
        durs (B, 4, n) -> (B, T, 4, 3)."""
        B = durs.shape[0]
        start = torch.cat([torch.zeros_like(durs[..., :1]), torch.cumsum(durs, -1)[..., :-1]], -1)
        # the spline whose interval holds t (the source's low()); the last
        # holds every later time
        which = (t[None, :, None, None] >= start[:, None, :, 1:]).sum(-1)  # (B, T, 4)
        b = torch.arange(B, device=durs.device)[:, None, None]
        leg = torch.arange(4, device=durs.device)[None, None, :]
        d = durs[b, leg, which]
        s = (t[None, :, None] - start[b, leg, which]) / torch.clamp(d, min=1e-4)
        return _hermite(coefs[b, leg, which], d[..., None], s[..., None])

    def legs(self, v, t):
        d0, d1 = v["dur"][..., 0:1], v["dur"][..., 1:2]
        fdur = torch.cat([d0] + [d1 / self.n_fs] * self.n_fs, -1)
        pdur = torch.cat([d0 / self.n_ps] * self.n_ps + [d1], -1)
        return self.chain(v["force"], fdur, t), self.chain(v["posn"], pdur, t)

    @staticmethod
    def rate_matrix(ang, rate):
        """World angular velocity from Euler rates (BmatF.m) and its time
        derivative's matrix, at angles ang and rates rate (..., 3)."""
        th, ps = ang[..., 1], ang[..., 2]
        thd, psd = rate[..., 1], rate[..., 2]
        ct, st, cp, sp = th.cos(), th.sin(), ps.cos(), ps.sin()
        zero, one = torch.zeros_like(th), torch.ones_like(th)
        M = torch.stack([torch.stack([cp * ct, -sp, zero], -1),
                         torch.stack([sp * ct, cp, zero], -1),
                         torch.stack([-st, zero, one], -1)], -2)
        # d/dt of each entry, by the chain rule in (theta, psi)
        Md = torch.stack([torch.stack([-sp * psd * ct - cp * st * thd, -cp * psd, zero], -1),
                          torch.stack([cp * psd * ct - sp * st * thd, -sp * psd, zero], -1),
                          torch.stack([-ct * thd, zero, zero], -1)], -2)
        return M, Md

    # ------------------------------------------------------------ rows
    def cost(self, z, th):
        return self.reg * (z * z).sum(-1)

    def cost_grad(self, z, th):
        return 2.0 * self.reg * z

    def eq(self, z, th):
        v = self.unpack(z)
        B = z.shape[0]
        lin, ang, force, posn = v["lin"], v["ang"], v["force"], v["posn"]
        db = self.db
        grav = self.t([0.0, 0.0, -GRAVITY]).to(z.dtype)
        flat = lambda x: x.reshape(B, -1)  # noqa: E731
        stance = posn[:, :, -1]
        rows = [flat(force[:, :, 0]), flat(stance[:, :, 0:2, 1]), flat(stance[:, :, 0:2, 3]),
                flat(stance[:, :, 0:2, 2] - stance[:, :, 0:2, 0]), flat(stance[:, :, 2]),
                v["dur"].sum(-1) - self.T]
        first, last = (lin[:, 0], ang[:, 0]), (lin[:, -1], ang[:, -1])
        rows += [first[0][..., -1] - th["r_init"], first[0][..., -2] - th["rdot_init"],
                 first[1][..., -1] - th["theta_init"], first[1][..., -2] - th["thetadot_init"],
                 2 * first[0][..., -3] - grav]
        rows += [self.poly(last[0], db)[:, 2:3] - th["r_des"][:, 2:3], self.poly(last[1], db) - th["theta_des"],
                 self.poly(last[0], db, 1)]
        for i in range(self.n_base - 1):
            for d in range(3):
                for c in (lin, ang):
                    # derivative d of segment i at its end against segment
                    # i+1 at its start (the coefficient of power d, times d!)
                    rows.append(self.poly(c[:, i], db, d) - [1.0, 1.0, 2.0][d] * c[:, i + 1][..., -1 - d])
        for arr in (force, posn):
            rows.append(flat(arr[:, :, :-1, :, 2] - arr[:, :, 1:, :, 0]))
            rows.append(flat(arr[:, :, :-1, :, 3] - arr[:, :, 1:, :, 1]))
        t = self.ts.to(z.dtype)
        r, rd, rdd, a, ad, add = self.base(v, t)
        f, p = self.legs(v, t)
        M, Md = self.rate_matrix(a, ad)
        om = self.mv(M, ad)
        om_dot = self.mv(Md, ad) + self.mv(M, add)
        Rt = rot_zyx(a).transpose(-1, -2)  # world to body
        acc = f.sum(-2) / self.mass + grav
        tau = torch.linalg.cross(p - r[..., None, :], f, dim=-1).sum(-2)
        om_b = self.mv(Rt, om)
        om_b_dot = self.ib_inv.to(z.dtype) * (self.mv(Rt, tau)
                                              - torch.linalg.cross(om_b, self.ib.to(z.dtype) * om_b, dim=-1))
        rows.append(flat(torch.cat([rdd - acc, self.mv(Rt, om_dot) - om_b_dot], -1)))
        return torch.cat(rows, -1)

    def ineq(self, z, th):
        v = self.unpack(z)
        B = z.shape[0]
        node = v["force"][:, :, 1:]  # stance splines (B, 4, n_fs, 3, 4)
        fz0, fz1, fx0, fy0 = node[..., 2, 0], node[..., 2, 2], node[..., 0, 0], node[..., 1, 0]
        side = 0.71 * th["mu"][:, None, None] * fz0
        rows = [fz0, fz1, th["f_max"][:, None, None] - fz1, side - fx0, fx0 + side, side - fy0, fy0 + side,
                v["dur"] - self.min_phase, self.T - v["dur"]]
        rows = [x.reshape(B, -1) for x in rows]
        t = self.ts.to(z.dtype)
        r, _, _, a, _, _ = self.base(v, t)
        _, p = self.legs(v, t)
        hip_w = self.mv(rot_zyx(a)[..., None, :, :], self.hips.to(z.dtype))  # (B, T, 4, 3)
        rel = p - r[..., None, :] - hip_w
        kx, ky, kz = self.kin_box
        low = rel[..., 2] + self.z_off
        box = torch.stack([kx - rel[..., 0], rel[..., 0] + kx, ky - rel[..., 1], rel[..., 1] + ky, -low,
                           low + kz, th["l_leg_max"][:, None, None] ** 2 - (rel * rel).sum(-1)], -1)
        rows.append(box.reshape(B, -1))
        return torch.cat(rows, -1)

    # ------------------------------------------------------------ scaling
    def row_scales(self, fn, z0):
        """min(1, 50 / |d(row)/dz|_inf) per row at z0 (B, m)."""
        J = self.jacobian(fn, z0)
        return torch.clamp(G_MAX / torch.clamp(J.abs().amax(-1), min=1e-8), max=1.0)

    def evaluate(self, q, qd, z, variants):
        """The solver's violation of each returned z (B, n) under the scales
        of its one cold guess: (violation (B, 1), the parameters, the scales
        (f_scale (B, 1), eq row scales (B, 1, m_eq), ineq row scales
        (B, 1, m_ineq)))."""
        q, qd, z = (a.to(self.dtype) for a in (q, qd, z))
        th = self.params(q, qd)
        self._round = self.tf32
        E, g = self.eq(z, th), self.ineq(z, th)
        self._round = False
        out, fs, se, sg = [], [], [], []
        for name in variants:
            z0 = self.guess(name, th)
            fs.append(torch.clamp(G_MAX / torch.clamp(self.cost_grad(z0, th).abs().amax(-1), min=1e-8), max=1.0))
            se.append(self.row_scales(lambda zz: self.eq(zz, th), z0))
            sg.append(self.row_scales(lambda zz: self.ineq(zz, th), z0))
            out.append(torch.maximum((E * se[-1]).abs().amax(-1),
                                     torch.clamp(-(g * sg[-1] + self.br), min=0.0).amax(-1)))
        return torch.stack(out, -1), th, (torch.stack(fs, -1), torch.stack(se, 1), torch.stack(sg, 1))

    def violation(self, q, qd, z, variants):
        return self.evaluate(q, qd, z, variants)[0]


def make(cfg, device, precision="float64"):
    return EEParamReference(cfg, device, precision)
