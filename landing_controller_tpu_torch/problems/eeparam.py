"""Phase-based end-effector-parametrized landing NLP (free contact timing),
batch-first.

The reference's TOWR-style formulation
(end_effector_parametrization/quadruped_SRBM_eeParam.m:26-409 and
utilities_eeParam/*.m):

- base motion: N_base fixed-duration (0.2 s) segments of 5th-order
  polynomials for position and Euler angles (power basis, highest
  coefficient first, MATLAB ``polyval`` convention);
- per-leg force and foot-position cubic Hermite splines laid out by a static
  contact sequence (default [flight, stance] per leg,
  quadruped_SRBM_eeParam.m:40-44) with 3 force splines per stance phase and
  2 position splines per swing phase;
- **phase durations are decision variables** (sum == T per leg): contact
  timing is optimized;
- SRBM dynamics enforced at fixed collocation times, with world-frame angular
  velocity and acceleration from Euler rates via BmatF / BmatF_dot
  (quadruped_SRBM_eeParam.m:371-372), legacy ZYX rotation convention.

The reference's ``low()`` spline lookup becomes a branch-free selection:
spline start times are smooth functions of the durations, so at each fixed
collocation time every spline of a leg is evaluated and interval-membership
masks pick one (the last interval also holds t == T), with static shapes.

Two apparent slips of the reference are normalized, as in the JAX package:
(a) the base angular-velocity continuity row compares a linear-velocity end
value with an angular-velocity start value (quadruped_SRBM_eeParam.m:264):
the intended angular-velocity continuity is used; (b) the friction pyramid
lower bound omits mu (:194-195): the symmetric 0.71 mu fz bound is used.

Flight force splines and the stance foot-position structure ([x 0 x 0],
z = 0) are equality pins over a uniform coefficient layout, which keeps the
decision vector a fixed-shape array.

Every function takes a leading batch dimension B: z (B, n), and every field
of :class:`EEParamParams` carries the same leading B.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import constant, resolve_device
from ..dynamics.rotations import binv, bmat_f, bmat_f_dot, rpy_to_rot_zyx
from ..models import srbm_constants

__all__ = ["EEParamConfig", "EEParamParams", "EEParamProblem", "EEParamVars",
           "default_eeparam_params", "eeparam_params_from_drops", "eeparam_problem"]


@dataclasses.dataclass(frozen=True)
class EEParamConfig:
    horizon: float = 0.8  # T_val (quadruped_SRBM_eeParam.m:28)
    dt_dyn: float = 0.1  # collocation spacing (:27)
    dt_base: float = 0.2  # base segment duration (:31)
    order_base: int = 5  # base polynomial order (:34)
    n_force_stance: int = 3  # force splines per stance phase (:50)
    n_posn_swing: int = 2  # posn splines per swing phase (:51)
    # default landing sequence: every leg starts in flight, lands once
    # (:40-44) -> per-leg phases [flight, stance]
    n_phases: int = 2
    min_phase: float = 0.01  # (:205)
    kin_box: tuple = (0.05, 0.05, 0.30)
    kin_box_z_offset: float = 0.05
    hip_srbm_location: tuple = (
        (0.19, -0.1, 0.0), (0.19, 0.1, 0.0), (-0.19, -0.1, 0.0), (-0.19, 0.1, 0.0)
    )
    reg: float = 1e-8  # tiny coefficient regularization (pure-feasibility NLP)

    @property
    def n_base(self) -> int:
        return int(round(self.horizon / self.dt_base))

    @property
    def n_colloc(self) -> int:
        return int(round(self.horizon / self.dt_dyn)) + 2  # N_timesteps+1 (:326)

    @property
    def n_force_splines(self) -> int:
        return 1 + self.n_force_stance  # flight (pinned 0) + stance splines

    @property
    def n_posn_splines(self) -> int:
        return self.n_posn_swing + 1  # swing splines + stance spline


@dataclasses.dataclass(frozen=True)
class EEParamParams:
    """Runtime parameters of B drop scenarios (leading dimension B)."""

    r_init: torch.Tensor  # (B, 3)
    rdot_init: torch.Tensor
    theta_init: torch.Tensor
    thetadot_init: torch.Tensor
    r_des: torch.Tensor
    theta_des: torch.Tensor
    horizon: torch.Tensor  # (B,) T
    mu: torch.Tensor  # (B,)
    l_leg_max: torch.Tensor
    f_max: torch.Tensor
    mass: torch.Tensor
    ib: torch.Tensor  # (B, 3)
    ib_inv: torch.Tensor

    @property
    def batch(self) -> int:
        return self.r_init.shape[0]


@dataclasses.dataclass(frozen=True)
class EEParamVars:
    """Structured decision variables (leading batch dimension B)."""

    base_lin: torch.Tensor  # (B, n_base, 3, 6) power coefficients, highest first
    base_ang: torch.Tensor  # (B, n_base, 3, 6)
    durations: torch.Tensor  # (B, 4, n_phases)
    force: torch.Tensor  # (B, 4, n_force_splines, 3, 4) Hermite [x0 x0d x1 x1d]
    posn: torch.Tensor  # (B, 4, n_posn_splines, 3, 4)


def default_eeparam_params(dtype=torch.float32, device="cuda", batch: int = 1) -> EEParamParams:
    """The reference's parameter values (quadruped_SRBM_eeParam.m:412-447)
    for ``batch`` identical scenarios, on the card unless ``device`` says
    otherwise."""
    device = resolve_device(device)
    mass, ib, ib_inv = srbm_constants("mc3D")

    def f(v):
        t = torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype, device=device)
        return t.expand((batch,) + t.shape).clone()

    return EEParamParams(
        r_init=f([0, 0, 0.5]), rdot_init=f([0, 0, -1.0]), theta_init=f([0, 0, 0]),
        thetadot_init=f([0, 0, 0]), r_des=f([0, 0, 0.3]), theta_des=f([0, 0, 0]),
        horizon=f(0.8), mu=f(1.0), l_leg_max=f(0.35), f_max=f(250.0), mass=f(mass),
        ib=f(ib), ib_inv=f(ib_inv),
    )


def eeparam_params_from_drops(q_init, qd_init, horizon: float = 0.8) -> EEParamParams:
    """EEParamParams of B drops given as the stream gives them: q (B, 6)
    [position, roll pitch yaw], qd (B, 6) [world angular velocity, linear
    velocity].  The reference's own set-up (quadruped_SRBM_eeParam.m:412-447):
    r_init = q[:3], theta_init = q[3:6], rdot_init = qd[3:6],
    thetadot_init = binv(theta_init) qd[:3]; the other fields are its
    defaults (:func:`default_eeparam_params`), the horizon the problem's.

    The drops' samplers draw roll, pitch and yaw in the XYZ convention, and
    this problem reads them in the legacy ZYX one: the two agree where only
    pitch is drawn, as in the eeParam drop sweep, and not in general."""
    B = q_init.shape[0]
    theta = default_eeparam_params(q_init.dtype, q_init.device, batch=B)
    rpy = q_init[:, 3:6]
    return dataclasses.replace(
        theta, r_init=q_init[:, 0:3], theta_init=rpy, rdot_init=qd_init[:, 3:6],
        thetadot_init=_mv(binv(rpy), qd_init[:, 0:3]),
        horizon=torch.full((B,), horizon, dtype=q_init.dtype, device=q_init.device))


def _polyval(coefs, t):
    """MATLAB polyval: coefs (..., k) highest order first; t broadcasts
    against coefs[..., 0]."""
    out = torch.zeros_like(coefs[..., 0])
    for i in range(coefs.shape[-1]):
        out = out * t + coefs[..., i]
    return out


def _deriv(coefs):
    """Derivative coefficients (getDerivCoef.m)."""
    order = coefs.shape[-1] - 1
    mult = torch.arange(order, 0, -1, dtype=coefs.dtype, device=coefs.device)
    return coefs[..., :-1] * mult


def _hermite_to_power(h, duration):
    """Hermite [x0, x0d, x1, x1d] (..., 4) -> power [a3 a2 a1 a0]
    (convertHermiteCoef.m:19-23); duration broadcasts against h[..., 0]."""
    x0, x0d, x1, x1d = h[..., 0], h[..., 1], h[..., 2], h[..., 3]
    a2 = -(duration**-2) * (3 * (x0 - x1) + duration * (2 * x0d + x1d))
    a3 = (duration**-3) * (2 * (x0 - x1) + duration * (x0d + x1d))
    return torch.stack([a3, a2, x0d.expand_as(a3), x0.expand_as(a3)], -1)


def _hermite_to_power_tau(h, duration):
    """Hermite -> power coefficients over the normalized time tau = t / d in
    [0, 1]: p(tau) == polyval(_hermite_to_power(h, d), tau d) exactly, but
    every coefficient is O(1) instead of O(d^-3) (the f32-safe form)."""
    x0, x0d, x1, x1d = h[..., 0], h[..., 1], h[..., 2], h[..., 3]
    a1 = duration * x0d
    a2 = -(3 * (x0 - x1) + duration * (2 * x0d + x1d))
    a3 = 2 * (x0 - x1) + duration * (x0d + x1d)
    return torch.stack([a3, a2, a1, x0.expand_as(a3)], -1)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _mv(M, v):
    """M v for batches of 3x3 matrices, as a sum of elementwise products: a
    matmul would run each batch (and its jvp's tangents, over B x n rows) as
    cuBLAS's batched GEMV, which reads 3x3 operands far below the memory
    rate."""
    return (M * v[..., None, :]).sum(-1)


class EEParamProblem:
    """Phase-based landing NLP as (cost, eq, ineq) over flat z (B, n)."""

    def __init__(self, config: EEParamConfig = EEParamConfig()):
        self.config = c = config
        self._shapes = {
            "base_lin": (c.n_base, 3, c.order_base + 1),
            "base_ang": (c.n_base, 3, c.order_base + 1),
            "durations": (4, c.n_phases),
            "force": (4, c.n_force_splines, 3, 4),
            "posn": (4, c.n_posn_splines, 3, 4),
        }
        self.n_vars = int(sum(np.prod(s) for s in self._shapes.values()))
        z = torch.full((1, self.n_vars), 0.1, dtype=torch.float64)
        theta = default_eeparam_params(torch.float64, device="cpu")
        self.n_eq = self.eq(z, theta).shape[-1]
        self.n_ineq = self.ineq(z, theta).shape[-1]

    # ------------------------------------------------------------- packing
    def pack(self, v: EEParamVars):
        B = v.base_lin.shape[0]
        return torch.cat([getattr(v, k).reshape(B, -1) for k in self._shapes], -1)

    def unpack(self, z) -> EEParamVars:
        out, off = {}, 0
        B = z.shape[0]
        for k, s in self._shapes.items():
            n = int(np.prod(s))
            out[k] = z[:, off : off + n].reshape((B,) + s)
            off += n
        return EEParamVars(**out)

    def initial_guess(self, theta: EEParamParams):
        """Ballistic-informed initial guess: the base z polynomials carry the
        ballistic arc until the predicted touchdown, then hold the target
        height, and the phase durations start at the predicted flight time
        instead of T/2.  Branch-free in theta, (B, n)."""
        c = self.config
        dtype, dev = theta.r_init.dtype, theta.r_init.device
        B = theta.batch
        g = torch.tensor(9.81, dtype=dtype, device=dev)
        z0, vz0 = theta.r_init[:, 2], theta.rdot_init[:, 2]
        # touchdown: z0 + vz t - g t^2/2 == r_des_z (clamped into (0, T))
        disc = torch.clamp(vz0 * vz0 + 2.0 * g * (z0 - theta.r_des[:, 2]), min=0.0)
        t_td = torch.minimum(torch.clamp((vz0 + torch.sqrt(disc)) / g, min=0.05),
                             theta.horizon - 0.05)
        db = torch.tensor(c.dt_base, dtype=dtype, device=dev)
        t_seg = torch.arange(c.n_base, dtype=dtype, device=dev) * db  # segment starts
        # ballistic z in physical segment-local time tau:
        #   z(t_seg + tau) = z(t_seg) + (vz0 - g t_seg) tau - g/2 tau^2
        z_at = z0[:, None] + vz0[:, None] * t_seg - 0.5 * g * t_seg * t_seg
        vz_at = vz0[:, None] - g * t_seg
        in_flight = t_seg < t_td[:, None]  # segment starts airborne
        zero = torch.zeros((), dtype=dtype, device=dev)
        base_lin = torch.zeros((B, c.n_base, 3, 6), dtype=dtype, device=dev)
        base_lin[:, :, 2, 5] = torch.where(in_flight, z_at, theta.r_des[:, 2:3])
        base_lin[:, :, 2, 4] = torch.where(in_flight, vz_at, zero)
        base_lin[:, :, 2, 3] = torch.where(in_flight, -0.5 * g, zero)
        # xy: constant at the initial position
        for ax in (0, 1):
            base_lin[:, :, ax, 5] = theta.r_init[:, ax : ax + 1]
        base_ang = torch.zeros((B, c.n_base, 3, 6), dtype=dtype, device=dev)
        base_ang[..., 5] = theta.theta_init[:, None, :]
        # phase durations: [flight ~ t_td, stance = T - t_td] per leg
        durations = torch.stack([t_td[:, None].expand(B, 4), (theta.horizon - t_td)[:, None]
                                 .expand(B, 4)], -1)
        force = torch.zeros((B, 4, c.n_force_splines, 3, 4), dtype=dtype, device=dev)
        # stance force guess: support weight
        fz = theta.mass * 9.81 / 4.0
        force[:, :, 1:, 2, 0] = fz[:, None, None]
        force[:, :, 1:, 2, 2] = fz[:, None, None]
        posn = torch.zeros((B, 4, c.n_posn_splines, 3, 4), dtype=dtype, device=dev)
        hips = torch.tensor(c.hip_srbm_location, dtype=dtype, device=dev)
        for ax in (0, 1):
            posn[:, :, :, ax, 0] = hips[:, ax][:, None]
            posn[:, :, :, ax, 2] = hips[:, ax][:, None]
        return self.pack(EEParamVars(base_lin=base_lin, base_ang=base_ang, durations=durations,
                                     force=force, posn=posn))

    # ------------------------------------------------- spline bookkeeping
    def _spline_durations(self, durations_leg):
        """Spline durations of the force and posn chains of legs
        (..., n_phases): sequence [flight, stance] gives force chain
        [d0, d1/3, d1/3, d1/3] and posn chain [d0/2, d0/2, d1]
        (quadruped_SRBM_eeParam.m:85-104)."""
        c = self.config
        d0, d1 = durations_leg[..., :1], durations_leg[..., 1:2]
        fdur = torch.cat([d0, (d1 / c.n_force_stance).expand(d1.shape[:-1] + (c.n_force_stance,))],
                         -1)
        pdur = torch.cat([(d0 / c.n_posn_swing).expand(d0.shape[:-1] + (c.n_posn_swing,)), d1],
                         -1)
        return fdur, pdur

    def _eval_chain(self, coefs, chain_durs, t):
        """Branch-free spline-chain evaluation at global time t.

        coefs (..., n_splines, 3, 4) Hermite; chain_durs (..., n_splines); t
        broadcasting against the leading dims.  Start times are
        cumsum(durations), smooth in z; the interval masks select the spline
        (the ``low()`` equivalent); the last interval includes its end."""
        starts = torch.cat([torch.zeros_like(chain_durs[..., :1]),
                            torch.cumsum(chain_durs, -1)], -1)
        n = coefs.shape[-3]
        vals = []
        for i in range(n):
            # normalized local time (f32-safe, see _hermite_to_power_tau)
            tl = (t - starts[..., i]) / torch.clamp(chain_durs[..., i], min=1e-4)
            p = _hermite_to_power_tau(coefs[..., i, :, :], chain_durs[..., i, None])  # (..., 3, 4)
            vals.append(_polyval(p, tl[..., None]))
        vals = torch.stack(vals, -2)  # (..., n, 3)
        lo, hi = starts[..., :-1], starts[..., 1:]
        tt = t[..., None]
        in_i = torch.cat([(tt >= lo[..., :-1]) & (tt < hi[..., :-1]), tt >= lo[..., -1:]], -1)
        w = in_i.to(coefs.dtype)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1.0)
        return (w[..., None] * vals).sum(-2)

    def _colloc_times(self, dtype, device):
        """The collocation times min(k dt_dyn, T), k = 0..n_colloc-1, in dtype
        (computed in dtype by numpy, kept on the device)."""
        c = self.config
        np_dtype = np.dtype(str(dtype).removeprefix("torch."))
        ts = np.arange(c.n_colloc, dtype=np_dtype) * np_dtype.type(c.dt_dyn)
        return constant(np.minimum(ts, np_dtype.type(c.horizon)), dtype, device)

    def _base_at_t(self, v: EEParamVars, ts):
        """Base position/orientation and derivatives at the times ts (T,):
        segment by truncated division on the fixed grid; each output
        (B, T, 3)."""
        c = self.config
        idx = torch.clamp((ts / c.dt_base).to(torch.int64), 0, c.n_base - 1)
        tau = ts - idx.to(ts.dtype) * c.dt_base
        return self._base_eval(v.base_lin[:, idx], v.base_ang[:, idx], tau[:, None])

    @staticmethod
    def _base_eval(lin, ang, tau):
        """Coefficients live over the physical local segment time
        tau = t - idx dt_base in [0, dt_base] (quadruped_SRBM_eeParam.m:61-70),
        so polyval of the coefficients and their derivatives gives physical
        values and derivatives directly."""
        return (_polyval(lin, tau), _polyval(_deriv(lin), tau), _polyval(_deriv(_deriv(lin)), tau),
                _polyval(ang, tau), _polyval(_deriv(ang), tau), _polyval(_deriv(_deriv(ang)), tau))

    def _legs_at(self, v: EEParamVars, ts, which: int):
        """Force (which=0) or foot position (1) of every leg at the times ts
        (T,): (B, T, 4, 3)."""
        durs = self._spline_durations(v.durations)[which]  # (B, 4, n)
        coefs = v.force if which == 0 else v.posn
        return self._eval_chain(coefs[:, None], durs[:, None], ts[None, :, None])

    # ------------------------------------------------------------ residuals
    def check_params(self, theta: EEParamParams) -> None:
        """Guard the half-static horizon: the static config horizon fixes the
        base-poly grid and the collocation times (:356, :408) while
        theta.horizon drives the duration-sum equality (:314).  Where they
        disagree on any lane, dynamics would be enforced on the wrong time
        grid: refuse instead."""
        for t in sorted(set(theta.horizon.detach().cpu().reshape(-1).tolist())):
            if abs(t - self.config.horizon) > 1e-6:
                raise ValueError(
                    f"theta.horizon={t} != static config.horizon={self.config.horizon}; "
                    f"rebuild the problem with EEParamConfig(horizon={t}) instead of "
                    "overriding theta"
                )

    def cost(self, z, theta: EEParamParams):
        return self.config.reg * (z * z).sum(-1)

    def eq(self, z, theta: EEParamParams):
        c = self.config
        v = self.unpack(z)
        B = z.shape[0]
        dtype, dev = z.dtype, z.device
        rows = []

        def flat(x):
            return x.reshape(B, -1)

        # structure pins: flight force spline == 0 (spline 0 of each leg)
        rows.append(flat(v.force[:, :, 0]))
        # stance posn spline (last): [x 0 x 0] in x, y; z all zero
        stance = v.posn[:, :, -1]  # (B, 4, 3, 4)
        rows.append(flat(stance[:, :, :2, 1]))  # x0d = 0
        rows.append(flat(stance[:, :, :2, 3]))  # x1d = 0
        rows.append(flat(stance[:, :, :2, 2] - stance[:, :, :2, 0]))  # x1 == x0
        rows.append(flat(stance[:, :, 2]))  # z == 0
        # phase durations sum to T per leg (:204)
        rows.append(v.durations.sum(-1) - theta.horizon[:, None])
        # initial state (:231-238): the constant/linear slots of segment 0
        # are the physical value/derivatives (physical-time basis)
        db = c.dt_base
        lin0, ang0 = v.base_lin[:, 0], v.base_ang[:, 0]
        grav = constant([0.0, 0.0, -9.81], dtype, dev)
        rows.append(lin0[..., 5] - theta.r_init)
        rows.append(_deriv(lin0)[..., 4] - theta.rdot_init)
        rows.append(ang0[..., 5] - theta.theta_init)
        rows.append(_deriv(ang0)[..., 4] - theta.thetadot_init)
        rows.append(_deriv(_deriv(lin0))[..., 3] - grav)  # initial accel = gravity (:238)
        # terminal (:241-253): z position, orientation, zero linear velocity,
        # at local time dt_base (the segment end)
        linN, angN = v.base_lin[:, -1], v.base_ang[:, -1]
        rows.append((_polyval(linN, db)[..., 2] - theta.r_des[:, 2])[:, None])
        rows.append(_polyval(angN, db) - theta.theta_des)
        rows.append(_polyval(_deriv(linN), db))
        # base continuity (:257-283): segment i at local time dt_base
        # against segment i+1's value/derivative slots at local time 0
        for i in range(c.n_base - 1):
            a, b = v.base_lin[:, i], v.base_lin[:, i + 1]
            aa, bb = v.base_ang[:, i], v.base_ang[:, i + 1]
            rows.append(_polyval(a, db) - b[..., 5])
            rows.append(_polyval(aa, db) - bb[..., 5])
            rows.append(_polyval(_deriv(a), db) - _deriv(b)[..., 4])
            # intended angular-velocity continuity (the reference file
            # compares coef_lin against coef_ang here, :264)
            rows.append(_polyval(_deriv(aa), db) - _deriv(bb)[..., 4])
            rows.append(_polyval(_deriv(_deriv(a)), db) - _deriv(_deriv(b))[..., 3])
            rows.append(_polyval(_deriv(_deriv(aa)), db) - _deriv(_deriv(bb))[..., 3])
        # Hermite chain continuity (:287-305): value and derivative
        for arr in (v.force, v.posn):
            prev, nxt = arr[:, :, :-1], arr[:, :, 1:]
            rows.append(flat(prev[..., 2] - nxt[..., 0]))
            rows.append(flat(prev[..., 3] - nxt[..., 1]))
        # dynamics at the collocation times (:326-409)
        ts = self._colloc_times(dtype, dev)
        r, rd, rdd, th, thd, thdd = self._base_at_t(v, ts)  # (B, T, 3)
        Bf = bmat_f(th)
        omega = _mv(Bf, thd)
        omega_dot = _mv(bmat_f_dot(th, thd), thd) + _mv(Bf, thdd)
        R_w2b = rpy_to_rot_zyx(th).transpose(-1, -2)
        fk = self._legs_at(v, ts, 0)  # (B, T, 4, 3)
        pk = self._legs_at(v, ts, 1)
        rddot = fk.sum(-2) / theta.mass[:, None, None] + grav
        tau_w = _cross(pk - r[..., None, :], fk).sum(-2)
        om_b = _mv(R_w2b, omega)
        ib, ib_inv = theta.ib[:, None], theta.ib_inv[:, None]
        omdot = ib_inv * (_mv(R_w2b, tau_w) - _cross(om_b, ib * om_b))
        rows.append(flat(torch.cat([rdd - rddot, _mv(R_w2b, omega_dot) - omdot], -1)))
        return torch.cat(rows, -1)

    def ineq(self, z, theta: EEParamParams):
        c = self.config
        v = self.unpack(z)
        B = z.shape[0]
        # stance force spline endpoint bounds + friction at nodes (:188-196)
        st = v.force[:, :, 1:]  # (B, 4, n_stance, 3, 4)
        fz0, fz1 = st[..., 2, 0], st[..., 2, 2]
        fx0, fy0 = st[..., 0, 0], st[..., 1, 0]
        lim = 0.71 * theta.mu[:, None, None] * fz0
        rows = [fz0, fz1, theta.f_max[:, None, None] - fz1, lim - fx0, fx0 + lim, lim - fy0,
                fy0 + lim]
        rows = [r.reshape(B, -1) for r in rows]
        # phase duration bounds (:205)
        rows.append((v.durations - c.min_phase).reshape(B, -1))
        rows.append((theta.horizon[:, None, None] - v.durations).reshape(B, -1))
        # kinematic boxes at the collocation times (:390-404)
        ts = self._colloc_times(z.dtype, z.device)
        r, _, _, th, _, _ = self._base_at_t(v, ts)
        R_b2w = rpy_to_rot_zyx(th)  # (B, T, 3, 3)
        hips = constant(c.hip_srbm_location, z.dtype, z.device)
        p = self._legs_at(v, ts, 1)  # (B, T, 4, 3)
        p_rel = p - (r[..., None, :] + _mv(R_b2w[..., None, :, :], hips))
        kx, ky, kz = c.kin_box
        zoff = p_rel[..., 2] + c.kin_box_z_offset
        box = torch.stack([kx - p_rel[..., 0], p_rel[..., 0] + kx, ky - p_rel[..., 1],
                           p_rel[..., 1] + ky, -zoff, zoff + kz,
                           theta.l_leg_max[:, None, None] ** 2 - (p_rel * p_rel).sum(-1)], -1)
        rows.append(box.reshape(B, -1))
        return torch.cat(rows, -1)

    def relax_mask(self) -> np.ndarray:
        """No complementarity rows: nothing rides the relaxation homotopy."""
        return np.zeros(self.n_ineq)


def eeparam_problem(config: EEParamConfig | None = None) -> EEParamProblem:
    return EEParamProblem(config or EEParamConfig())
