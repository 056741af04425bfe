"""Featherstone rigid-body algorithms over the quad3D model, batch-first.

FK, CRBA (mass matrix), RNEA (inverse dynamics), articulated-body and hybrid
dynamics, the rotor-augmented H and C, energy and momentum, floating-base
conversions and a joint-PD simulation.  Configurations carry leading batch
dimensions: ``q``, ``qd``, ``qdd``, ``tau`` are ``(..., 18)``, external
forces ``(..., 18, 6)``, and every per-body quantity is ``(..., 6)`` or
``(..., 6, 6)``.  The loops over the 18 bodies are Python loops over the
model's fixed topology; each step is a batched tensor operation, so one call
serves a whole batch.  These are the oracles of the closed-form leg
kinematics in :mod:`.legs` (the reference's own strategy,
test_scripts/test_jacobianApprox.m).

Every joint's motion subspace S is a unit vector e_k (k its joint code), so
``S' f`` is ``f[..., k]``, ``I S`` is ``I[..., :, k]`` and ``S x`` puts x at
position k: the same values as the products with S.

Reference: spatial_v2/dynamics/{jcalc,HandC,ID,FDab,FDcrb,HD,IDfb,EnerMo}.m,
fbkin.m, dynamics-utilities/{get_mass_matrix,get_forward_kin_foot}.m,
dynamicSim.m, dynamics_one_step.m.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import constant, resolve_device
from .rotations import rpy_to_rot_zyx, skew
from .spatial import crf, crm, jcalc, motion_subspace, plux_inv, spatial_inertia


def _mv(M, v):
    """M @ v over the last axes: (..., 6, 6), (..., 6) -> (..., 6)."""
    return (M @ v[..., None])[..., 0]


def _tmv(M, v):
    """M' @ v (a force carried from a child to its parent)."""
    return (M.transpose(-1, -2) @ v[..., None])[..., 0]


def _svec(code, x):
    """S x: the (..., 6) vector of the joint's motion subspace scaled by x (...)."""
    return motion_subspace(code, x.dtype, x.device) * x[..., None]


def _xup(model, T, q, i):
    """Transform from body i's parent, Xup_i = Xj(q_i) @ Xtree_i: (..., 6, 6)."""
    Xj, _ = jcalc(model.jtype[i], q[..., i])
    return Xj @ T.xtree[i]


def _xup_all(model, T, q):
    return [_xup(model, T, q, i) for i in range(model.nb)]


def _stack_entries(entries):
    """A nested list of (...) tensors -> (..., rows, cols)."""
    return torch.stack([torch.stack(row, -1) for row in entries], -2)


def _world_transforms(model, xups):
    x0 = [None] * model.nb
    for i in range(model.nb):
        p = model.parent[i]
        x0[i] = xups[i] if p < 0 else xups[i] @ x0[p]
    return x0


def fk_feet(model, q):
    """World foot positions (..., 4, 3), q = [base 6; joints 12] (..., 18).

    The propagation of get_forward_kin_foot.m:1-26: X0_i = Xup_i X0_parent,
    each foot's position from the Plucker decomposition of
    Xfoot X0_{b_foot}."""
    T = model.tensors(q.dtype, q.device)
    x0 = _world_transforms(model, _xup_all(model, T, q))
    feet = [plux_inv(T.xfoot[leg] @ x0[int(model.b_foot[leg])])[1] for leg in range(model.nlegs)]
    return torch.stack(feet, -2)


def fk_bodies(model, q):
    """World positions (..., nb, 3) and world->body rotations (..., nb, 3, 3)
    of every body origin."""
    T = model.tensors(q.dtype, q.device)
    x0 = _world_transforms(model, _xup_all(model, T, q))
    Es, ps = zip(*(plux_inv(x) for x in x0))
    return torch.stack(ps, -2), torch.stack(Es, -3)


def _floating_base_xup(q):
    """Xup of the lumped floating base of the mass matrix (get_mass_matrix.m:6-11):
    ``[R 0; -R skew(p) R]`` with R the world->body rotation of the legacy ZYX
    convention (rpyToRotMat(q(4:6))')."""
    R_w2b = rpy_to_rot_zyx(q[..., 3:6]).transpose(-1, -2)
    top = torch.cat([R_w2b, torch.zeros_like(R_w2b)], -1)
    bot = torch.cat([-R_w2b @ skew(q[..., :3]), R_w2b], -1)
    return torch.cat([top, bot], -2)


def mass_matrix(model, q):
    """Floating-base CRBA mass matrix H (..., nb, nb) and the 6x6 composite
    inertia Ic = H[..., :6, :6] (..., 6, 6), the whole robot's spatial inertia
    in the body frame (get_mass_matrix.m:1-54: the first 6 coordinates lumped
    into the floating base)."""
    nb = model.nb
    T = model.tensors(q.dtype, q.device)
    xup = [None] * nb
    xup[5] = _floating_base_xup(q)
    for i in range(6, nb):
        xup[i] = _xup(model, T, q, i)
    IC = [T.inertia[i] for i in range(nb)]
    for i in range(nb - 1, 5, -1):
        p = int(model.parent[i])
        IC[p] = IC[p] + xup[i].transpose(-1, -2) @ IC[i] @ xup[i]

    IC5 = IC[5].expand(q.shape[:-1] + (6, 6))
    zero = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)
    H = [[zero] * nb for _ in range(nb)]
    for r in range(6):
        for c in range(6):
            H[r][c] = IC5[..., r, c]
    for i in range(6, nb):
        k = model.jtype[i]
        fh = IC[i][..., :, k].expand(q.shape[:-1] + (6,))
        H[i][i] = fh[..., k]
        fh = _tmv(xup[i], fh)
        j = int(model.parent[i])
        while j > 5:
            H[i][j] = H[j][i] = fh[..., model.jtype[j]]
            fh = _tmv(xup[j], fh)
            j = int(model.parent[j])
        for r in range(6):
            H[r][i] = H[i][r] = fh[..., r]
    H = _stack_entries(H)
    return H, H[..., :6, :6]


def composite_body_inertia(model, q, device="cuda"):
    """6x6 whole-robot spatial inertia at configuration q (body frame), in
    float64.  A tensor q stays on its device; an array goes to ``device``,
    the card unless the caller asks for the CPU."""
    if not torch.is_tensor(q):
        q = torch.as_tensor(np.asarray(q), device=resolve_device(device))
    return mass_matrix(model, q.to(torch.float64))[1]


def _body_frame_ext_forces(model, xup, f_ext_world):
    """World-coordinate spatial forces (..., nb, 6) -> per-body local forces:
    ``f_body_i = Xa_i^-T f_world_i`` with Xa the accumulated world->body
    motion transform (spatial_v2/dynamics/apply_external_forces.m:20-31);
    the forces are [moment about the world origin; linear force]."""
    xa = _world_transforms(model, xup)
    return [torch.linalg.solve(xa[i].transpose(-1, -2), f_ext_world[..., i, :])
            for i in range(model.nb)]


def _feet_wrenches(model, feet, grf_world):
    """World spatial forces (..., nb, 6) of point forces grf_world (..., 4, 3)
    at the world points feet (..., 4, 3): [p x f; f] about the world origin,
    on the body that holds each foot."""
    zero = torch.zeros(grf_world.shape[:-2] + (6,), dtype=grf_world.dtype,
                       device=grf_world.device)
    bodies = [zero] * model.nb
    for leg in range(model.nlegs):
        f = grf_world[..., leg, :]
        wrench = torch.cat([torch.linalg.cross(feet[..., leg, :], f, dim=-1), f], -1)
        b = int(model.b_foot[leg])
        bodies[b] = bodies[b] + wrench
    return torch.stack(bodies, -2)


def foot_forces_to_spatial(model, q, grf_world):
    """World linear GRFs at the feet (..., 4, 3) -> (..., nb, 6) world
    spatial forces: a point force f at the world point p is [p x f; f] about
    the world origin, assigned to the foot's body."""
    grf_world = torch.as_tensor(grf_world, dtype=q.dtype, device=q.device)
    return _feet_wrenches(model, fk_feet(model, q), grf_world)


def rnea(model, q, qd, qdd, f_ext_world=None):
    """Recursive Newton-Euler inverse dynamics tau = ID(q, qd, qdd) (..., nb).

    All 18 coordinates form an open chain from the world (the floating-base
    pseudo-joints carry the base's motion), gravity a base acceleration
    (spatial_v2/dynamics/ID.m; external forces as apply_external_forces.m)."""
    nb = model.nb
    T = model.tensors(q.dtype, q.device)
    v, a, f = [None] * nb, [None] * nb, [None] * nb
    xup = _xup_all(model, T, q)
    for i in range(nb):
        k = model.jtype[i]
        vJ = _svec(k, qd[..., i])
        p = int(model.parent[i])
        if p < 0:
            v[i] = vJ
            a[i] = _mv(xup[i], T.a_grav) + _svec(k, qdd[..., i])
        else:
            v[i] = _mv(xup[i], v[p]) + vJ
            a[i] = _mv(xup[i], a[p]) + _svec(k, qdd[..., i]) + _mv(crm(v[i]), vJ)
        Ii = T.inertia[i]
        f[i] = _mv(Ii, a[i]) + _mv(crf(v[i]), _mv(Ii, v[i]))
    if f_ext_world is not None:
        fx = _body_frame_ext_forces(model, xup, f_ext_world)
        f = [f[i] - fx[i] for i in range(nb)]
    tau = [None] * nb
    for i in range(nb - 1, -1, -1):
        tau[i] = f[i][..., model.jtype[i]]
        p = int(model.parent[i])
        if p >= 0:
            f[p] = f[p] + _tmv(xup[i], f[i])
    return torch.stack(tau, -1)


def crba_open(model, q):
    """CRBA mass matrix (..., nb, nb) over the full 18-coordinate open chain:
    the raw pseudo-joint coordinates, which pair with :func:`rnea` for
    forward dynamics (spatial_v2/dynamics/HandC.m:40-60)."""
    nb = model.nb
    T = model.tensors(q.dtype, q.device)
    xup = _xup_all(model, T, q)
    IC = [T.inertia[i] for i in range(nb)]
    for i in range(nb - 1, 0, -1):
        p = int(model.parent[i])
        IC[p] = IC[p] + xup[i].transpose(-1, -2) @ IC[i] @ xup[i]
    zero = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)
    H = [[zero] * nb for _ in range(nb)]
    for i in range(nb):
        k = model.jtype[i]
        fh = IC[i][..., :, k].expand(q.shape[:-1] + (6,))
        H[i][i] = fh[..., k]
        j = i
        while int(model.parent[j]) >= 0:
            fh = _tmv(xup[j], fh)
            j = int(model.parent[j])
            H[i][j] = H[j][i] = fh[..., model.jtype[j]]
    return _stack_entries(H)


def h_and_c(model, q, qd, f_ext_world=None):
    """Joint-space mass matrix H and bias force C (HandC.m): ``H qdd + C = tau``,
    C holding Coriolis, gravity and minus the external forces; open-chain
    coordinates (pairs with :func:`rnea`)."""
    H = crba_open(model, q)
    C = rnea(model, q, qd, torch.zeros_like(q), f_ext_world=f_ext_world)
    return H, C


def fd_crb(model, q, qd, tau, f_ext_world=None):
    """Forward dynamics by CRBA and RNEA, qdd = H^-1 (tau - C)
    (spatial_v2/dynamics/FDcrb.m): one dense 18x18 solve per configuration."""
    H, C = h_and_c(model, q, qd, f_ext_world=f_ext_world)
    tau = torch.as_tensor(tau, dtype=q.dtype, device=q.device)
    return torch.linalg.solve(H, tau - C)


def _velocities(model, T, xup, qd):
    """Body velocities and velocity-product accelerations c_i = v_i x vJ_i."""
    nb = model.nb
    v, c = [None] * nb, [None] * nb
    for i in range(nb):
        vJ = _svec(model.jtype[i], qd[..., i])
        p = int(model.parent[i])
        if p < 0:
            v[i] = vJ
            c[i] = torch.zeros_like(vJ)
        else:
            v[i] = _mv(xup[i], v[p]) + vJ
            c[i] = _mv(crm(v[i]), vJ)
    return v, c


def fd_ab(model, q, qd, tau, f_ext_world=None):
    """Articulated-body forward dynamics (spatial_v2/dynamics/FDab.m:1-60),
    O(n) in the bodies: velocities and velocity-product terms root to tip,
    articulated inertias IA and bias forces pA tip to root, accelerations
    root to tip.  Returns qdd (..., nb)."""
    nb = model.nb
    T = model.tensors(q.dtype, q.device)
    tau = torch.as_tensor(tau, dtype=q.dtype, device=q.device)
    xup = _xup_all(model, T, q)
    v, c = _velocities(model, T, xup, qd)
    IA = [T.inertia[i] for i in range(nb)]
    pA = [_mv(crf(v[i]), _mv(IA[i], v[i])) for i in range(nb)]
    if f_ext_world is not None:
        fx = _body_frame_ext_forces(model, xup, f_ext_world)
        pA = [pA[i] - fx[i] for i in range(nb)]

    U, d, u = [None] * nb, [None] * nb, [None] * nb
    for i in range(nb - 1, -1, -1):
        k = model.jtype[i]
        U[i] = IA[i][..., :, k]
        d[i] = U[i][..., k]
        u[i] = tau[..., i] - pA[i][..., k]
        p = int(model.parent[i])
        if p >= 0:
            Ia = IA[i] - U[i][..., :, None] * U[i][..., None, :] / d[i][..., None, None]
            pa = pA[i] + _mv(Ia, c[i]) + U[i] * (u[i] / d[i])[..., None]
            IA[p] = IA[p] + xup[i].transpose(-1, -2) @ Ia @ xup[i]
            pA[p] = pA[p] + _tmv(xup[i], pa)

    qdd, a = [None] * nb, [None] * nb
    for i in range(nb):
        p = int(model.parent[i])
        ai = _mv(xup[i], T.a_grav if p < 0 else a[p]) + c[i]
        qdd[i] = (u[i] - (U[i] * ai).sum(-1)) / d[i]
        a[i] = ai + _svec(model.jtype[i], qdd[i])
    return torch.stack(qdd, -1)


def energy_momentum(model, q, qd):
    """Kinetic and potential energy and world-frame spatial momentum
    (spatial_v2/dynamics/EnerMo.m): a dict of ``ke`` (...), ``pe`` (zero at
    the z = 0 plane), ``mass``, ``com`` (..., 3) (world CoM) and ``htot``
    (..., 6) (spatial momentum about the world origin, [angular; linear])."""
    nb = model.nb
    T = model.tensors(q.dtype, q.device)
    xup = _xup_all(model, T, q)
    v, _ = _velocities(model, T, xup, qd)
    xa = _world_transforms(model, xup)
    ke, htot, m_com, m_tot = 0.0, 0.0, 0.0, 0.0
    for i in range(nb):
        Ii = T.inertia[i]
        hi = _mv(Ii, v[i])
        ke = ke + 0.5 * (v[i] * hi).sum(-1)
        htot = htot + _tmv(xa[i], hi)  # momentum transforms like force
        mi = float(model.inertia[i][5, 5])
        E, r = plux_inv(xa[i])
        com_body = torch.stack([Ii[2, 4], Ii[0, 5], Ii[1, 3]]) / (mi if mi > 0 else 1.0)
        m_tot = m_tot + mi
        m_com = m_com + mi * (r + _tmv(E, com_body))
    com = m_com / m_tot
    pe = -m_tot * (com * T.gravity).sum(-1)
    mass = torch.full(q.shape[:-1], m_tot, dtype=q.dtype, device=q.device)
    return {"ke": ke, "pe": pe, "mass": mass, "com": com, "htot": htot}


def joint_pd_sim(model, q0, qd0, jpos_des, jvel_des, kp, kd, dt, n_steps: int,
                 ground_k: float = 5e3, ground_d: float = 50.0, mu: float = 0.7,
                 tau_limit=None):
    """Full-model joint-PD simulation with spring-damper ground contact
    (the analogue of dynamics-utilities/dynamicSim.m).

    Each step: tau = PD on the 12 joints toward (jpos_des, jvel_des), clipped
    to tau_limit; at each foot a penalty contact (normal spring-damper,
    Coulomb-clipped tangential damping) from the feet's positions and
    velocities (the foot Jacobian by ``torch.func.jacfwd`` of :func:`fk_feet`,
    vmapped over the batch); forward dynamics by :func:`fd_ab`; semi-implicit
    Euler.  q0, qd0: (..., 18); jpos_des, jvel_des: (..., n_steps, 12), or
    (12,) / (n_steps, 12) for every lane.  Returns qs (..., n_steps+1, 18),
    qds (..., n_steps+1, 18), grfs (..., n_steps, 4, 3).
    """
    dtype, dev = q0.dtype, q0.device
    batch = q0.shape[:-1]
    jpos_des = torch.as_tensor(jpos_des, dtype=dtype, device=dev).expand(batch + (n_steps, 12))
    jvel_des = torch.as_tensor(jvel_des, dtype=dtype, device=dev).expand(batch + (n_steps, 12))
    kp = torch.as_tensor(kp, dtype=dtype, device=dev)
    kd = torch.as_tensor(kd, dtype=dtype, device=dev)
    lim = None if tau_limit is None else torch.as_tensor(tau_limit, dtype=dtype, device=dev)
    foot_jac = torch.func.vmap(torch.func.jacfwd(lambda qq: fk_feet(model, qq)))

    def contact_forces(q, qd):
        feet = fk_feet(model, q)  # (..., 4, 3)
        Jf = foot_jac(q.reshape(-1, model.nb)).reshape(batch + (model.nlegs, 3, model.nb))
        vf = (Jf @ qd[..., None, :, None])[..., 0]  # (..., 4, 3)
        z = feet[..., 2]
        active = z < 0.0
        zero = torch.zeros_like(z)
        fz = torch.where(active, ground_k * torch.clamp(-z, min=0.0) - ground_d * vf[..., 2], zero)
        fz = torch.clamp(fz, min=0.0)
        ft = torch.where(active[..., None], -ground_d * vf[..., :2], torch.zeros_like(vf[..., :2]))
        ft_norm = torch.linalg.vector_norm(ft, dim=-1, keepdim=True)
        scale = torch.clamp(mu * fz[..., None] / torch.clamp(ft_norm, min=1e-9), max=1.0)
        return feet, torch.cat([ft * scale, fz[..., None]], -1)

    q, qd = q0, qd0
    qs, qds, grfs = [q0], [qd0], []
    zeros6 = torch.zeros(batch + (6,), dtype=dtype, device=dev)
    for step in range(n_steps):
        tau_j = kp * (jpos_des[..., step, :] - q[..., 6:]) + kd * (jvel_des[..., step, :] - qd[..., 6:])
        if lim is not None:
            tau_j = torch.clamp(tau_j, -lim, lim)
        feet, grf = contact_forces(q, qd)
        qdd = fd_ab(model, q, qd, torch.cat([zeros6, tau_j], -1),
                    f_ext_world=_feet_wrenches(model, feet, grf))
        qd = qd + dt * qdd
        q = q + dt * qd
        qs.append(q)
        qds.append(qd)
        grfs.append(grf)
    return torch.stack(qs, -2), torch.stack(qds, -2), torch.stack(grfs, -3)


# ----------------------------------------------------------------------
# rotor (actuator) reflection: dynamics_one_step.m / add_rotors.m
# ----------------------------------------------------------------------

class RotorModel:
    """Geared-rotor set for reflected actuator dynamics (get_rotor_model.m's
    rotor_model struct): rotor k rides on body ``mu[k]`` (the geared joint's
    parent) at transform ``x_mu[k]`` and spins at ``gr[k]`` times joint
    ``gamma[k]``'s rate about that joint's axis; ``inertia[k]`` is its 6x6
    spatial inertia (mass and rotational).  Host-side numpy float64."""

    def __init__(self, gamma, gr, inertia, x_mu):
        self.nr = len(gamma)
        self.gamma = np.asarray(gamma, np.int64)
        self.gr = np.asarray(gr, np.float64)
        self.inertia = np.asarray(inertia, np.float64)  # (nr, 6, 6)
        self.x_mu = np.asarray(x_mu, np.float64)  # (nr, 6, 6)

    def tensors(self, dtype, device):
        """(inertia, x_mu) as tensors of dtype on device, made once per pair."""
        return constant(self.inertia, dtype, device), constant(self.x_mu, dtype, device)


def quad3d_rotor_model(model, robot_params, rotor_inertia_axial, rotor_mass=0.0):
    """One rotor per actuated joint of the quad3D tree (12 rotors).

    get_rotor_model.m's construction (published there only for the planar
    'c3' robot) applied to the 18-body tree: each actuated joint's rotor sits
    at the joint origin on the parent body (X_mu = 1), spins about the
    joint's axis with its gear ratio (mc3D: 6 / 6 / 9.33) and carries the
    rotational inertia ``rotor_inertia_axial`` on each axis (the actuator's
    datasheet value); only S' I S of it enters the reflected inertia."""
    gears = [robot_params.abad_gear_ratio, robot_params.hip_gear_ratio,
             robot_params.knee_gear_ratio]
    inertia = spatial_inertia(
        torch.tensor(float(rotor_mass), dtype=torch.float64), torch.zeros(3, dtype=torch.float64),
        torch.eye(3, dtype=torch.float64) * rotor_inertia_axial).numpy()
    gamma, gr, inertias, x_mu = [], [], [], []
    for leg in range(4):  # actuated joints are bodies 6..17 (abad, hip, knee)
        for j in range(3):
            gamma.append(6 + 3 * leg + j)
            gr.append(gears[j])
            inertias.append(inertia.copy())
            x_mu.append(np.eye(6))
    return RotorModel(gamma, gr, inertias, x_mu)


def h_and_c_rotors(model, rotors: RotorModel, q, qd):
    """Mass matrix H (..., nb, nb) and bias C (..., nb) with geared-rotor
    reflection (dynamics_one_step.m:14-100).  Per rotor k geared to joint
    i = gamma[k] on parent p:

    - ``H[i,i] += gr^2 S_i' I_r S_i`` (reflected inertia);
    - ``H[i,j] += S_j' (X' gr I_r S_i)`` for ancestors j (the rotor's
      reaction path);
    - ``C[i] += gr S_i' f_k``, f_k the rotor's velocity-product and gravity
      force, which also loads the parent body;
    - the rotor's inertia joins the parent's composite inertia.

    Deliberate deviation from dynamics_one_step.m: its LOOP 4 overwrites
    H(i,i) = S' Ic S and so drops LOOP 2's gr^2 reflected-inertia term;
    add_rotors.m's dH section shows that += is the physical intent, which
    this function keeps (the reference's numeric H differs on the actuated
    joints' diagonal: the reference's bug)."""
    nb = model.nb
    T = model.tensors(q.dtype, q.device)
    batch = q.shape[:-1]
    xup = _xup_all(model, T, q)
    # forward pass: velocities and zero-qdd accelerations, as rnea(qdd = 0)
    v, avp, fvp = [None] * nb, [None] * nb, [None] * nb
    for i in range(nb):
        vJ = _svec(model.jtype[i], qd[..., i])
        p = int(model.parent[i])
        if p < 0:
            v[i] = vJ
            avp[i] = _mv(xup[i], T.a_grav)
        else:
            v[i] = _mv(xup[i], v[p]) + vJ
            avp[i] = _mv(xup[i], avp[p]) + _mv(crm(v[i]), vJ)
        Ii = T.inertia[i]
        fvp[i] = _mv(Ii, avp[i]) + _mv(crf(v[i]), _mv(Ii, v[i]))

    IC = [T.inertia[i] for i in range(nb)]
    rotor_inertia, rotor_x_mu = rotors.tensors(q.dtype, q.device)
    zero = torch.zeros(batch, dtype=q.dtype, device=q.device)
    H = [[zero] * nb for _ in range(nb)]
    C = [zero] * nb
    b_rot = [torch.zeros(batch + (6,), dtype=q.dtype, device=q.device)] * nb

    # rotor pass (dynamics_one_step.m LOOP 2)
    for k in range(rotors.nr):
        i = int(rotors.gamma[k])
        p = int(model.parent[i])
        code = model.jtype[i]
        grk = float(rotors.gr[k])
        Irk = rotor_inertia[k]
        Xj, _ = jcalc(code, q[..., i])
        xup_r = Xj @ rotor_x_mu[k]
        H[i][i] = H[i][i] + grk * grk * Irk[code, code]
        b_rot[i] = b_rot[i] + grk * Irk[:, code]
        vJ = grk * _svec(code, qd[..., i])
        if p < 0:
            fk = torch.zeros(batch + (6,), dtype=q.dtype, device=q.device)
        else:
            vk = _mv(xup_r, v[p])
            ak = _mv(xup_r, avp[p]) + _mv(crm(vk), vJ)
            fk = _mv(Irk, ak) + _mv(crf(vk), _mv(Irk, vJ))
            fvp[p] = fvp[p] + _tmv(xup_r, fk)
            IC[p] = IC[p] + xup_r.transpose(-1, -2) @ Irk @ xup_r
        C[i] = C[i] + grk * fk[..., code]

    # backward pass: bias torques and composite inertias (LOOP 3)
    for i in range(nb - 1, -1, -1):
        C[i] = C[i] + fvp[i][..., model.jtype[i]]
        p = int(model.parent[i])
        if p >= 0:
            fvp[p] = fvp[p] + _tmv(xup[i], fvp[i])
            IC[p] = IC[p] + xup[i].transpose(-1, -2) @ IC[i] @ xup[i]

    # CRBA with the rotors' off-diagonal reaction path (LOOP 4)
    for i in range(nb):
        code = model.jtype[i]
        fh = IC[i][..., :, code].expand(batch + (6,))
        H[i][i] = H[i][i] + fh[..., code]
        br = b_rot[i]
        j = i
        while int(model.parent[j]) >= 0:
            fh = _tmv(xup[j], fh)
            br = _tmv(xup[j], br)
            j = int(model.parent[j])
            hij = (fh + br)[..., model.jtype[j]]
            H[i][j] = H[i][j] + hij
            H[j][i] = H[j][i] + hij
    return _stack_entries(H), torch.stack(C, -1)


# ----------------------------------------------------------------------
# hybrid dynamics and floating-base helpers: spatial_v2 HD.m / IDfb.m / fbkin.m
# ----------------------------------------------------------------------

def hybrid_dynamics(model, fd, q, qd, qdd, tau, f_ext_world=None):
    """Articulated-body hybrid dynamics (spatial_v2/dynamics/HD.m).

    ``fd`` is a static tuple of booleans: fd[i] marks joint i a
    forward-dynamics joint (tau[i] given, qdd[i] computed), otherwise it is
    prescribed (qdd[i] given, tau[i] computed).  Returns (qdd_out, tau_out),
    both (..., nb) and fully populated."""
    nb = model.nb
    fd = tuple(bool(b) for b in fd)
    assert len(fd) == nb
    T = model.tensors(q.dtype, q.device)
    xup = _xup_all(model, T, q)
    v, c = _velocities(model, T, xup, qd)
    c = [c[i] if fd[i] else c[i] + _svec(model.jtype[i], qdd[..., i]) for i in range(nb)]
    IA = [T.inertia[i] for i in range(nb)]
    pA = [_mv(crf(v[i]), _mv(IA[i], v[i])) for i in range(nb)]
    if f_ext_world is not None:
        fx = _body_frame_ext_forces(model, xup, f_ext_world)
        pA = [pA[i] - fx[i] for i in range(nb)]

    U, d, u = [None] * nb, [None] * nb, [None] * nb
    for i in range(nb - 1, -1, -1):
        p = int(model.parent[i])
        k = model.jtype[i]
        if not fd[i]:
            if p >= 0:
                pa = pA[i] + _mv(IA[i], c[i])
                IA[p] = IA[p] + xup[i].transpose(-1, -2) @ IA[i] @ xup[i]
                pA[p] = pA[p] + _tmv(xup[i], pa)
        else:
            U[i] = IA[i][..., :, k]
            d[i] = U[i][..., k]
            u[i] = tau[..., i] - pA[i][..., k]
            if p >= 0:
                Ia = IA[i] - U[i][..., :, None] * U[i][..., None, :] / d[i][..., None, None]
                pa = pA[i] + _mv(Ia, c[i]) + U[i] * (u[i] / d[i])[..., None]
                IA[p] = IA[p] + xup[i].transpose(-1, -2) @ Ia @ xup[i]
                pA[p] = pA[p] + _tmv(xup[i], pa)

    qdd_out, tau_out, a = [None] * nb, [None] * nb, [None] * nb
    for i in range(nb):
        p = int(model.parent[i])
        k = model.jtype[i]
        a[i] = _mv(xup[i], T.a_grav if p < 0 else a[p]) + c[i]
        if not fd[i]:
            qdd_out[i] = qdd[..., i]
            tau_out[i] = (_mv(IA[i], a[i]) + pA[i])[..., k]
        else:
            qdd_i = (u[i] - (U[i] * a[i]).sum(-1)) / d[i]
            qdd_out[i] = qdd_i
            tau_out[i] = tau[..., i]
            a[i] = a[i] + _svec(k, qdd_i)
    return torch.stack(qdd_out, -1), torch.stack(tau_out, -1)


def id_floating_base(model, q, qd, qdd_joints, f_ext_world=None):
    """Floating-base inverse dynamics (spatial_v2/dynamics/IDfb.m): from the
    12 actuated joints' accelerations, their torques and the free base's
    acceleration, as hybrid dynamics with the 6 base pseudo-joints
    forward-dynamics joints under zero force and the actuated joints
    prescribed (IDfb.m:3-6).  The base stays in the model's 6 pseudo-joint
    coordinates (:func:`fbkin_fwd` / :func:`fbkin_inv` convert).  Returns
    (qdd_base (..., 6), tau_joints (..., 12))."""
    nb = model.nb
    fd = (True,) * 6 + (False,) * (nb - 6)
    qdd_joints = torch.as_tensor(qdd_joints, dtype=q.dtype, device=q.device)
    qdd = torch.cat([torch.zeros(qdd_joints.shape[:-1] + (6,), dtype=q.dtype, device=q.device),
                     qdd_joints], -1)
    qdd_out, tau_out = hybrid_dynamics(model, fd, q, qd, qdd, torch.zeros_like(qdd),
                                       f_ext_world=f_ext_world)
    return qdd_out[..., :6], tau_out[..., 6:]


def _euler_rate_map(c4, s4, c5, s5):
    """Euler-rate -> world angular velocity map of fbkin.m:67-70, (..., 3, 3)."""
    o, z = torch.ones_like(c4), torch.zeros_like(c4)
    return torch.stack([torch.stack([o, z, s5], -1), torch.stack([z, c4, -s4 * c5], -1),
                        torch.stack([z, s4, c4 * c5], -1)], -2)


def fbkin_fwd(q6, qd6=None):
    """Floating-base coordinates -> singularity-free state (fbkin.m fwdkin).

    q6 (..., 6) = [x, y, z, rx, ry, rz] (the model's 6 floating pseudo-joint
    coordinates).  Returns p = [quat (4); r (3)] (..., 7), or with qd6
    x = [quat; r; v_spatial (6)] (..., 13), v_spatial the base's spatial
    velocity in fixed-base coordinates: fbkin.m's layout."""
    from .quaternion import rot_to_quat

    c4, s4 = torch.cos(q6[..., 3]), torch.sin(q6[..., 3])
    c5, s5 = torch.cos(q6[..., 4]), torch.sin(q6[..., 4])
    c6, s6 = torch.cos(q6[..., 5]), torch.sin(q6[..., 5])
    E = torch.stack([
        torch.stack([c5 * c6, c4 * s6 + s4 * s5 * c6, s4 * s6 - c4 * s5 * c6], -1),
        torch.stack([-c5 * s6, c4 * c6 - s4 * s5 * s6, s4 * c6 + c4 * s5 * s6], -1),
        torch.stack([s5, -s4 * c5, c4 * c5], -1),
    ], -2)
    r = q6[..., 0:3]
    p = torch.cat([rot_to_quat(E), r], -1)
    if qd6 is None:
        return p
    omega = (_euler_rate_map(c4, s4, c5, s5) @ qd6[..., 3:6, None])[..., 0]
    v = torch.cat([omega, qd6[..., 0:3] + torch.linalg.cross(r, omega, dim=-1)], -1)
    return torch.cat([p, v], -1)


def fbkin_inv(x):
    """Singularity-free state -> floating-base coordinates (fbkin.m invkin).

    x: p (..., 7) -> q6, or x (..., 13) -> (q6, qd6).  q6[4] lies in
    [-pi/2, pi/2], q6[3] and q6[5] in [-pi, pi] (fbkin.m:20-22).  Near the
    gimbal lock only q4 + q6 (or q4 - q6) is determined, so q4 comes from the
    well-conditioned combined-angle atan2 (E[1,2] + E[0,1] = (1 + s5)
    sin(q4 + q6), E[1,1] - E[0,2] = (1 + s5) cos(q4 + q6), and the (1 - s5)
    difference pair) minus or plus q6, wrapped to [-pi, pi]; the rates
    remain singular at q6[4] = +-pi/2, as in the reference."""
    from .quaternion import quat_to_rot

    E = quat_to_rot(x[..., 0:4])
    r = x[..., 4:7]
    q5 = torch.atan2(E[..., 2, 0], torch.sqrt(E[..., 0, 0] ** 2 + E[..., 1, 0] ** 2))
    q6 = torch.atan2(-E[..., 1, 0], E[..., 0, 0])
    sum46 = torch.atan2(E[..., 1, 2] + E[..., 0, 1], E[..., 1, 1] - E[..., 0, 2])  # q4 + q6
    diff46 = torch.atan2(E[..., 1, 2] - E[..., 0, 1], E[..., 1, 1] + E[..., 0, 2])  # q4 - q6

    def wrap(a):
        return torch.remainder(a + math.pi, 2 * math.pi) - math.pi

    q4 = torch.where(E[..., 2, 0] >= 0, wrap(sum46 - q6), wrap(diff46 + q6))
    q = torch.cat([r, torch.stack([q4, q5, q6], -1)], -1)
    if x.shape[-1] == 7:
        return q
    omega = x[..., 7:10]
    rd = x[..., 10:13] - torch.linalg.cross(r, omega, dim=-1)
    Smat = _euler_rate_map(torch.cos(q4), torch.sin(q4), torch.cos(q5), torch.sin(q5))
    euler_rates = torch.linalg.solve(Smat, omega)
    return q, torch.cat([rd, euler_rates], -1)
