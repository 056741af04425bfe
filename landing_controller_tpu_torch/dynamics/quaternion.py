"""Unit-quaternion and rotation-vector kit, batch-first (spatial_v2/3D/rq.m,
rqd.m, rv.m).

Conventions are spatial_v2's:

- quaternions are scalar-first ``q = [q0, q1, q2, q3]`` (..., 4) and give
  the orientation of frame B relative to frame A;
- ``quat_to_rot(q)`` is the 3x3 coordinate rotation E from A to B
  coordinates: for ``q = [cos(h/2), sin(h/2), 0, 0]`` it equals
  ``rotations.rx(h)`` (rq.m:1-17);
- ``rot_to_quat(E)`` resolves the q / -q ambiguity as rq.m does: q0 > 0,
  ties broken by the largest-magnitude element (rq.m:14-16);
- ``quat_derivative*`` carry rqd.m's magnitude-stabilization term
  (Kstab = 0.1), so that |q| converges to 1 under integration (rqd.m:10-14).

Every function takes leading batch dimensions and has no data-dependent
control flow: Shepperd's four-candidate extraction is a per-lane select.
"""

from __future__ import annotations

import torch

from .rotations import skew

KSTAB = 0.1  # rqd.m magnitude-stabilization constant


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def _mat(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def quat_to_rot(q):
    """Quaternion (..., 4) -> 3x3 coordinate rotation (rq.m qtoE); any
    nonzero quaternion, normalized before use."""
    q = quat_normalize(q)
    q0, q1, q2, q3 = q.unbind(-1)
    return 2.0 * _mat([
        [q0 * q0 + q1 * q1 - 0.5, q1 * q2 + q0 * q3, q3 * q1 - q0 * q2],
        [q1 * q2 - q0 * q3, q0 * q0 + q2 * q2 - 0.5, q2 * q3 + q0 * q1],
        [q3 * q1 + q0 * q2, q2 * q3 - q0 * q1, q0 * q0 + q3 * q3 - 0.5],
    ])


def rot_to_quat(E):
    """3x3 coordinate rotation (..., 3, 3) -> unit quaternion (rq.m Etoq).

    All four candidate formulations are computed and, per lane, the one with
    the largest pivot among {1 + tr, 1 + 2 E[i,i] - tr} is taken (rq.m's
    numerics, well conditioned near a half turn); sign: q0 > 0, and at
    q0 = 0 the largest-magnitude element positive."""
    tr = E[..., 0, 0] + E[..., 1, 1] + E[..., 2, 2]
    # candidate pivots: 4 q0^2 = 1 + tr, 4 qi^2 = 1 + 2 E[i,i] - tr
    p0 = 1.0 + tr
    p1 = 1.0 + 2.0 * E[..., 0, 0] - tr
    p2 = 1.0 + 2.0 * E[..., 1, 1] - tr
    p3 = 1.0 + 2.0 * E[..., 2, 2] - tr
    # E transforms A -> B, so the skew part of E is -2 q0 skew(qv)
    v1 = E[..., 1, 2] - E[..., 2, 1]
    v2 = E[..., 2, 0] - E[..., 0, 2]
    v3 = E[..., 0, 1] - E[..., 1, 0]
    s01 = E[..., 0, 1] + E[..., 1, 0]
    s02 = E[..., 0, 2] + E[..., 2, 0]
    s12 = E[..., 1, 2] + E[..., 2, 1]
    pivots = torch.stack([p0, p1, p2, p3], -1)
    cand = _mat([[p0, v1, v2, v3], [v1, p1, s01, s02], [v2, s01, p2, s12], [v3, s02, s12, p3]])
    cand = cand / torch.sqrt(torch.clamp(pivots, min=1e-30))[..., None]
    idx = torch.argmax(pivots, -1)
    q = torch.take_along_dim(cand, idx[..., None, None].expand(idx.shape + (1, 4)), -2)[..., 0, :]
    big = torch.take_along_dim(q, torch.argmax(q.abs(), -1, keepdim=True), -1)[..., 0]
    pivot = torch.where(q[..., 0].abs() > 1e-12, q[..., 0], big)
    q = q * torch.sign(torch.where(pivot == 0.0, torch.ones_like(pivot), pivot))[..., None]
    return quat_normalize(q)


def _q_matrix_body(q):
    q0, q1, q2, q3 = q.unbind(-1)
    return _mat([[q0, -q1, -q2, -q3], [q1, q0, -q3, q2], [q2, q3, q0, -q1],
                 [q3, -q2, q1, q0]])


def _q_matrix_world(q):
    q0, q1, q2, q3 = q.unbind(-1)
    return _mat([[q0, -q1, -q2, -q3], [q1, q0, q3, -q2], [q2, -q3, q0, q1],
                 [q3, q2, -q1, q0]])


def _qd(Q, q, w):
    wnorm = torch.linalg.vector_norm(w, dim=-1)
    stab = KSTAB * wnorm * (1.0 - torch.linalg.vector_norm(q, dim=-1))
    return 0.5 * (Q @ torch.cat([stab[..., None], w], -1)[..., None])[..., 0]


def quat_derivative(q, w_body):
    """q_dot from the angular velocity of B in B coordinates (rqd.m
    ``rqd(q, wB)``), with magnitude stabilization."""
    return _qd(_q_matrix_body(q), q, w_body)


def quat_derivative_world(w_world, q):
    """q_dot from the angular velocity of B in A coordinates (rqd.m
    ``rqd(wA, q)``)."""
    return _qd(_q_matrix_world(q), q, w_world)


def rotvec_to_rot(v):
    """Rotation vector (..., 3) -> 3x3 coordinate rotation (rv.m vtoE):
    ``E = c 1 - s skew(u) + (1 - c) u u'``, with series limits of sin(t) / t
    and (1 - cos t) / t^2 below t = 1e-8."""
    theta = torch.linalg.vector_norm(v, dim=-1)
    th = torch.clamp(theta, min=1e-30)
    small = theta <= 1e-8
    s_over = torch.where(small, 1.0 - theta * theta / 6.0, torch.sin(th) / th)
    c1_over2 = torch.where(small, 0.5 - theta * theta / 24.0,
                           2.0 * torch.sin(th / 2.0) ** 2 / (th * th))
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return (torch.cos(theta)[..., None, None] * eye - s_over[..., None, None] * skew(v)
            + c1_over2[..., None, None] * (v[..., :, None] * v[..., None, :]))


def rot_to_rotvec(E):
    """3x3 coordinate rotation -> rotation vector of magnitude in [0, pi]
    (rv.m Etov), through the quaternion extraction, which stays well
    conditioned near a half turn where the skew extraction degenerates
    (rv.m:38-49)."""
    q = rot_to_quat(E)
    qv = q[..., 1:]
    n = torch.linalg.vector_norm(qv, dim=-1)
    theta = 2.0 * torch.atan2(n, q[..., 0])
    scale = torch.where(n > 1e-12, theta / torch.clamp(n, min=1e-30), torch.full_like(n, 2.0))
    return scale[..., None] * qv
