"""Drop conditions of the landing benchmark.

The one generator of every traffic mix: a mix's file gives the uniform
ranges of the nine drawn numbers, the rule for the initial height, and the
design of the pool; this module turns a seed into the pool.  The
distribution is a frozen copy of the port's two samplers:

- ``bench.py``'s sampler (``landing_controller_tpu_torch/bench.py:38-61``,
  after the JAX package's bench.py:268-283): roll, yaw U(+-0.25), pitch
  U(+-pi/3), omega U(+-0.5), v_xy U(+-1), v_z -U(0.5, 5), a fixed z0 0.6;
- ``sample_drop_scenario`` (``landing_controller_tpu_torch/warmstart/
  reference.py:45-80``, landing_optimization.m:207-218): the same ranges,
  and z0 = 0.35 + |lowest hip's world z| + |dt_0 v_z| under the XYZ
  rotation, dt_0 = 0.05 (``"z0": "hip_clearance"``).

The port's samplers draw column by column over the pool, so a pool of 64 and
one of 512 from one seed hold different drops.  Here the nine numbers of
drop i are point i of a scrambled Sobol sequence in nine dimensions whose
scrambling is drawn from the seed (and the stream: 0 the measured pool, 1
the warm-up's), so:

- every seed hands out drops of its own;
- every pool is a prefix of a longer one, for any number of lanes;
- every aligned stretch of 64 drops covers the box evenly (each of the
  nine numbers takes each sixty-fourth of its range once), so a window
  that harvests the first few hundred drops meets about the same mix of
  easy and hard drops on every seed.

Values are computed in float64 and handed out as float32, the solver's
type; both the program and the reference get these arrays.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import qmc

# the production rule's constants (warmstart/reference.py:24-35)
HIP_SRBM = np.array([[0.19, -0.1, 0.0], [0.19, 0.1, 0.0], [-0.19, -0.1, 0.0], [-0.19, 0.1, 0.0]])
DT0 = 0.05
DRAWN = ("rpy", "omega", "v")


def rot_xyz(rpy):
    """Body-to-world rotation, XYZ convention (rpyToRotMat_xyz.m), (n, 3, 3)."""
    r, p, y = rpy[:, 0], rpy[:, 1], rpy[:, 2]
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    return np.stack([
        np.stack([cp * cy, -cp * sy, sp], -1),
        np.stack([cr * sy + sr * sp * cy, cr * cy - sr * sp * sy, -sr * cp], -1),
        np.stack([sr * sy - cr * sp * cy, sr * cy + cr * sp * sy, cr * cp], -1),
    ], -2)


def draw(mix: dict, seed: int, n: int, stream: int = 0):
    """n drops of the mix from ``seed`` -> (q (n, 6), qd (n, 6)) float32.
    ``stream`` gives independent drops for one seed (0: the measured pool,
    1: the warm-up pool)."""
    gen = np.random.default_rng([int(seed) % 2**64, int(stream)])
    # drawn as a power of two of points, as the sequence is balanced; the
    # first n do not depend on how many are drawn
    u = qmc.Sobol(d=9, scramble=True, seed=gen).random(1 << max(n - 1, 1).bit_length())[:n]
    lo = np.array([r[0] for key in DRAWN for r in mix[key]], np.float64)
    hi = np.array([r[1] for key in DRAWN for r in mix[key]], np.float64)
    w = lo + (hi - lo) * u
    rpy, omega, v = w[:, 0:3], w[:, 3:6], w[:, 6:9]
    if mix["z0"] == "hip_clearance":
        hip_z = np.einsum("lj,nij->nli", HIP_SRBM, rot_xyz(rpy))[..., 2]
        z0 = 0.35 + np.abs(hip_z.min(-1)) + np.abs(DT0 * v[:, 2])
    else:
        z0 = np.full(n, float(mix["z0"]))
    q = np.concatenate([np.zeros((n, 2)), z0[:, None], rpy], 1)
    qd = np.concatenate([omega, v], 1)
    return q.astype(np.float32), qd.astype(np.float32)
