"""Drop conditions of the eeParam (free contact timing) drop sweep.

The distribution is a frozen copy of the port's eeParam tool
(``landing_controller_tpu_torch/tools/eeparam_bench.py:33-44``, after the
JAX package's tools/eeparam_bench.py:68-80): height U(0.45, 0.65), vertical
velocity -U(0.5, 1.5), pitch U(-0.2, 0.2); roll, yaw, the angular velocity
and the horizontal velocity are 0.  A mix's file gives the three ranges
(``height``, ``v_z``, ``pitch``).

As in :mod:`.drops`, the three drawn numbers of drop i are point i of a
Sobol sequence scrambled from the seed and the stream (0 the measured pool,
1 the warm-up's), so every pool is a prefix of a longer one and every
aligned stretch of 64 drops covers the box evenly.  The drops come as the
stream takes them, q = [x, y, z, roll, pitch, yaw] and qd = [omega, v]
(n, 6) float32, computed in float64.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import qmc

DRAWN = ("height", "v_z", "pitch")


def draw(mix: dict, seed: int, n: int, stream: int = 0):
    """n drops of the mix from ``seed`` -> (q (n, 6), qd (n, 6)) float32."""
    gen = np.random.default_rng([int(seed) % 2**64, int(stream)])
    u = qmc.Sobol(d=len(DRAWN), scramble=True, seed=gen).random(1 << max(n - 1, 1).bit_length())[:n]
    lo = np.array([mix[key][0] for key in DRAWN], np.float64)
    hi = np.array([mix[key][1] for key in DRAWN], np.float64)
    h, vz, pitch = (lo + (hi - lo) * u).T
    q = np.zeros((n, 6))
    q[:, 2], q[:, 4] = h, pitch
    qd = np.zeros((n, 6))
    qd[:, 5] = vz
    return q.astype(np.float32), qd.astype(np.float32)
