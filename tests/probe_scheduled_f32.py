"""contact_scheduled in f32 at N = 21 under tiny changes of the scenario.

    JAX_PLATFORMS=cpu python tests/probe_scheduled_f32.py

Not a test (about two minutes on the CPU): the scenario of
tests/test_scheduled.py and seven copies of it changed by 1e-6 relative
(numpy seed 0) go through the JAX package's ``solve_batch`` (``cri_ref``) and
the port's (CPU, plain versions), 80 iterations at most.  Both packages
scatter between 19 and more than 80 iterations, which is why
tests/test_torch_scheduled_f32.py holds the first three iterations and the
f64 histories and not the f32 outcome.
"""

import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from landing_controller_tpu.api import LandingSolver as JaxLandingSolver  # noqa: E402
from landing_controller_tpu_torch.api import LandingSolver  # noqa: E402

Q0 = np.array([0.0, 0.0, 0.26, 0.03, 0.1, -0.02], np.float32)
QD0 = np.array([0.1, -0.05, 0.0, 0.05, -0.05, -0.8], np.float32)


def main():
    rng = np.random.default_rng(0)
    lanes = 8
    q, qd = np.tile(Q0, (lanes, 1)), np.tile(QD0, (lanes, 1))
    q[1:, 2:] *= (1 + 1e-6 * rng.standard_normal((lanes - 1, 4))).astype(np.float32)
    qd[1:] *= (1 + 1e-6 * rng.standard_normal((lanes - 1, 6))).astype(np.float32)
    ts = LandingSolver("contact_scheduled", n_knots=21, dtype=torch.float32, device="cpu")
    ts = LandingSolver("contact_scheduled", n_knots=21, dtype=torch.float32, device="cpu",
                       config=dataclasses.replace(ts.config, max_iter=80))
    sol = ts.solve_batch(q, qd)
    print("port iterations", sol.iterations.tolist(), "converged", sol.converged.tolist())
    js = JaxLandingSolver("contact_scheduled", n_knots=21, dtype=jnp.float32)
    js = JaxLandingSolver("contact_scheduled", n_knots=21, dtype=jnp.float32,
                          config=dataclasses.replace(js.config, max_iter=80,
                                                     kkt_backend="cri_ref"))
    sj = js.solve_batch(jnp.asarray(q), jnp.asarray(qd))
    print("jax  iterations", np.asarray(sj.iterations).tolist(), "converged",
          np.asarray(sj.converged).tolist())


if __name__ == "__main__":
    main()
