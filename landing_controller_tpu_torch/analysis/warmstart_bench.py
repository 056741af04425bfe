"""Solve-time comparison across warm-start regimes: the reference's own
benchmark harness (generate_data/nn_warmstart.m:32-235).

Per trial, times four rows on the same scenario batch:

- ``nn_eval``   : MLP inference only (9-D IC -> 976-D trajectory guess)
- ``nn_ws``     : kinodynamic solve warm-started from the NN guess
- ``cold``      : kinodynamic solve from the linspace reference guess
- ``srbm_ws``   : SRBM-LCP solve -> kinodynamic solve (the cascade)

The reference runs these serially per scenario and boxplots t_solve
(nn_warmstart.m:232-235); here each row is one batched solve, timed on the
host clock around work that ends in a device synchronize.  There is no
compilation to hide: one untimed pass of every row on the first trial's
batch pays the first-call costs (library handles, the allocator's pools).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..warmstart.cascade import make_cascade
from ..warmstart.nn import nn_warmstart_guess

TIME_ROWS = ("nn_eval", "nn_ws", "cold", "srbm_ws")
SOLVE_ROWS = ("nn_ws", "cold", "srbm_ws")


def warmstart_comparison(kino_solver, srbm_solver, mlp, stats, q0s, qd0s, n_trials: int = 5):
    """Run the four-regime timing comparison.

    mlp, stats: the warm-start network and its statistics (on the solver's
    device and dtype); q0s/qd0s: (n_trials, B, 6) scenario batches, one
    batch per trial.  Returns a dict with per-trial timing rows (seconds)
    and per-regime convergence rates."""
    q0s = torch.as_tensor(np.asarray(q0s), dtype=kino_solver.dtype, device=kino_solver.device)
    qd0s = torch.as_tensor(np.asarray(qd0s), dtype=kino_solver.dtype, device=kino_solver.device)
    if q0s.dim() != 3 or q0s.shape[0] < n_trials:
        raise ValueError(f"q0s must be (n_trials >= {n_trials}, B, 6), got {tuple(q0s.shape)}")
    problem = kino_solver.problem
    cascade = make_cascade(srbm_solver, kino_solver)

    def sync():
        if kino_solver.device.type == "cuda":
            torch.cuda.synchronize(kino_solver.device)

    def nn_guess(qb, qdb):
        with torch.no_grad():
            return nn_warmstart_guess(mlp, stats, qb, qdb, problem)

    # warm regimes solve at the solver's own cold barrier (the JAX package's
    # cascade ablation measured a reduced mu_init restart as the dominant
    # warm-start failure source)
    rows = {
        "nn_eval": nn_guess,
        "nn_ws": lambda qb, qdb, z0b: kino_solver._solve_impl(qb, qdb, z0=z0b),
        "cold": kino_solver.solve_batch,
        "srbm_ws": lambda qb, qdb: cascade(qb, qdb)[0],
    }

    def timed(name, *args):
        sync()
        t0 = time.time()
        out = rows[name](*args)
        sync()
        return time.time() - t0, out

    # the untimed pass on trial 0
    z0w = nn_guess(q0s[0], qd0s[0])
    rows["nn_ws"](q0s[0], qd0s[0], z0w)
    rows["cold"](q0s[0], qd0s[0])
    rows["srbm_ws"](q0s[0], qd0s[0])

    t = {k: [] for k in TIME_ROWS}
    conv = {k: [] for k in SOLVE_ROWS}
    for i in range(n_trials):
        qb, qdb = q0s[i], qd0s[i]
        dt, z0b = timed("nn_eval", qb, qdb)
        t["nn_eval"].append(dt)
        for name, args in (("nn_ws", (qb, qdb, z0b)), ("cold", (qb, qdb)),
                           ("srbm_ws", (qb, qdb))):
            dt, sol = timed(name, *args)
            t[name].append(dt)
            conv[name].append(float(sol.converged.float().mean()))

    return {
        "t": {k: np.asarray(v) for k, v in t.items()},
        "convergence": {k: np.asarray(v) for k, v in conv.items()},
        "batch_size": int(q0s.shape[1]),
    }


def plot_warmstart_comparison(result, save_path=None):
    """Boxplot of per-trial solve times per regime (nn_warmstart.m:232-235)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = [result["t"][k] for k in TIME_ROWS]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.boxplot(data, tick_labels=["NN eval", "NN-WS", "cold", "SRBM-WS"])
    ax.set_ylabel(f"wall time per batch of {result['batch_size']} [s]")
    ax.set_title("Warm-start regimes: batched solve time")
    ax.grid(alpha=0.3)
    if save_path:
        fig.savefig(save_path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig
