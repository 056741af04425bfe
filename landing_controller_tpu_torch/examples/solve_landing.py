"""Solve one landing scenario end to end and draw it.

    python -m landing_controller_tpu_torch.examples.solve_landing [--kind srbm_lcp]
        [--cascade] [--plot out.png | out.html] [--seed 0] [--device cpu]

The counterpart of the JAX package's examples/solve_landing.py: one drop of
``sample_drop_scenario`` (a generator seeded ``--seed``), solved by
``LandingSolver(--kind)`` or by the srbm_lcp -> kinodynamic cascade
(``--cascade``, stage 1 on the production dt schedule).  ``--plot`` draws
the diagnostics panel (``viz.plot_results``, matplotlib) to a PNG, or, for
a path ending in ``.html``, writes the interactive viewer
(``viz.export_html``, no matplotlib).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Solve and draw one landing scenario")
    ap.add_argument("--kind", default="srbm_lcp")
    ap.add_argument("--cascade", action="store_true", help="SRBM -> kinodynamic cascade")
    ap.add_argument("--plot", default=None, help="PNG panel, or an .html viewer")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from .._device import resolve_device
    from ..api import LandingSolver
    from ..warmstart.reference import sample_drop_scenario

    device = resolve_device(args.device)
    q, qd = sample_drop_scenario(1, torch.Generator().manual_seed(args.seed), device=device)
    q0, qd0 = q[0], qd[0]
    print("IC q:", q0.cpu().numpy().round(3), " qd:", qd0.cpu().numpy().round(3))

    if args.cascade:
        from ..warmstart.cascade import make_cascade
        from ..warmstart.reference import DT_PRODUCTION

        srbm = LandingSolver("srbm_lcp", theta_overrides={"dt": DT_PRODUCTION}, device=device)
        solver = LandingSolver("kinodynamic", device=device)
        sol, _ = make_cascade(srbm, solver)(q0, qd0)
    else:
        solver = LandingSolver(args.kind, device=device)
        sol = solver.solve(q0, qd0)

    print(f"converged={bool(sol.converged)} iterations={int(sol.iterations)} "
          f"kkt={float(sol.kkt_error):.2e} viol={float(sol.constr_viol):.2e}", flush=True)
    if args.plot:
        dt = solver.build_params(q, qd).dt[0].cpu().numpy()
        X, U = sol.X.cpu().numpy(), sol.U.cpu().numpy()
        if args.plot.endswith(".html"):
            from ..viz import export_html

            export_html(args.plot, X, U, dt)
        else:
            from ..models import get_robot_model
            from ..viz import plot_results

            t = np.concatenate([[0.0], np.cumsum(dt)])
            jpos = sol.jpos.cpu().numpy() if sol.jpos.shape[1] else np.zeros((len(t) - 1, 12))
            plot_results(get_robot_model(), t, X, U, jpos, save_path=args.plot)
        print("wrote", args.plot, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
