"""What the tools share: the kinodynamic family's solver settings and the
record files."""

from __future__ import annotations

import json
import os

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def kino_config(max_iter: int = 200, **overrides):
    """The kinodynamic family's IPConfig of the JAX package's tools
    (train_warmstart.py:48-57, warmstart_compare.py:39-43, kino_battery.py
    ``base``, cascade_sweep.py:58): monotone barrier rule (loqo loses on
    this family), hybrid Hessian, refine 3, delta_c 1e-6, tol 2e-4, cri."""
    from ..solver.ip import IPConfig

    kw = dict(max_iter=max_iter, hessian_mode="hybrid", mu_min=1e-5, tol=2e-4, sigma_max=1e5,
              refine_steps=3, relax_scale=1.0, delta_c=1e-6, kkt_backend="cri")
    kw.update(overrides)
    return IPConfig(**kw)


def write_record(path: str, record: dict) -> None:
    """Write ``record`` as indented JSON to ``path`` (its directory made)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {path}", flush=True)
