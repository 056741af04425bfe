"""Probe: which op makes the card's srbm_lcp path differ from run to run?

    python -m landing_controller_tpu_torch.determinism_probe

Runs on one NVIDIA GPU, changes nothing and adds no switch.  It

1. runs 25 interior-point iterations of 64 srbm_lcp lanes (the benchmark's
   solver settings) under ``torch.use_deterministic_algorithms(True,
   warn_only=True)`` and prints every distinct warning, i.e. every op that
   PyTorch knows to be nondeterministic on this path;
2. runs the same segment a second time in the same process and compares
   every field of the two solver states bit for bit;
3. does the same for the pieces of one factorization on fixed inputs: the
   ``qd_inverse`` kernel, the batched products of the cyclic-reduction
   sweep and a row sum;
4. prints a SHA-1 of the final iterate, so that two separate processes (or
   machines) can be compared by eye.
"""

from __future__ import annotations

import dataclasses
import hashlib
import sys
import warnings

import numpy as np


def _sha(t) -> str:
    return hashlib.sha1(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("determinism_probe: CUDA is not available", file=sys.stderr)
        return 2
    from landing_controller_tpu_torch import IPConfig, LandingSolver
    from landing_controller_tpu_torch.ops.pallas_blocks import qd_inverse
    from landing_controller_tpu_torch.warmstart.reference import DT_PRODUCTION

    print(f"[probe] torch {torch.__version__}; {torch.cuda.get_device_name(0)}", flush=True)
    cfg = IPConfig(
        max_iter=200, hessian_mode="hybrid", mu_init=0.3, kappa_mu=0.5, mu_min=1e-5, tol=1e-4,
        sigma_max=1e5, refine_steps=1, relax_scale=1.0, delta_c=1e-6, kkt_backend="cri",
        ladder_scales=(0.0, 1.0), n_linesearch=4, mu_strategy="loqo", stall_window=40,
        stall_min_iter=40, corrector=1,
    )
    solver = LandingSolver("srbm_lcp", dtype=torch.float32, config=cfg, guess="ballistic",
                           theta_overrides={"dt": DT_PRODUCTION.astype(np.float32)}, device="cuda")
    rng = np.random.default_rng(0)
    n = 64
    q = np.zeros((n, 6), np.float32)
    q[:, 2] = 0.6
    q[:, 3:] = rng.uniform(-0.25, 0.25, (n, 3))
    qd = np.concatenate([rng.uniform(-0.5, 0.5, (n, 5)), -rng.uniform(0.5, 5.0, (n, 1))], 1)
    qd = qd.astype(np.float32)

    def segment():
        snlp, st = solver.init_lanes(q, qd, 0)
        _, st = solver._segment_impl(None, None, st, 25, snlp=snlp)
        torch.cuda.synchronize()
        return snlp, st

    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        snlp_a, st_a = segment()
    torch.use_deterministic_algorithms(False)
    msgs = sorted({str(w.message).splitlines()[0] for w in caught
                   if "deterministic" in str(w.message).lower()})
    print(f"[probe] ops that warn under use_deterministic_algorithms: {len(msgs)}")
    for m in msgs:
        print(f"[probe]   {m}")

    _, st_b = segment()
    differing = [f.name for f in dataclasses.fields(st_a)
                 if not torch.equal(getattr(st_a, f.name), getattr(st_b, f.name))]
    print(f"[probe] two 25-iteration segments in one process: "
          f"{'bit for bit equal' if not differing else 'differ in ' + ', '.join(differing)}")
    same_scales = torch.equal(segment()[0].ineq_scale, snlp_a.ineq_scale)
    print(f"[probe] row scales of the scaled problem: {'equal' if same_scales else 'DIFFER'}")

    g = torch.Generator(device="cuda").manual_seed(0)
    P = torch.randn((1280, 36, 36), generator=g, device="cuda")
    D = torch.randn((1280, 24, 24), generator=g, device="cuda")
    Bm = 0.5 * torch.randn((1280, 24, 36), generator=g, device="cuda")
    S = torch.zeros((1280, 60, 60), device="cuda")
    S[:, :36, :36] = P @ P.transpose(1, 2) / 36 + 0.5 * torch.eye(36, device="cuda")
    S[:, 36:, 36:] = -(D @ D.transpose(1, 2) / 24 + 0.5 * torch.eye(24, device="cuda"))
    S[:, 36:, :36] = Bm
    S[:, :36, 36:] = Bm.transpose(1, 2)
    C = torch.randn((1280, 60, 60), generator=g, device="cuda")
    pieces = {
        "qd_inverse kernel": lambda: qd_inverse(S, 36, 24)[0],
        "batched matmul (1280, 60, 60) @ (1280, 60, 60)": lambda: S @ C,
        "batched matvec": lambda: (S @ C[:, :, :1])[..., 0],
        "sum over the last axis": lambda: C.abs().sum(-1),
    }
    for name, fn in pieces.items():
        outs = [fn() for _ in range(5)]
        torch.cuda.synchronize()
        same = all(torch.equal(outs[0], o) for o in outs[1:])
        print(f"[probe] {name}: 5 runs {'bit for bit equal' if same else 'DIFFER'}; "
              f"sha1 {_sha(outs[0])}")
    print(f"[probe] sha1 of z after 25 iterations: {_sha(st_a.z)}; of the slacks: {_sha(st_a.s)}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
