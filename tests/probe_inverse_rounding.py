"""How far the srbm_lcp path's convergence hangs on the block inverse's rounding.

    python tests/probe_inverse_rounding.py

Not a test (needs an NVIDIA GPU and nvcc; about two minutes): the streaming
srbm_lcp solve of chip_smoke.py's phase 4 (B=64, 25-iteration segments, 64
scenarios of the benchmark's sampler) runs three times, with the Newton
step's block inverse taken from the hand-written kernel, from the plain
version, and from the plain version computed in f64 and rounded to f32.
Prints the convergence rate and the iteration percentiles of each with the
card's name and power limit.
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from landing_controller_tpu_torch.ops.pallas_blocks import qd_inverse_ref  # noqa: E402
from landing_controller_tpu_torch.solver import structured  # noqa: E402


def through_plain(ref_dtype):
    """A block-inverse factory that computes in ``ref_dtype`` by the plain
    version and returns the caller's type."""
    def make(np_, nd):
        def fn(S):
            blocks = S.reshape((-1,) + S.shape[-2:]).to(ref_dtype)
            Sinv, ok = qd_inverse_ref(blocks, np_, nd)
            return Sinv.to(S.dtype).reshape(S.shape), ok.reshape(S.shape[:-2])
        return fn
    return make


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_inverse_rounding: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, make_stream = chip_smoke.srbm_lcp_path()
    make_stream(1).run(64, max_wall_s=0.0)  # first-call costs
    make_original = structured.make_qd_inverse
    for label, make in (("kernel", make_original),
                        ("plain version, f32", through_plain(torch.float32)),
                        ("plain version in f64, rounded to f32", through_plain(torch.float64))):
        structured.make_qd_inverse = make
        try:
            stats = make_stream(0).run(chip_smoke.N_SCENARIOS)
            torch.cuda.synchronize()
        finally:
            structured.make_qd_inverse = make_original
        print(f"[inverse-probe] srbm_lcp streaming B=64 seg=25, {chip_smoke.N_SCENARIOS} scenarios "
              f"on {smi}, block inverse by the {label}: convergence_rate "
              f"{stats['convergence_rate']:.4f}, iters_p50 {stats['iters_p50']:.0f}, iters_p90 "
              f"{stats['iters_p90']:.0f}, wall_s {stats['wall_s']:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
