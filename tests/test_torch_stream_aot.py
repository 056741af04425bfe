"""The StreamingSolver's saved step: a retry chain of three attempts, then
``export_step`` / ``load_step`` (the counterpart of
``tests/test_stream_aot.py``, on the CPU).

srbm_lcp at n_knots 21 (the NN guess's grid), the bench's rules, chain
ballistic -> nn -> reference, B=4, pool 8, segment 4, deadlines (28, 1, 1):
two of the eight drops converge from the ballistic guess (25 iterations),
the others go down the chain.  A fresh StreamingSolver that loads the step
gives the live run's finished and converged sets; a file saved for another
segment length or pool size, or with another first line, is refused
(False); a truncated file raises.
"""

import numpy as np
import pytest
import torch

from landing_controller_tpu_torch.api import LandingSolver
from landing_controller_tpu_torch.parallel import StreamingSolver
from landing_controller_tpu_torch.solver.ip import IPConfig

torch.set_num_threads(1)


def _sampler(n):
    rng = np.random.default_rng(1)
    q = np.zeros((n, 6))
    q[:, 2] = 0.5
    q[:, 3:6] = rng.uniform(-0.1, 0.1, (n, 3))
    qd = np.zeros((n, 6))
    qd[:, 5] = -rng.uniform(1.5, 2.5, n)
    return q, qd


def _streaming(segment=4):
    cfg = IPConfig(max_iter=28, hessian_mode="hybrid", mu_min=1e-5, tol=2e-4, sigma_max=1e5,
                   refine_steps=1, relax_scale=1.0, delta_c=1e-6, kkt_backend="cri",
                   ladder_scales=(0.0, 1.0), n_linesearch=4, mu_strategy="loqo", corrector=1)
    s = LandingSolver("srbm_lcp", n_knots=21, dtype=torch.float32, config=cfg, device="cpu",
                      guess="ballistic", retry_guess=("nn", "reference"))
    return StreamingSolver(s, batch=4, segment=segment, sampler=_sampler,
                           attempt_iters=(28, 1, 1))


@pytest.fixture(scope="module")
def saved_step(tmp_path_factory):
    """The live run of 8 drops and its step, saved for pool size 8."""
    live = _streaming()
    result = live.run(8)
    path = str(tmp_path_factory.mktemp("step") / "step.lcs")
    live.export_step(path, 8)
    return live, result, path


def test_stream_retry_chain(saved_step):
    live, r1, _ = saved_step
    assert live.n_attempts == 3
    assert r1["n_finished"] == 8
    assert 0 < r1["n_converged"] < 8  # both outcomes, so the chain runs
    # a scenario's count sums its attempts; a deadline is read at the end of
    # a segment, so a retry runs to the segment's end
    assert r1["iters_p90"] <= 28 + 4 + 4


def test_loaded_step_reproduces_the_live_run(saved_step):
    _, r1, path = saved_step
    loaded = _streaming()
    assert loaded.load_step(path, 8) is True
    r2 = loaded.run(8)
    assert r2["n_finished"] == r1["n_finished"]
    assert r2["n_converged"] == r1["n_converged"]
    np.testing.assert_array_equal(r2["converged_mask"], r1["converged_mask"])
    np.testing.assert_array_equal(r2["viol"], r1["viol"])


def test_saved_step_refused_or_raises(saved_step, tmp_path):
    _, _, path = saved_step
    # another segment length or pool size is another program: refused
    assert _streaming(segment=2).load_step(path, 8) is False
    assert _streaming().load_step(path, 12) is False
    with open(path, "rb") as f:
        blob = f.read()
    other = str(tmp_path / "other.lcs")
    with open(other, "wb") as f:
        f.write(b"not a step\n" + blob)
    assert _streaming().load_step(other, 8) is False
    # a damaged file is a fault, not a refusal
    with open(other, "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises(RuntimeError, match="zip archive"):
        _streaming().load_step(other, 8)
