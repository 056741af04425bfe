"""The control of the comparison that decides ``correct``, on the card:
at srbm_lcp.b64's own size, with a 5 s window after the ramp, the program's
answers pass and the reference computed in TF32 in the program's place
fails ``viol_gap`` and ``kkt_error`` on the same answers.
Run on a card with ``python -m pytest -q -p no:cacheprovider -m cuda
benchmarks/tests``; it skips without one."""

import pytest

from benchmarks.harness import run_cell

SEED = 2**31 + 4242


def quiet(*args, **kwargs):
    pass


@pytest.mark.cuda
def test_control_fails_where_the_program_passes():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    result, checks = run_cell("srbm_lcp.b64", SEED, 5.0, False, log=quiet, control=True)
    mine = result["program_checks"]
    assert all(mine[k] <= lim for k, (_, lim) in checks.items()), mine
    assert not result["correct"]
    for name in ("viol_gap", "kkt_error"):
        value, limit = checks[name]
        assert value > limit, checks
