"""The frozen copy of the kernel's least time and the card's peaks holds
chip_smoke.py's values."""

import os

import pytest

from benchmarks import peaks
from benchmarks.harness import load_module
from benchmarks.tests.conftest import ROOT


@pytest.fixture(scope="module")
def smoke():
    return load_module(os.path.join(ROOT, "chip_smoke.py"), "chip_smoke_for_peaks")


def test_peaks_equal(smoke):
    assert peaks.H100_BYTES_PER_S == smoke.H100_BYTES_PER_S
    assert peaks.H100_F32_FLOPS == smoke.H100_F32_FLOPS
    assert peaks.H100_F64_FLOPS == smoke.H100_F64_FLOPS


@pytest.mark.parametrize("m,np_,nd,itemsize", [(1280, 36, 24, 4), (128, 36, 24, 4), (5120, 48, 36, 4),
                                               (512, 48, 36, 4), (1280, 30, 20, 4), (5120, 48, 36, 8),
                                               (20480, 48, 36, 4), (1, 1, 0, 4)])
def test_bound_equal(smoke, m, np_, nd, itemsize):
    assert peaks.qd_inverse_bound_ms(m, np_, nd, itemsize) == smoke.qd_inverse_bound_ms(m, np_, nd, itemsize)


def test_bound_is_linear_in_m():
    one, what = peaks.qd_inverse_bound_ms(1, 36, 24)
    assert peaks.qd_inverse_bound_ms(1280, 36, 24)[0] == pytest.approx(1280 * one)
    assert what in ("bytes", "operations")
