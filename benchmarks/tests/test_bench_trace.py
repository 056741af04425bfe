"""The per-layer readers on a small recorded event list: two segments'
worth of host ops, launches and device kernels, with known answers."""

import os

import pytest

from benchmarks.harness import HERE, load_module
from benchmarks.peaks import qd_inverse_bound_ms
from benchmarks.trace import Event, Trace, short

US = 1000  # ns
QD = "void (anonymous namespace)::qd_inverse_kernel<float, 36, 24>(float const*, float*, unsigned char*, int, int)"


def reader(name):
    return load_module(os.path.join(HERE, "metrics", name + ".py"), "test_trace_" + name).read


def recorded():
    """A 10 ms stretch of 2 iterations as the CUDA activity records it: the
    runtime calls on the host, and the device running 4 kernels (2 of them
    qd_inverse, with their grids) and a copy for 2.2 ms."""
    ev = [
        Event("cudaLaunchKernel", False, 100 * US, 5 * US),
        Event("cudaLaunchKernelExC", False, 1200 * US, 5 * US),
        Event("cuLaunchKernel", False, 4100 * US, 5 * US),
        Event("cudaLaunchKernel", False, 6100 * US, 5 * US),
        Event("cudaMemcpyAsync", False, 8000 * US, 5 * US),
        # device: elementwise (overlapping a second one), gemm, two inverses
        Event("elementwise_kernel", True, 200 * US, 400 * US, (8, 1, 1)),
        Event("elementwise_kernel", True, 300 * US, 400 * US, (8, 1, 1)),
        Event("gemm_kernel", True, 1300 * US, 1000 * US, (4, 2, 1)),
        Event(QD, True, 4200 * US, 400 * US, (1280, 1, 1)),
        Event(QD, True, 6200 * US, 200 * US, (128, 1, 1)),
        Event("Memcpy DtoH (Device -> Pinned)", True, 8100 * US, 100 * US),
    ]
    return Trace(window_s=10e-3, iterations=2, events=ev)


def test_busy_idle_and_launches():
    tr = recorded()
    busy = (500 + 1000 + 400 + 200 + 100) * 1e-6  # the two elementwise kernels overlap
    assert tr.busy_s() == pytest.approx(busy)
    ctx = {"trace": tr, "config": {"qd_inverse_block": [36, 24]}}
    assert reader("device.idle_share")(ctx) == pytest.approx(1 - busy / 10e-3)
    assert reader("device.launches_per_iter")(ctx) == pytest.approx(4 / 2)  # not the memcpy


def test_kernel_shares():
    tr = recorded()
    ctx = {"trace": tr, "config": {"qd_inverse_block": [36, 24]}}
    bound_s = 1e-3 * (qd_inverse_bound_ms(1280, 36, 24)[0] + qd_inverse_bound_ms(128, 36, 24)[0])
    assert reader("qd_inverse_roofline")(ctx) == pytest.approx(100 * bound_s / 600e-6)
    total = (400 + 400 + 1000 + 400 + 200 + 100) * 1e-6
    assert reader("kernel.qd_inverse.device_share")(ctx) == pytest.approx(600e-6 / total)


def test_readers_say_nothing_without_something_to_read():
    tr = recorded()
    no_kernel = Trace(tr.window_s, tr.iterations, [e for e in tr.events if "qd_inverse" not in e.name])
    for name in ("qd_inverse_roofline", "kernel.qd_inverse.device_share"):
        assert reader(name)({"trace": no_kernel, "config": {}}) is None
        assert reader(name)({"trace": None, "config": {}}) is None
    # a kernel whose grid the profiler did not record
    no_grid = Trace(tr.window_s, tr.iterations, [e if "qd_inverse" not in e.name else
                                                 Event(e.name, True, e.start_ns, e.dur_ns) for e in tr.events])
    assert reader("qd_inverse_roofline")({"trace": no_grid, "config": {}}) is None


def test_run_time_instance_takes_the_configurations_split():
    tr = recorded()
    runtime = QD.replace("<float, 36, 24>", "<float, 0, 0>")
    events = [Event(runtime, True, e.start_ns, e.dur_ns, e.grid) if "qd_inverse" in e.name else e
              for e in tr.events]
    ctx = {"trace": Trace(tr.window_s, tr.iterations, events), "config": {"qd_inverse_block": [36, 24]}}
    assert reader("qd_inverse_roofline")(ctx) == pytest.approx(reader("qd_inverse_roofline")(
        {"trace": tr, "config": {}}))
    for name in ("device.idle_share", "device.launches_per_iter"):
        assert reader(name)({"trace": None}) is None


def test_breakdown():
    tr = recorded()
    ops = tr.device_ops()
    assert ops[0] == ["gemm_kernel", pytest.approx(1e-3)]
    assert len(ops) == 4 and len(tr.device_ops(top=2)) == 2
    # the gaps, each named by the device op that ends it: 0.6 ms before the
    # gemm, 1.9 ms and 1.6 ms before the two inverses, 1.7 ms before the copy
    assert dict(tr.idle_gaps()) == {"before gemm_kernel": pytest.approx(0.6e-3),
                                    "before " + short(QD): pytest.approx(3.5e-3),
                                    "before Memcpy DtoH (Device -> Pinned)": pytest.approx(1.7e-3)}
    assert tr.idle_gaps()[0][0] == "before qd_inverse_kernel<float, 36, 24>(float const*, float*, unsigned char*, int, int)"
    assert tr.busy_s() + sum(s for _, s in tr.idle_gaps()) == pytest.approx(8.0e-3)  # first op to last


def test_chrome_trace_round_trip():
    """The records as the profiler's Chrome trace holds them (microsecond
    floats, categories, the kernels' grids under args) read back alike."""
    from benchmarks.trace import parse_chrome_trace

    tr = recorded()
    doc = {"traceEvents": [{"ph": "M", "name": "process_name", "pid": 0}] + [
        {"ph": "X", "cat": ("kernel" if e.on_device and "Memcpy" not in e.name else
                            "gpu_memcpy" if e.on_device else "cuda_runtime"),
         "name": e.name, "ts": e.start_ns / 1e3, "dur": e.dur_ns / 1e3, "pid": 0, "tid": 7,
         "args": ({"grid": list(e.grid), "block": [128, 1, 1]} if e.grid else {"correlation": 1})}
        for e in tr.events]}
    back = Trace(tr.window_s, tr.iterations, parse_chrome_trace(doc))
    assert [(e.name, e.on_device, e.start_ns, e.dur_ns, e.grid) for e in back.events] == \
        [(e.name, e.on_device, e.start_ns, e.dur_ns, e.grid) for e in tr.events]
    ctx = {"trace": back, "config": {}}
    assert reader("qd_inverse_roofline")(ctx) == pytest.approx(reader("qd_inverse_roofline")({"trace": tr,
                                                                                               "config": {}}))
