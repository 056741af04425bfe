"""The window's arithmetic on a synthetic sequence of the stream's
per-segment callbacks: the opening, the three rates, and the answers that
came too late to be anything but lost."""

import os

import pytest

from benchmarks.harness import HERE, Window, load_module


def reader(name):
    return load_module(os.path.join(HERE, "metrics", name + ".py"), "test_metric_" + name).read


def feed(window, walls, finished, converged=None, now0=1000.0, monkeypatch=None):
    """Call the window as the stream would: stats after each segment."""
    import benchmarks.harness as h

    for wall, n, c in zip(walls, finished, converged or finished):
        monkeypatch.setattr(h.time, "time", lambda w=wall: now0 + w)
        window({"wall_s": wall, "n_finished": n, "n_converged": c})


def test_rates_over_the_window(monkeypatch):
    w = Window(batch=64, pool=1024, segment=25, deadlines=(100, 150), seconds=15.0)
    feed(w, [4.0, 8.1, 12.0, 16.2], [0, 10, 30, 55], [0, 9, 25, 44], monkeypatch=monkeypatch)
    assert w.opened == pytest.approx(1000.0) and w.segments == 4
    assert w.stretch() == {"segments": 4, "wall_s": 16.2, "n_finished": 55, "n_converged": 44}
    assert 16.2 - 0 > w.deadline and not 14.9 > w.deadline  # as the stream compares
    ctx = {"window": {**w.stretch(), "segment": 25, "iters_p50": 61.0, "n_finished_all": 55,
                      "setup_s": 31.5}}
    assert reader("converged_solves_per_s")(ctx) == pytest.approx(44 / 16.2)
    assert reader("convergence_rate")(ctx) == pytest.approx(0.8)
    assert reader("batch_iteration_ms")(ctx) == pytest.approx(1e3 * 16.2 / 100)
    assert reader("setup_s")(ctx) == 31.5
    assert reader("solver.iters_p50")(ctx) == 61.0
    empty = {"window": dict(ctx["window"], n_finished=0, n_converged=0, n_finished_all=0)}
    assert reader("convergence_rate")(empty) is None and reader("solver.iters_p50")(empty) is None


def test_due_and_overdue(monkeypatch):
    # B=4, segments of 2 iterations, deadlines (2, 2): a drop that starts at
    # segment s has used both attempts by harvest s + 1
    w = Window(batch=4, pool=12, segment=2, deadlines=(2, 2))
    feed(w, [1, 2, 3, 4], [0, 4, 8, 10], monkeypatch=monkeypatch)
    assert [w.due_harvest(i) for i in (0, 3, 4, 7, 8, 11)] == [1, 1, 3, 3, 4, 4]
    assert w.due_harvest(12) is None
    assert w.overdue(range(10)) == 0
    assert w.overdue([0, 1, 2, 4, 5, 6, 7, 8, 9]) == 1  # drop 3 never came
    assert w.overdue([0, 1, 2, 3, 4, 5, 6, 7]) == 0  # drops 8-11 are not due yet
    assert w.drained()  # every drop of the pool was handed out
    w = Window(batch=4, pool=100, segment=2, deadlines=(2, 2))
    feed(w, [1, 2], [0, 4], monkeypatch=monkeypatch)
    assert not w.drained()


def test_deadlines_round_up_to_segments(monkeypatch):
    w = Window(batch=2, pool=8, segment=25, deadlines=(100, 150))
    assert w.due_harvest(0) == 9
    w = Window(batch=2, pool=8, segment=25, deadlines=(90,))
    assert w.due_harvest(1) == 3


def test_window_opens_after_the_ramp(monkeypatch):
    """With a ramp of 3 segments the window opens at the third harvest, its
    deadline is then that harvest's clock plus the seconds, and the rates
    count only the work and time after it."""
    w = Window(batch=64, pool=1024, segment=25, deadlines=(50, 25), ramp=3, seconds=10.0)
    assert not 1e9 > w.deadline  # no deadline before the window opens
    feed(w, [4.0, 8.0, 12.5], [0, 10, 30], [0, 10, 28], monkeypatch=monkeypatch)
    assert w.opened == pytest.approx(1012.5)
    assert 22.6 > w.deadline and not 22.4 > w.deadline
    assert w.stretch()["segments"] == 0
    feed(w, [16.0, 20.0, 23.0], [50, 70, 90], [45, 60, 75], monkeypatch=monkeypatch)
    assert w.stretch() == {"segments": 3, "wall_s": pytest.approx(10.5), "n_finished": 60, "n_converged": 47}
    assert w.segments == 6 and w.due_harvest(0) == 2
