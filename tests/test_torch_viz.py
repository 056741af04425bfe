"""The port's viz/ against the JAX package's, on the same numpy-seeded inputs.

- ``_chain_points`` and ``_body_corners`` within 1e-12 (both in float64);
- ``motor_voltages`` equal, ``export_html`` the same file text;
- ``plot_results(tau=None)`` writes a PNG, its torques (the port's
  ``leg_torques``) within 1e-6 (relative to the largest) of JAX's in float32;
- the GIF and the self-contained HTML page, as the JAX package's
  ``test_animate.py`` and ``test_html_viewer.py`` check its own.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.dynamics import legs as jlegs
from landing_controller_tpu.models import get_robot_model as j_get_robot_model
from landing_controller_tpu.viz import animate as janimate
from landing_controller_tpu.viz import html_viewer as jhtml
from landing_controller_tpu.viz import plots as jplots
from landing_controller_tpu_torch.dynamics import legs
from landing_controller_tpu_torch.models import get_robot_model, get_robot_params
from landing_controller_tpu_torch.viz import animate, export_html, motor_voltages, plot_results

torch.set_num_threads(1)


def _trajectory(rng, n=6):
    X = np.zeros((n, 12))
    X[:, 2] = np.linspace(0.6, 0.3, n)
    X[:, 3:6] = rng.uniform(-0.3, 0.3, (n, 3))
    X[:, 6:] = rng.uniform(-1.0, 1.0, (n, 6))
    jpos = rng.uniform(-0.8, 0.8, (n - 1, 12))
    U = np.concatenate([rng.uniform(-0.3, 0.3, (n - 1, 12)), rng.uniform(0, 60, (n - 1, 12))], 1)
    dt = rng.uniform(0.02, 0.1, n - 1)
    return X, jpos, U, dt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_geometry_matches_jax(seed):
    rng = np.random.default_rng(seed)
    params = get_robot_params("mc3D")
    q_base = np.concatenate([rng.uniform(-0.5, 0.5, 3), rng.uniform(-0.6, 0.6, 3)])
    jpos = rng.uniform(-1.0, 1.0, 12)
    np.testing.assert_allclose(animate._chain_points(params, q_base, jpos),
                               janimate._chain_points(params, q_base, jpos), rtol=0, atol=1e-12)
    np.testing.assert_allclose(animate._body_corners(params, q_base),
                               janimate._body_corners(params, q_base), rtol=0, atol=1e-12)
    # the viewer's foot is the NLP's foot (the port's FK)
    feet = legs.foot_positions_world(params, torch.as_tensor(q_base), torch.as_tensor(jpos))
    np.testing.assert_allclose(animate._chain_points(params, q_base, jpos)[:, 2], feet.numpy(),
                               rtol=0, atol=1e-12)


def test_voltages_and_html_equal_jax(tmp_path):
    rng = np.random.default_rng(4)
    X, jpos, U, dt = _trajectory(rng)
    tau = rng.uniform(-20, 20, jpos.shape)
    np.testing.assert_array_equal(motor_voltages(get_robot_model(), tau, jpos, dt),
                                  jplots.motor_voltages(j_get_robot_model(), tau, jpos, dt))
    ours = export_html(str(tmp_path / "port.html"), X, U, dt)
    theirs = jhtml.export_html(str(tmp_path / "jax.html"), X, U, dt)
    assert open(ours).read() == open(theirs).read()


def test_plot_results_torques_match_jax(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(5)
    X, jpos, U, dt = (a.astype(np.float32) for a in _trajectory(rng))
    t = np.concatenate([[0.0], np.cumsum(dt)])
    model = get_robot_model()
    png = tmp_path / "results.png"
    fig = plot_results(model, t, X, U, jpos, save_path=str(png))
    assert png.exists() and png.stat().st_size > 10_000
    # the torque panel's lines are the port's leg_torques; JAX's in float32
    panel = next(a for a in fig.axes if a.get_title().startswith("Torque limits"))
    # (the limit lines are two-point axhlines)
    drawn = np.stack([ln.get_ydata() for ln in panel.get_lines() if len(ln.get_ydata()) > 2])
    jp = j_get_robot_model().params
    want = np.asarray(jax.vmap(lambda q, x, u: jlegs.leg_torques(jp, q, x[3:6], u[12:]))(
        jnp.asarray(jpos), jnp.asarray(X[:-1]), jnp.asarray(U)))
    assert want.dtype == np.float32
    # plotted per joint kind (abad, hip, knee), leg by leg; the port computes
    # in float64 from the float32 inputs: 1e-6 of the largest torque is a few
    # float32 ulps
    order = [3 * leg + j for j in range(3) for leg in range(4)]
    np.testing.assert_allclose(drawn, want[:, order].T, rtol=0, atol=1e-6 * np.abs(want).max())


def test_animate_writes_gif(tmp_path):
    pytest.importorskip("matplotlib")
    params = get_robot_params("mc3D")
    n = 4
    t = np.linspace(0.0, 0.3, n)
    X = np.zeros((n, 12))
    X[:, 2] = np.linspace(0.6, 0.3, n)
    X[:, 4] = np.linspace(0.4, 0.0, n)
    jpos = np.tile(np.array([0.0, -0.8, 1.6] * 4), (n, 1))
    U = np.zeros((n - 1, 24))
    U[:, 14] = 30.0  # one leg pressing
    out = tmp_path / "landing.gif"
    path = animate.animate_landing(params, t, X, jpos, U=U, save_path=str(out), fps=5)
    assert out.exists() and out.stat().st_size > 1000, path


def test_export_html_self_contained(tmp_path):
    N = 21
    X = np.zeros((N, 12))
    X[:, 2] = np.linspace(0.6, 0.28, N)
    U = np.zeros((N - 1, 24))
    U[:, 14::3] = 25.0
    dt = np.concatenate([[0.05], np.full(15, 0.02), [0.05, 0.05, 0.1, 0.2]])
    html = open(export_html(str(tmp_path / "v.html"), X, U, dt)).read()
    assert "__DATA__" not in html
    assert "http://" not in html and "https://" not in html
    data = json.loads(re.search(r"const D = (\{.*?\});\n", html, re.S).group(1))
    assert len(data["t"]) == N and len(data["X"]) == N and len(data["U"]) == N - 1
    np.testing.assert_allclose(data["t"][-1], float(dt.sum()), atol=1e-5)
    for token in ("onmousedown", "onwheel", "getElementById('t')", "play"):
        assert token in html
