"""The training half of the port's warm-start network against the JAX
package (CPU).

- ``touchdown_indices`` (with a leg that never lands), ``compute_stats``,
  ``normalize_sample`` and the round trip through ``denormalize_output``,
  batched, to 1e-12 in f64;
- ``train_mlp`` from JAX ``init_mlp``'s weights, hidden 64, 30 epochs with
  ``batch_size >= n``: one full batch per epoch, so the permutation does not
  enter and the loss histories must agree.  f32 on both sides: relative
  1e-5, a few units of f32 rounding (2^-23 = 1.2e-7) carried through 30 Adam
  steps of a 4-layer network (read: 4.8e-7 absolute on losses of 0.9-3.5);
- the port's ``init_mlp`` (He-normal, zero biases) and its generator;
- ``save_warmstart`` files read by either package's ``load_warmstart``, both
  ways, and ``convert`` carrying weights and statistics both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.warmstart import nn as jnn
from landing_controller_tpu_torch import convert
from landing_controller_tpu_torch._tree import tree_flatten
from landing_controller_tpu_torch.analysis import default_vbl_weights
from landing_controller_tpu_torch.dynamics.featherstone import composite_body_inertia
from landing_controller_tpu_torch.models import get_robot_model
from landing_controller_tpu_torch.problems import default_eeparam_params
from landing_controller_tpu_torch.warmstart import nn
from landing_controller_tpu_torch.warmstart.reference import sample_drop_scenario

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

N = nn.N_KNOTS
FIELDS = jnn.DataStats._fields


def _dataset(B=7, seed=0):
    """Trajectories whose GRFs land at random knots; lane 0's leg 0 and lane
    3's leg 2 never exceed 1 N."""
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((B, N - 1, 24))
    fz = np.where(rng.random((B, N - 1, 4)) < 0.3, rng.uniform(2.0, 80.0, (B, N - 1, 4)),
                  rng.uniform(0.0, 1.0, (B, N - 1, 4)))
    fz[0, :, 0] = 0.5
    fz[3, :, 2] = 1.0  # exactly 1 N is not a touchdown
    U[..., 14::3] = fz
    X = rng.standard_normal((B, N, 12))
    J = rng.standard_normal((B, N - 1, 12))
    xin = rng.standard_normal((B, 9))
    return xin, X, U, J


def _jax_stats(xin, X, U, J):
    return jnn.compute_stats(jnp.asarray(xin), jnp.asarray(X), jnp.asarray(U), jnp.asarray(J),
                             8.252)


def test_touchdown_indices_keep_the_never_landed_label():
    _, _, U, _ = _dataset()
    got = nn.touchdown_indices(torch.as_tensor(U)).numpy()
    want = np.stack([np.asarray(jnn.touchdown_indices(jnp.asarray(u))) for u in U])
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == got[3, 2] == N - 1


def test_touchdown_align_forward_matches_jax():
    _, _, U, _ = _dataset(seed=1)
    f = U[..., 12:].reshape(U.shape[0], N - 1, 4, 3)
    td = nn.touchdown_indices(torch.as_tensor(U))
    got = nn._touchdown_align_forward(torch.as_tensor(f), td).numpy()
    want = np.stack([np.asarray(jax.vmap(jnn._touchdown_align_forward, in_axes=(1, 0), out_axes=1)(
        jnp.asarray(fi), jnp.asarray(ti))) for fi, ti in zip(f, td.numpy())])
    np.testing.assert_array_equal(got, want)


def test_stats_and_normalization_match_jax_f64():
    xin, X, U, J = _dataset()
    sj = _jax_stats(xin, X, U, J)
    t = [torch.as_tensor(a) for a in (xin, X, U, J)]
    st = nn.compute_stats(*t, 8.252)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(sj, f)), rtol=0,
                                   atol=1e-12, err_msg=f)
    xj, tj = jax.vmap(lambda a, b, c, d: jnn.normalize_sample(sj, a, b, c, d))(
        *(jnp.asarray(a) for a in (xin, X, U, J)))
    xt, tt = nn.normalize_sample(st, *t)
    assert tt.shape == (len(xin), nn.OUTPUT_DIM)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-12)
    assert (tt[:, 0:2] == 0).all()  # the initial xy is zeroed

    # the round trip: denormalizing the target restores the trajectory
    # (GRFs of a leg that never lands come back as zeros, as in JAX)
    Xr, Ur, Jr = nn.denormalize_output(st, tt)
    Xj, Uj, Jj = jax.vmap(lambda y: jnn.denormalize_output(sj, y))(tj)
    for got, want in ((Xr, Xj), (Ur, Uj), (Jr, Jj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Xr.numpy()[:, 1:], X[:, 1:], rtol=0, atol=1e-12)
    np.testing.assert_allclose(Jr.numpy(), J, rtol=0, atol=1e-12)
    np.testing.assert_allclose(Ur.numpy()[..., :12], U[..., :12], rtol=0, atol=1e-12)
    assert (Ur.numpy()[0, :, 12:15] == 0).all()


def test_train_mlp_from_jax_weights_matches_jax_losses():
    xin, X, U, J = _dataset(B=24, seed=2)
    sj = _jax_stats(xin, X, U, J)
    xj, tj = jax.vmap(lambda a, b, c, d: jnn.normalize_sample(sj, a, b, c, d))(
        *(jnp.asarray(a) for a in (xin, X, U, J)))
    x32, t32 = np.asarray(xj, np.float32), np.asarray(tj, np.float32)
    key = jax.random.PRNGKey(4)
    _, init_key = jax.random.split(key)  # the key JAX train_mlp initializes from
    p0 = jnn.init_mlp(init_key, hidden=64)
    pj, lj = jnn.train_mlp(jnp.asarray(x32), jnp.asarray(t32), key=key, epochs=30,
                           batch_size=32, hidden=64)
    stats = {f: np.asarray(getattr(sj, f)) for f in FIELDS}
    mlp, _ = convert.mlp_from_numpy([np.asarray(w) for w in p0.weights],
                                    [np.asarray(b) for b in p0.biases], stats, device="cpu")
    mlp, lt = nn.train_mlp(torch.as_tensor(x32), torch.as_tensor(t32), epochs=30, batch_size=32,
                           mlp=mlp)
    assert len(lt) == len(lj) == 30
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=0)
    assert lt[-1] < 0.5 * lt[0]
    weights, _, _ = convert.mlp_to_numpy(mlp, nn.stats_from_numpy(stats, device="cpu"))
    for wt, wj in zip(weights, pj.weights):
        np.testing.assert_allclose(wt, np.asarray(wj), rtol=0, atol=1e-4)
    assert not any(p.requires_grad for p in mlp.parameters())


def test_train_mlp_drops_the_partial_batch_and_draws_from_its_generator():
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((10, 9)), dtype=torch.float32)
    y = torch.as_tensor(rng.standard_normal((10, nn.OUTPUT_DIM)), dtype=torch.float32)
    runs = [nn.train_mlp(x, y, generator=torch.Generator().manual_seed(s), epochs=3,
                         batch_size=4, hidden=16) for s in (1, 1, 2)]
    assert runs[0][1] == runs[1][1] and runs[0][1] != runs[2][1]
    # two batches of 4 per epoch; the last 2 samples of each permutation are
    # dropped, as in JAX
    mlp = nn.init_mlp(torch.Generator().manual_seed(9), hidden=16, device="cpu")
    seen = []
    hook = mlp.layers[0].register_forward_hook(lambda m, i, o: seen.append(i[0].shape[0]))
    nn.train_mlp(x, y, epochs=2, batch_size=4, mlp=mlp)
    hook.remove()
    assert seen == [4, 4, 4, 4]


def test_init_mlp_is_he_normal_with_zero_biases():
    mlp = nn.init_mlp(torch.Generator().manual_seed(0), hidden=256, depth=3,
                      dtype=torch.float64, device="cpu")
    sizes = [(layer.in_features, layer.out_features) for layer in mlp.layers]
    assert sizes == [(9, 256), (256, 256), (256, 256), (256, 976)]
    for layer in mlp.layers:
        m = layer.in_features
        assert layer.weight.dtype == torch.float64
        assert float(layer.weight.std()) == pytest.approx(np.sqrt(2.0 / m), rel=0.1)
        assert (layer.bias == 0).all()
    again = nn.init_mlp(torch.Generator().manual_seed(0), hidden=256, dtype=torch.float64,
                        device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(mlp.parameters(), again.parameters()))


def _stats_np(rng):
    return {"mean_input": rng.standard_normal(9), "std_input": rng.uniform(0.5, 2, 9),
            "mean_X": rng.standard_normal((N, 12)), "std_X": rng.uniform(0.5, 2, (N, 12)),
            "mean_c": rng.standard_normal((N - 1, 12)), "std_c": rng.uniform(0.5, 2, (N - 1, 12)),
            "mean_jpos": rng.standard_normal((N - 1, 12)),
            "std_jpos": rng.uniform(0.5, 2, (N - 1, 12)), "mass": np.asarray(8.252)}


def test_warmstart_files_are_interchangeable(tmp_path):
    rng = np.random.default_rng(5)
    stats = {k: v.astype(np.float32) for k, v in _stats_np(rng).items()}
    # the port's file, read by JAX
    mlp = nn.init_mlp(torch.Generator().manual_seed(1), hidden=32, depth=2, device="cpu")
    path = str(tmp_path / "port.npz")
    nn.save_warmstart(path, mlp, nn.stats_from_numpy(stats, device="cpu"))
    pj, sj = jnn.load_warmstart(path)
    weights, biases, st = convert.mlp_to_numpy(mlp, nn.stats_from_numpy(stats, device="cpu"))
    assert len(pj.weights) == 3
    for a, b in zip(weights + biases, list(pj.weights) + list(pj.biases)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for f in FIELDS:
        np.testing.assert_array_equal(st[f], np.asarray(getattr(sj, f)))
    with np.load(path) as d:
        assert set(d.files) == ({f"w{i}" for i in range(3)} | {f"b{i}" for i in range(3)}
                                | {"n_layers"} | {f"stats_{f}" for f in FIELDS})
        assert d["w0"].shape == (9, 32) and d["w2"].shape == (32, nn.OUTPUT_DIM)

    # the JAX file, read by the port
    p0 = jnn.init_mlp(jax.random.PRNGKey(2), hidden=32, depth=2)
    path_j = str(tmp_path / "jax.npz")
    jnn.save_warmstart(path_j, p0, jnn.DataStats(**{k: jnp.asarray(v) for k, v in stats.items()}))
    mlp_t, st_t = nn.load_warmstart(path_j, device="cpu")
    w_t, b_t, s_t = convert.mlp_to_numpy(mlp_t, st_t)
    for a, b in zip(w_t + b_t, list(p0.weights) + list(p0.biases)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for f in FIELDS:
        np.testing.assert_array_equal(s_t[f], stats[f])
    # and the same network gives the same guess in both packages
    x = rng.standard_normal((3, 9)).astype(np.float32)
    np.testing.assert_allclose(mlp_t(torch.as_tensor(x)).numpy(),
                               np.asarray(jax.vmap(lambda v: jnn.mlp_apply(p0, v))(x)),
                               rtol=1e-5, atol=1e-5)


def test_loaders_default_to_the_card(tmp_path):
    """build_mlp, init_mlp, stats_from_numpy, load_warmstart, the convert
    helpers, analysis.default_vbl_weights, composite_body_inertia of an
    array, problems.default_eeparam_params and
    warmstart.reference.sample_drop_scenario take the card unless given
    device="cpu"; without one they raise, as LandingSolver does."""
    stats = {f: np.zeros(3) for f in FIELDS}
    mlp = nn.init_mlp(torch.Generator().manual_seed(1), hidden=4, depth=1, device="cpu")
    path = str(tmp_path / "ws.npz")
    nn.save_warmstart(path, mlp, nn.stats_from_numpy(stats, device="cpu"))
    weights, biases, st = convert.mlp_to_numpy(mlp, nn.stats_from_numpy(stats, device="cpu"))
    model = get_robot_model("mc3D")
    calls = [lambda **kw: nn.build_mlp(weights, biases, **kw),
             lambda **kw: nn.init_mlp(torch.Generator().manual_seed(1), hidden=4, depth=1, **kw),
             lambda **kw: nn.stats_from_numpy(stats, **kw),
             lambda **kw: nn.load_warmstart(path, **kw),
             lambda **kw: convert.mlp_from_numpy(weights, biases, st, **kw),
             lambda **kw: default_vbl_weights(**kw),
             lambda **kw: composite_body_inertia(model, model.q_home, **kw),
             lambda **kw: default_eeparam_params(batch=2, **kw),
             lambda **kw: sample_drop_scenario(3, torch.Generator().manual_seed(0), **kw),
             lambda **kw: convert.landing_params_from_numpy(
                 {"x_ref": np.zeros((3, 12))}, **kw)]
    for call in calls[:-1]:
        out = call(device="cpu")
        leaf = out[0] if isinstance(out, tuple) else out
        if isinstance(leaf, torch.nn.Module):
            assert next(leaf.parameters()).device.type == "cpu"
        elif isinstance(leaf, torch.Tensor):
            assert leaf.device.type == "cpu"
        else:
            assert all(t.device.type == "cpu" for _, t in tree_flatten(leaf))
    if torch.cuda.is_available():
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
