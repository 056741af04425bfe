"""The port's branch-induced-sparsity kit against the JAX package.

H is the port's ``mass_matrix`` (base lumped) and ``crba_open`` (open chain)
of the mc3D model at three numpy-seeded configurations, handed as the same
numpy arrays to both packages; the tree is the model's parent array.  The
JAX functions take one matrix at a time (a loop of eager calls, not jitted); the port
takes the batch as a leading dimension.  f64, tolerance 1e-12 relative to
the largest entry of the JAX result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.ops import branch_sparsity as jb
from landing_controller_tpu_torch import ops
from landing_controller_tpu_torch.dynamics import featherstone
from landing_controller_tpu_torch.models import get_robot_model
from landing_controller_tpu_torch.ops import branch_sparsity as tb

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

REL = 1e-12


def jloop(fn):
    """fn over the leading axis of its array arguments, one eager JAX call
    each (eager calls share their compiled primitives, where each new
    ``jax.vmap`` compiles its own), the results stacked."""
    def run(*arrays):
        outs = [fn(*(a[i] for a in arrays)) for i in range(arrays[0].shape[0])]
        return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *outs)
    return run


def close(t, j, rel=REL):
    j = np.asarray(j)
    t = t.numpy()
    assert t.shape == j.shape, (t.shape, j.shape)
    assert np.abs(t - j).max() <= rel * max(1.0, np.abs(j).max())


@pytest.fixture(scope="module", params=["mass_matrix", "crba_open"])
def system(request):
    """H (3, 18, 18), lam, b (3, 18) as numpy, and JAX's factors of H: ltdl's
    (L, d) and ltl's L, computed once."""
    model = get_robot_model("mc3D")
    rng = np.random.default_rng(31)
    q = np.concatenate([rng.uniform(-0.3, 0.3, (3, 3)) + [0, 0, 0.4],
                        rng.uniform(-0.3, 0.3, (3, 3)), rng.uniform(-0.6, 0.6, (3, 12))], 1)
    qt = torch.as_tensor(q)
    if request.param == "mass_matrix":
        H = featherstone.mass_matrix(model, qt)[0]
    else:
        H = featherstone.crba_open(model, qt)
    lam = np.asarray(model.parent, np.int64)
    Lj, dj = jloop(lambda h: jb.ltdl(h, lam))(jnp.asarray(H.numpy()))
    L_ltl = np.asarray(Lj) * np.sqrt(np.asarray(dj))[:, :, None]  # JAX ltl's own formula
    return dict(H=H.numpy(), lam=lam, b=rng.standard_normal((3, 18)), L=Lj, d=dj, L_ltl=L_ltl)


def test_ltdl(system):
    H, lam = system["H"], system["lam"]
    L, d = tb.ltdl(torch.as_tensor(H), lam)
    close(L, system["L"])
    close(d, system["d"])
    np.testing.assert_allclose((L.transpose(1, 2) @ torch.diag_embed(d) @ L).numpy(), H,
                               rtol=1e-9, atol=1e-10)


def test_ltl(system):
    H, lam = system["H"], system["lam"]
    close(tb.ltl(torch.as_tensor(H), lam), system["L_ltl"])
    close(tb.ltl(torch.as_tensor(H[:1]), lam), jb.ltl(jnp.asarray(H[0]), lam)[None])


@pytest.mark.parametrize("name", ["mpy_l", "mpy_lt", "solve_l", "solve_lt", "solve_ltl"])
def test_triangular_products_and_solves(system, name):
    H, lam, b = system["H"], system["lam"], system["b"]
    L = jnp.asarray(system["L_ltl"])
    fj, ft = getattr(jb, name), getattr(tb, name)
    out = ft(torch.as_tensor(system["L_ltl"]), lam, torch.as_tensor(b))
    close(out, jloop(lambda l_, x: fj(l_, lam, x))(L, jnp.asarray(b)))
    if name == "solve_ltl":
        np.testing.assert_allclose(np.einsum("bij,bj->bi", H, out.numpy()), b, rtol=1e-8, atol=1e-8)


def test_mpy_h(system):
    H, lam, b, L, d = (system[k] for k in ("H", "lam", "b", "L", "d"))
    out = tb.mpy_h(torch.as_tensor(np.array(L)), torch.as_tensor(np.array(d)), lam,
                   torch.as_tensor(b))
    close(out, jloop(lambda l_, d_, x: jb.mpy_h(l_, d_, lam, x))(L, d, jnp.asarray(b)))
    np.testing.assert_allclose(out.numpy(), np.einsum("bij,bj->bi", H, b), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("lam,nf", [([-1, 0], [3, 2]), ([-1, 0, 0, 2], [6, 1, 2, 3]),
                                    ([-1, 0, 1], [1, 1, 1])])
def test_expand_lambda(lam, nf):
    np.testing.assert_array_equal(tb.expand_lambda(lam, nf), jb.expand_lambda(lam, nf))


def test_exported_from_ops():
    for name in ("expand_lambda", "ltdl", "ltl", "mpy_h", "mpy_l", "mpy_lt", "solve_l", "solve_lt",
                 "solve_ltl"):
        assert getattr(ops, name) is getattr(tb, name)
        assert name in ops.__all__
