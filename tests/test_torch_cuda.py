"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these tests need an NVIDIA GPU with the CUDA toolkit and
skip where ``torch.cuda.is_available()`` is False.  On the card run them
with ``python -m pytest tests/test_torch_cuda.py``.
"""

import ctypes
import importlib.util
import os

import numpy as np
import pytest
import torch

from landing_controller_tpu_torch.ops import cri_factor, cri_solve, make_qd_inverse, pallas_blocks
from landing_controller_tpu_torch.ops.pallas_blocks import (chol_inverse, chol_inverse_ref, qd_inverse,
                                                           qd_inverse_ref)
from landing_controller_tpu_torch.tracing import counters

pytestmark = pytest.mark.cuda


def launches(op):
    return counters()[f"{op}.launches"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _random_qd_blocks(rng, m, np_, nd):
    bs = np_ + nd
    P = rng.standard_normal((m, np_, np_))
    P = P @ P.transpose(0, 2, 1) / np_ + np.eye(np_)[None] * 0.5
    D = rng.standard_normal((m, nd, nd))
    D = D @ D.transpose(0, 2, 1) / nd + np.eye(nd)[None] * 0.5
    B = 0.5 * rng.standard_normal((m, nd, np_))
    S = np.zeros((m, bs, bs))
    S[:, :np_, :np_] = P
    S[:, np_:, :np_] = B
    S[:, :np_, np_:] = B.transpose(0, 2, 1)
    S[:, np_:, np_:] = -D
    return S.astype(np.float32)


# rtol=atol=2e-4: f32 with a different summation order than the plain
# version (the JAX package's own kernel-vs-reference tolerance)
@pytest.mark.parametrize("np_,nd,m", [(7, 4, 5), (36, 24, 1280), (48, 36, 64), (36, 40, 64),
                                      (30, 20, 64), (48, 36, 5120)])
def test_kernel_matches_plain(dev, np_, nd, m):
    S = _random_qd_blocks(np.random.default_rng(m), m, np_, nd)
    S[1, 0, 0] = -5.0  # indefinite: ok must be False
    S = torch.as_tensor(S, device=dev)
    out_k, ok_k = qd_inverse(S, np_, nd)
    out_p, ok_p = qd_inverse_ref(S, np_, nd)
    torch.cuda.synchronize()
    assert torch.equal(ok_k, ok_p) and not bool(ok_k[1]) and int(ok_k.sum()) == m - 1
    assert torch.isfinite(out_k[ok_k]).all()
    torch.testing.assert_close(out_k[ok_k], out_p[ok_k], rtol=2e-4, atol=2e-4)


# the compile-time instances, the run-time instance ((30, 20) and (7, 4), whose
# width 11 is no multiple of 4), one block and one block more than the card's
# 132 SMs
@pytest.mark.parametrize("m", [1, 133])
@pytest.mark.parametrize("np_,nd", [(36, 24), (48, 36), (36, 40), (30, 20), (7, 4)])
def test_kernel_instances_and_batch_sizes(dev, np_, nd, m):
    S = torch.as_tensor(_random_qd_blocks(np.random.default_rng(np_ + m), m, np_, nd), device=dev)
    out_k, ok_k = qd_inverse(S, np_, nd)
    out_p, ok_p = qd_inverse_ref(S, np_, nd)
    torch.cuda.synchronize()
    assert bool(ok_k.all()) and bool(ok_p.all())
    torch.testing.assert_close(out_k, out_p, rtol=2e-4, atol=2e-4)
    assert torch.equal(out_k, out_k.transpose(1, 2))  # symmetric bit for bit
    again, ok_again = qd_inverse(S, np_, nd)
    assert torch.equal(again, out_k) and torch.equal(ok_again, ok_k)  # and repeatable


def test_kernel_follows_pallas_pivot_clamp(dev):
    """P = I, B = 0, D = diag(1e-37, 1, ...): a positive pivot below the
    1e-30 clamp.  Like the Pallas kernel (tests/test_torch_qd_inverse.py),
    the kernel flags the block ok and its values overflow; the plain
    version inverts it."""
    np_, nd = 12, 8
    S = np.zeros((1, np_ + nd, np_ + nd), np.float32)
    S[0, :np_, :np_] = np.eye(np_)
    S[0, np_:, np_:] = -np.eye(nd)
    S[0, np_, np_] = -1e-37
    S = torch.as_tensor(S, device=dev)
    out_k, ok_k = qd_inverse(S, np_, nd)
    out_p, ok_p = qd_inverse_ref(S, np_, nd)
    assert bool(ok_k[0]) and bool(ok_p[0])
    assert not bool(torch.isfinite(out_k).all()) and bool(torch.isfinite(out_p).all())


def test_kernel_counts_launches_and_checks_inputs(dev):
    S = torch.as_tensor(_random_qd_blocks(np.random.default_rng(0), 3, 6, 4), device=dev)
    before = launches("qd_inverse")
    qd_inverse(S, 6, 4)
    qd_inverse(S.cpu(), 6, 4)  # the plain version: not a launch
    assert launches("qd_inverse") == before + 1
    # f64 goes through the kernel's double instance, which agrees with the
    # plain version in f64; any other type raises
    out64, ok64 = qd_inverse(S.double(), 6, 4)
    assert launches("qd_inverse") == before + 2 and out64.dtype == torch.float64
    ref64, ok_ref64 = qd_inverse_ref(S.double(), 6, 4)
    assert torch.equal(ok64, ok_ref64) and bool(ok64.all())
    torch.testing.assert_close(out64, ref64, rtol=1e-10, atol=1e-10)
    with pytest.raises(TypeError):
        qd_inverse(S.half(), 6, 4)
    with pytest.raises(ValueError):
        qd_inverse(S, 5, 4)
    # a non-contiguous view is accepted (the wrapper makes it contiguous)
    St = S.transpose(1, 2)
    torch.testing.assert_close(qd_inverse(St, 6, 4)[0], qd_inverse_ref(St.contiguous(), 6, 4)[0],
                               rtol=2e-4, atol=2e-4)


def test_cri_solve_through_kernel(dev):
    rng = np.random.default_rng(5)
    np_, nd, nb = 36, 24, 21
    A = _random_qd_blocks(rng, 2 * nb, np_, nd).reshape(2, nb, 60, 60)
    C = (0.01 * rng.standard_normal((2, nb - 1, 60, 60))).astype(np.float32)
    b = rng.standard_normal((2, nb, 60)).astype(np.float32)
    fn = make_qd_inverse(np_, nd)
    fac = cri_factor(torch.as_tensor(A, device=dev), torch.as_tensor(C, device=dev), fn)
    assert bool(fac.ok.all())
    x = cri_solve(fac, torch.as_tensor(b, device=dev))
    x64 = cri_solve(cri_factor(torch.as_tensor(A, dtype=torch.float64),
                               torch.as_tensor(C, dtype=torch.float64), fn),
                    torch.as_tensor(b, dtype=torch.float64))
    torch.testing.assert_close(x.cpu().double(), x64, rtol=1e-3, atol=1e-3)


def _random_spd(rng, m, n):
    A = rng.standard_normal((m, n, n))
    return (A @ A.transpose(0, 2, 1) / n + np.eye(n)[None] * 0.5).astype(np.float32)


# rtol=atol=2e-4: the JAX package's own Pallas-vs-reference tolerance; n = 84
# takes more than 48 KB of dynamic shared memory
@pytest.mark.parametrize("n,m", [(5, 3), (24, 257), (36, 640), (48, 5120), (84, 64)])
def test_chol_kernel_matches_plain(dev, n, m):
    A = _random_spd(np.random.default_rng(n), m, n)
    A[1, 0, 0] = -5.0  # indefinite: ok must be False
    A = torch.as_tensor(A, device=dev)
    out_k, ok_k = chol_inverse(A)
    out_p, ok_p = chol_inverse_ref(A)
    torch.cuda.synchronize()
    assert torch.equal(ok_k, ok_p) and not bool(ok_k[1]) and int(ok_k.sum()) == m - 1
    assert torch.isfinite(out_k[ok_k]).all()
    torch.testing.assert_close(out_k[ok_k], out_p[ok_k], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(out_k[ok_k], out_k[ok_k].transpose(1, 2), rtol=0, atol=0)


@pytest.mark.parametrize("m", [1, 133])
@pytest.mark.parametrize("n", [36, 48, 24, 5, 84])
def test_chol_kernel_instances_and_batch_sizes(dev, n, m):
    A = torch.as_tensor(_random_spd(np.random.default_rng(n + m), m, n), device=dev)
    out_k, ok_k = chol_inverse(A)
    out_p, ok_p = chol_inverse_ref(A)
    torch.cuda.synchronize()
    assert bool(ok_k.all()) and bool(ok_p.all())
    torch.testing.assert_close(out_k, out_p, rtol=2e-4, atol=2e-4)
    assert torch.equal(out_k, out_k.transpose(1, 2))
    again, ok_again = chol_inverse(A)
    assert torch.equal(again, out_k) and torch.equal(ok_again, ok_k)


def test_kernels_take_views_and_the_current_stream(dev):
    """Every second block of a larger batch, a view that starts 4 bytes into
    its buffer (not 16-byte aligned) and a launch on another stream than the
    default give the bits of a plain contiguous launch."""
    S = torch.as_tensor(_random_qd_blocks(np.random.default_rng(2), 64, 36, 24), device=dev)
    A = torch.as_tensor(_random_spd(np.random.default_rng(2), 64, 48), device=dev)
    for fn, x in ((lambda t: qd_inverse(t, 36, 24), S), (chol_inverse, A)):
        want, ok = fn(x)
        assert bool(ok.all())
        strided = torch.repeat_interleave(x, 2, dim=0)[::2]
        assert not strided.is_contiguous()
        assert torch.equal(fn(strided)[0], want)
        flat = torch.empty(x.numel() + 1, device=dev)
        flat[1:] = x.flatten()
        shifted = flat[1:].view(x.shape)
        assert shifted.data_ptr() % 16 == 4
        assert torch.equal(fn(shifted)[0], want)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            other, ok_other = fn(x)
        stream.synchronize()
        assert torch.equal(other, want) and bool(ok_other.all())


def test_occupancy_and_shared_memory_of_the_paths_instances(dev):
    """The card holds at least twice the three blocks per SM of the first
    kernel at the kinodynamic shape, and the library's shared-memory size is
    the Python mirror's."""
    assert pallas_blocks.blocks_per_sm("qd_inverse", 48, 36) >= 6
    assert pallas_blocks.blocks_per_sm("qd_inverse", 36, 24) >= 6
    assert pallas_blocks.blocks_per_sm("chol_inverse", 48) >= 6
    for np_, nd in ((36, 24), (48, 36), (36, 40), (7, 4), (30, 20)):
        assert (pallas_blocks.library_smem_bytes("qd_inverse", np_, nd)
                == pallas_blocks.qd_inverse_smem_bytes(np_, nd))
    for n in (5, 24, 36, 48, 84):
        assert (pallas_blocks.library_smem_bytes("chol_inverse", n)
                == pallas_blocks.chol_inverse_smem_bytes(n))


def test_build_variants_of_the_probe_compile_and_agree(dev):
    """tests/probe_block_kernels.py builds the header for other numbers of
    threads per block and with its clock stamps: two of those builds launch
    and agree with the plain version, and the stamped one counts cycles in
    every phase it names."""
    spec = importlib.util.spec_from_file_location(
        "probe_block_kernels",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "probe_block_kernels.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    S = torch.as_tensor(_random_qd_blocks(np.random.default_rng(4), 133, 48, 36), device=dev)
    want, ok_want = qd_inverse_ref(S, 48, 36)
    stream = torch.cuda.current_stream().cuda_stream
    for threads, min_blocks, clocks in ((64, 8, False), (128, 1, True)):
        lib = probe.build(threads, min_blocks, clocks=clocks)
        out, ok = torch.empty_like(S), torch.empty(133, dtype=torch.bool, device=dev)
        if clocks:
            assert lib.qd_inverse_zero_clocks() == 0
        assert lib.qd_inverse_launch(S.data_ptr(), out.data_ptr(), ok.data_ptr(), 133, 48, 36,
                                     stream) == 0
        torch.cuda.synchronize()
        assert torch.equal(ok, ok_want) and bool(ok.all())
        torch.testing.assert_close(out, want, rtol=2e-4, atol=2e-4)
        if clocks:
            counters = (ctypes.c_longlong * (2 * len(probe.PHASES)))()
            assert lib.qd_inverse_read_clocks(counters) == 0
            assert min(counters) > 0


def test_chol_kernel_follows_pallas_pivot_clamp(dev):
    """diag(1e-37, 1, ...): a positive pivot below the 1e-30 clamp.  Like the
    Pallas kernel (tests/test_torch_chol_inverse.py), the kernel flags the
    block ok and its values overflow; the plain version inverts it."""
    A = np.eye(8, dtype=np.float32)[None].copy()
    A[0, 0, 0] = 1e-37
    A = torch.as_tensor(A, device=dev)
    out_k, ok_k = chol_inverse(A)
    out_p, ok_p = chol_inverse_ref(A)
    assert bool(ok_k[0]) and bool(ok_p[0])
    assert not bool(torch.isfinite(out_k).all()) and bool(torch.isfinite(out_p).all())


def test_chol_kernel_counts_launches_and_checks_inputs(dev):
    A = torch.as_tensor(_random_spd(np.random.default_rng(0), 3, 6), device=dev)
    before = launches("chol_inverse")
    chol_inverse(A)
    chol_inverse(A.cpu())  # the plain version: not a launch
    assert launches("chol_inverse") == before + 1
    out64, ok64 = chol_inverse(A.double())  # the double instance
    assert launches("chol_inverse") == before + 2 and bool(ok64.all())
    torch.testing.assert_close(out64, chol_inverse_ref(A.double())[0], rtol=1e-10, atol=1e-10)
    with pytest.raises(TypeError):
        chol_inverse(A.half())
    with pytest.raises(ValueError):
        chol_inverse(A[:, :5])
    with pytest.raises(ValueError):
        chol_inverse(torch.zeros((2, 85, 85), device=dev))
    # a non-contiguous view is accepted (the wrapper makes it contiguous)
    At = A.transpose(1, 2)
    torch.testing.assert_close(chol_inverse(At)[0], chol_inverse_ref(At.contiguous())[0],
                               rtol=2e-4, atol=2e-4)


def test_non_finite_blocks_fail_in_kernels_and_plain_versions(dev):
    """A NaN or an infinity in a block (the reduced block of a failed ladder
    candidate) fails the pivot test of both kernels and, on the card too, of
    both plain versions, whose library Cholesky may report success on it."""
    S = _random_qd_blocks(np.random.default_rng(9), 5, 12, 8)
    S[1, 3, 3] = np.nan
    S[2, 14, 2] = S[2, 2, 14] = np.inf
    S[3, 15, 15] = np.nan
    S = torch.as_tensor(S, device=dev)
    want = [True, False, False, False, True]
    assert qd_inverse(S, 12, 8)[1].tolist() == want
    assert qd_inverse_ref(S, 12, 8)[1].tolist() == want
    A = _random_spd(np.random.default_rng(3), 4, 9)
    A[1, 2, 2] = np.nan
    A[2, 5, 1] = A[2, 1, 5] = np.inf
    A = torch.as_tensor(A, device=dev)
    assert chol_inverse(A)[1].tolist() == [True, False, False, True]
    assert chol_inverse_ref(A)[1].tolist() == [True, False, False, True]


# rtol=atol=1e-10: an f64 factorization in another summation order than the
# plain version's, on blocks whose condition numbers stay below 1e3
@pytest.mark.parametrize("np_,nd,m", [(36, 24, 1280), (48, 36, 5120), (36, 40, 64), (30, 20, 133),
                                      (7, 4, 5)])
def test_f64_kernel_matches_plain(dev, np_, nd, m):
    S = _random_qd_blocks(np.random.default_rng(m + 64), m, np_, nd).astype(np.float64)
    S[1, 0, 0] = -5.0
    S = torch.as_tensor(S, device=dev)
    out_k, ok_k = qd_inverse(S, np_, nd)
    out_p, ok_p = qd_inverse_ref(S.cpu(), np_, nd)
    torch.cuda.synchronize()
    assert out_k.dtype == torch.float64
    assert torch.equal(ok_k.cpu(), ok_p) and not bool(ok_k[1]) and int(ok_k.sum()) == m - 1
    torch.testing.assert_close(out_k[ok_k].cpu(), out_p[ok_p], rtol=1e-10, atol=1e-10)
    assert torch.equal(out_k[ok_k], out_k[ok_k].transpose(1, 2))  # symmetric bit for bit


@pytest.mark.parametrize("n,m", [(48, 5120), (84, 64), (5, 3)])
def test_f64_chol_kernel_matches_plain(dev, n, m):
    A = _random_spd(np.random.default_rng(n + 7), m, n).astype(np.float64)
    A = torch.as_tensor(A, device=dev)
    out_k, ok_k = chol_inverse(A)
    out_p, ok_p = chol_inverse_ref(A.cpu())
    torch.cuda.synchronize()
    assert bool(ok_k.all()) and bool(ok_p.all())
    torch.testing.assert_close(out_k.cpu(), out_p, rtol=1e-10, atol=1e-10)
    assert torch.equal(out_k, out_k.transpose(1, 2))


def test_f64_occupancy_and_shared_memory(dev):
    """The double instances' shared memory as the library sizes it equals the
    Python mirror, also above 48 KB, and every instance the paths run keeps at
    least one block on an SM."""
    for np_, nd in ((36, 24), (48, 36), (36, 40), (30, 20)):
        assert (pallas_blocks.library_smem_bytes("qd_inverse", np_, nd, dtype=torch.float64)
                == pallas_blocks.qd_inverse_smem_bytes(np_, nd, torch.float64))
        assert pallas_blocks.blocks_per_sm("qd_inverse", np_, nd, dtype=torch.float64) >= 1
    for n in (36, 48, 84):
        assert (pallas_blocks.library_smem_bytes("chol_inverse", n, dtype=torch.float64)
                == pallas_blocks.chol_inverse_smem_bytes(n, torch.float64))
        assert pallas_blocks.blocks_per_sm("chol_inverse", n, dtype=torch.float64) >= 1


def test_f64_solver_goes_through_the_kernel(dev):
    """LandingSolver("srbm_lcp", dtype=torch.float64) on the card solves
    through cri and the kernel's double instance, as the CPU solve does
    through the plain version, to the same cost."""
    from landing_controller_tpu_torch import LandingSolver

    q0, qd0 = [0.0, 0.0, 0.45, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, -0.5]
    before = launches("qd_inverse")
    s_gpu = LandingSolver("srbm_lcp", dtype=torch.float64, device="cuda").solve(q0, qd0)
    assert launches("qd_inverse") > before
    s_cpu = LandingSolver("srbm_lcp", dtype=torch.float64, device="cpu").solve(q0, qd0)
    assert bool(s_gpu.converged) and bool(s_cpu.converged)
    assert abs(float(s_gpu.cost) - float(s_cpu.cost)) <= 1e-6 * abs(float(s_cpu.cost))


def test_custom_ops_launch_the_kernels_and_trace(dev):
    """The registered ops launch the kernels on the card (one count per
    call), the launchers' input errors keep their types through the
    dispatcher, and a fake-tensor trace launches nothing."""
    from torch.fx.experimental.proxy_tensor import make_fx

    S = torch.as_tensor(_random_qd_blocks(np.random.default_rng(1), 8, 6, 4), device=dev)
    A = S[:, :6, :6].contiguous()
    for op, fn, args in (("qd_inverse", qd_inverse, (S, 6, 4)), ("chol_inverse", chol_inverse, (A,))):
        before = launches(op)
        out, ok = getattr(torch.ops.landing_controller_tpu_torch, op)(*args)
        torch.cuda.synchronize()
        assert launches(op) == before + 1 and out.is_contiguous() and bool(ok.all())
        torch.library.opcheck(getattr(torch.ops.landing_controller_tpu_torch, op).default, args,
                              test_utils=("test_schema", "test_faketensor"))
        before = launches(op)
        gm = make_fx(lambda *a: fn(*a), tracing_mode="fake")(*args)
        assert f"landing_controller_tpu_torch.{op}.default" in [str(n.target) for n in gm.graph.nodes]
        assert launches(op) == before
    with pytest.raises(TypeError):
        torch.ops.landing_controller_tpu_torch.qd_inverse(S.half(), 6, 4)
    with pytest.raises(ValueError):
        torch.ops.landing_controller_tpu_torch.qd_inverse(S, 5, 4)


def _graph_and_eager_runs(ss_of, P):
    """Two streams from ``ss_of()`` over the same pool: the live step (its
    iterations replayed from one captured CUDA graph) and the same step with
    its iterations run eagerly.  Returns, for each, the packed results and
    the lanes' z after every segment and the counters the run added."""
    out = []
    for live in (True, False):
        ss = ss_of()
        step = ss._compose(ss._iterate, lambda pool, carry: ss._harvest(pool, carry, P), live=live)
        seen = []

        def recording(pool, carry, step=step, seen=seen):
            carry = step(pool, carry)
            seen.append((carry.res.cpu().numpy(), carry.lanes.state.z.clone()))
            return carry

        ss._step_cache[P] = recording
        before = counters()
        ss.run(P)
        torch.cuda.synchronize()
        out.append((seen, counters() - before, ss))
    return out


def _kino_graph_solver():
    from landing_controller_tpu_torch import LandingSolver
    from landing_controller_tpu_torch.tools.common import kino_config

    cfg = kino_config(ladder_scales=(0.0, 1.0, 10.0, 1000.0), n_linesearch=12)
    return LandingSolver("kinodynamic", dtype=torch.float32, config=cfg, guess="reference",
                         retry_guess="nn", device="cuda")


@pytest.mark.parametrize("kind", ["srbm_lcp", "kinodynamic"])
def test_stream_graph_replays_match_the_eager_iterations(dev, kind):
    """The stream's captured iteration, replayed, gives what the eager
    iterations give: B=8 lanes over a pool of 20 with deadlines (20, 20) and
    segments of 10, so that lanes time out, retry, finish and are refilled
    over several harvests.  The result rows agree exactly (finished,
    converged, iterations, attempts) and to 1e-5 relative (violation), the
    lanes' z to 1e-5 relative after every segment, and the counters read
    the same on both paths; the graph run captures once."""
    from landing_controller_tpu_torch.bench import bench_solver, bench_stream, make_sampler

    solver = bench_solver() if kind == "srbm_lcp" else _kino_graph_solver()
    (g_seen, g_count, g_ss), (e_seen, e_count, e_ss) = _graph_and_eager_runs(
        lambda: bench_stream(solver, make_sampler(3), batch=8, segment=10, attempt_iters=(20, 20)),
        20)
    assert len(g_seen) == len(e_seen) >= 4
    assert e_seen[-1][0][0, :20].sum() == 20 and e_seen[-1][0][4, :20].max() == 2  # retried
    for (g_res, g_z), (e_res, e_z) in zip(g_seen, e_seen, strict=True):
        np.testing.assert_array_equal(g_res[[0, 1, 2, 4]], e_res[[0, 1, 2, 4]])
        np.testing.assert_allclose(g_res[3], e_res[3], rtol=1e-5, atol=1e-12)
        assert float((g_z - e_z).norm()) <= 1e-5 * float(e_z.norm())
    assert g_count["stream.graph_captures"] == 1 and len(g_ss._graphs) == 1
    assert g_count["stream.graph_replays"] == g_count["ip.iterations"] > 0
    assert e_count["stream.graph_captures"] == 0 and e_ss._graphs == {}
    assert e_count["stream.eager_iterations"] == e_count["ip.iterations"]
    for name in ("qd_inverse.launches", "ip.iterations", "stream.finished", "stream.retried"):
        assert g_count[name] == e_count[name], name
    assert e_count["qd_inverse.launches"] == 6 * e_count["ip.iterations"] > 0
    # a second run of the same stream replays the graph it has
    before = counters()
    g_ss.run(8)
    assert (counters() - before)["stream.graph_captures"] == 0


def test_eeparam_graph_replays_equal_the_eager_iterations_bit_for_bit(dev):
    """The eeParam kind's captured iteration (the dense KKT step: the
    Cholesky ladder, the Schur complement, the forward-mode derivatives),
    replayed, gives bit for bit what its eager iterations give: B=8 lanes
    over 8 drops of the eeParam sweep, one segment of 25 iterations, after
    which every drop finishes.  The result rows, the lanes' z and the
    counters (``dense_kkt.emergency`` on the device among them) are equal."""
    from landing_controller_tpu_torch import LandingSolver, StreamingSolver

    rng = np.random.default_rng(5)
    q = np.zeros((8, 6), np.float32)
    qd = np.zeros((8, 6), np.float32)
    q[:, 2] = rng.uniform(0.45, 0.65, 8)
    q[:, 4] = rng.uniform(-0.2, 0.2, 8)
    qd[:, 5] = -rng.uniform(0.5, 1.5, 8)
    solver = LandingSolver("eeparam", n_knots=10, structured=False, device="cuda")
    (g_seen, g_count, g_ss), (e_seen, e_count, e_ss) = _graph_and_eager_runs(
        lambda: StreamingSolver(solver, batch=8, segment=25, sampler=lambda n: (q[:n], qd[:n]),
                                attempt_iters=(25,)), 8)
    assert len(g_seen) == len(e_seen) == 1 and e_seen[0][0][0, :8].sum() == 8
    for (g_res, g_z), (e_res, e_z) in zip(g_seen, e_seen, strict=True):
        np.testing.assert_array_equal(g_res, e_res)
        assert torch.equal(g_z, e_z)
    assert g_count["stream.graph_captures"] == 1 and g_count["stream.graph_replays"] == 25
    assert e_count["stream.graph_captures"] == 0 and e_count["stream.eager_iterations"] == 25
    for name in ("ip.iterations", "stream.finished", "dense_kkt.emergency", "dense_kkt.lane_iterations"):
        assert g_count[name] == e_count[name], name
    assert e_count["dense_kkt.lane_iterations"] == 8 * 25


def test_eeparam_graph_counts_emergency_shifts_on_the_device(dev):
    """``dense_kkt.emergency`` summed on the device inside the captured
    iteration and read with the stream's one read per segment: with a ladder
    whose one shift (-1, below every equilibrated Hessian's least eigenvalue)
    never factors, every lane-iteration takes the emergency shift, and the
    graph run and the eager run both count 8 lanes x 25 iterations (the
    capture's warm-up iterations taken back)."""
    import dataclasses

    from landing_controller_tpu_torch import LandingSolver, StreamingSolver
    from landing_controller_tpu_torch.api import _eeparam_ip_config

    rng = np.random.default_rng(6)
    q = np.zeros((8, 6), np.float32)
    qd = np.zeros((8, 6), np.float32)
    q[:, 2] = rng.uniform(0.45, 0.65, 8)
    q[:, 4] = rng.uniform(-0.2, 0.2, 8)
    qd[:, 5] = -rng.uniform(0.5, 1.5, 8)
    cfg = dataclasses.replace(_eeparam_ip_config(torch.float32), delta_w=-1.0, ladder_scales=(0.0,))
    solver = LandingSolver("eeparam", n_knots=10, config=cfg, device="cuda")
    (g_seen, g_count, _), (e_seen, e_count, _) = _graph_and_eager_runs(
        lambda: StreamingSolver(solver, batch=8, segment=25, sampler=lambda n: (q[:n], qd[:n]),
                                attempt_iters=(25,)), 8)
    for (g_res, g_z), (e_res, e_z) in zip(g_seen, e_seen, strict=True):
        np.testing.assert_array_equal(g_res, e_res)
        assert torch.equal(g_z, e_z)
    assert g_count["stream.graph_replays"] == 25 and e_count["stream.eager_iterations"] == 25
    for c in (g_count, e_count):
        assert c["dense_kkt.emergency"] == c["dense_kkt.lane_iterations"] == 8 * 25


def test_dense_stream_graph_replays_match_the_eager_iterations(dev):
    """The captured iteration of a landing kind on the dense KKT step
    (``kinodynamic_voltage``, which always takes it), replayed, gives what
    its eager iterations give: B=8 lanes over a pool of 12 with deadlines
    (10, 10) and segments of 5, so that lanes time out, retry and are
    refilled.  The rows agree exactly (finished, converged, iterations,
    attempts) and to 1e-5 relative (violation), the lanes' z to 1e-5
    relative after every segment, and the counters read the same."""
    from landing_controller_tpu_torch import LandingSolver
    from landing_controller_tpu_torch.bench import bench_stream, make_sampler

    solver = LandingSolver("kinodynamic_voltage", dtype=torch.float32, retry_guess="ballistic",
                           device="cuda")
    (g_seen, g_count, g_ss), (e_seen, e_count, e_ss) = _graph_and_eager_runs(
        lambda: bench_stream(solver, make_sampler(3), batch=8, segment=5, attempt_iters=(10, 10)),
        12)
    assert len(g_seen) == len(e_seen) >= 4
    assert e_seen[-1][0][4, :12].max() == 2  # retried
    for (g_res, g_z), (e_res, e_z) in zip(g_seen, e_seen, strict=True):
        np.testing.assert_array_equal(g_res[[0, 1, 2, 4]], e_res[[0, 1, 2, 4]])
        np.testing.assert_allclose(g_res[3], e_res[3], rtol=1e-5, atol=1e-12)
        assert float((g_z - e_z).norm()) <= 1e-5 * float(e_z.norm())
    assert g_count["stream.graph_captures"] == 1 and len(g_ss._graphs) == 1
    assert g_count["stream.graph_replays"] == g_count["ip.iterations"] > 0
    assert e_count["stream.graph_captures"] == 0 and e_ss._graphs == {}
    for name in ("ip.iterations", "stream.finished", "stream.retried", "dense_kkt.emergency",
                 "dense_kkt.lane_iterations"):
        assert g_count[name] == e_count[name], name
