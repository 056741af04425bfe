"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero, before the result line):

1. device: CUDA must be available; prints torch's version, the card's name
   and power limit, and the TF32 flags;
2. build: compiles every CUDA kernel of the port from ``csrc/`` (one nvcc
   process per source, all started together);
3. kernel parity: every kernel against its plain PyTorch version on the
   card, on random inputs at the paths' shapes (the compile-time instances,
   and the run-time instance at a shape no template serves), results
   symmetric bit for bit, with timings at the largest level and at a
   one-wave level of each family, and each instance's shared memory and
   resident blocks per SM;
4. the srbm_lcp path: the streaming solve of the repo's benchmark settings
   (B=64, 25-iteration segments, deadlines (100, 150), ballistic guess with
   an NN retry, production dt schedule) over one pool of 64 scenarios, with
   the kernel launch counts of that run;
5. checks of its output: kernel parity on the real KKT blocks captured from
   several block-inverse calls of the run, feasibility of the harvested
   solutions, and one gentle drop solved on the card and on the CPU (plain
   versions) with agreeing costs (this one beside phases 10-20);
6. the kinodynamic path: ``LandingSolver("kinodynamic")`` at N=21 with the
   family's settings (monotone barrier rule, hybrid Hessian, refine 3,
   reference guess), ``solve_batch`` on 128 drop scenarios, with launch
   counts, launch sizes, peak memory, feasibility of the converged
   solutions and kernel parity on its captured 84-wide KKT blocks;
7. the srbm variants, one scenario each: sliding, contact_scheduled (with
   kernel parity on its 76-wide blocks) and ccc (41 blocks), beside phases
   10-20;
8. the ``ops.chol_inverse`` entry point on the SPD sub-blocks of the
   captured KKT blocks of both families: its launch count, then the kernel
   against its plain version and an f64 inverse;
9. profile: host time, device time and kernel launches per IP iteration at
   B=64 for the srbm_lcp and the kinodynamic solver, and at B=32 for the
   dense kinodynamic_voltage solver (host clock, then torch.profiler);
10. the dense KKT path: ``LandingSolver("kinodynamic_voltage")`` at N=21 with
   its default settings, ``solve_batch`` on the first 32 drops of phase 6,
   with peak memory, feasibility and the largest motor voltage read back
   from the voltage rows; then ``structured=False`` kinodynamic on 8 of
   them against phase 6's structured solutions;
11. ``EEParamSolver`` (f32, default settings), ``solve_batch`` on 32 drops of
   the eeParam benchmark's sampler (tools/eeparam_bench.py:68-80);
12. the structured backends: srbm_lcp ``solve_batch`` on 16 bench-sampler
   scenarios under kkt_backend "scan", "cr" and "cri";
13. the cascade (srbm_lcp -> kinodynamic) on the first 32 drops of phase 6,
   beside phase 6's cold solves of them, and a ``Replanner`` that plans 8
   scenarios and replans each once from a nudged measured state;
14. the training-data factory with the settings of tools/train_warmstart.py
   (streaming kinodynamic solves, B=64, 50-iteration segments, NN retry, 64
   drops), then on the card the normalization statistics, 400 epochs of
   training, the network saved under ``build/`` and read back, a solver
   that takes it as its guess, and ``nn_vs_nlp`` on one drop;
15. the four-regime warm-start comparison on the committed network;
16. ``monte_carlo_envelope`` of srbm_lcp (64 drops) with the native
   scenario pool and a result log under ``build/``, read back; then
   ``sweep_foot_positions`` over 8 values of v_x on the ccc solver; two
   ranks under NCCL where the machine has two cards;
17. f64 on the card: phase 12's srbm_lcp ``solve_batch`` in f64 and in f32
   on cri, then phase 16's ccc foot sweep in f64, all through the kernel's
   double instance;
18. the rigid-body dynamics layer at batch scale: FK, CRBA, RNEA, forward
   dynamics, rotors, energy and the tree-sparse factorization over 65,536
   seeded configurations in f32 and f64 (ms and kernel launches per call,
   the first 256 lanes against the CPU in f64), then ``joint_pd_sim`` of
   1,024 drops for 500 steps;
19. the VBL Riccati value function along every converged trajectory of
   phase 4, in f64, held against the CPU on two of them;
20. the deployment surface: the kernels' build cache under ``build/``,
   phase 4's solver saved for a batch of 64 (``runtime.save_solver``) and
   loaded by a fresh process that imports neither the problems nor the
   api, its solve of phase 4's pool held against the live ``solve_batch``
   (converged set, iterations, z) with its ``qd_inverse`` launches counted
   there, host and device time per IP iteration live against loaded; the
   StreamingSolver's step saved and loaded (``export_step``,
   ``load_step``) and its run held against phase 4's, a mismatched key
   refused; ``export_html`` and ``motor_voltages`` of a converged
   kinodynamic trajectory of phase 6;
21. the entry points: ``python -m landing_controller_tpu_torch.bench`` with
   its defaults (the srbm_lcp stream at B=64 over a pool of 384, after its
   warm-up pool) in a process of its own, right after phase 9 and alone on
   the card, its last line read and held to phase 4's convergence floor
   and to 6 ``qd_inverse`` launches per batch iteration; then, beside
   phases 10-20, ``tools.montecarlo_100k --n 256 --chunk 128`` (two pools
   aggregated into one record) and ``examples.solve_landing --cascade
   --plot`` (the HTML viewer) under ``build/``.

22. the convergence diagnostics at cut depth (PERF.md §13):
   ``tools.iter_bench``'s r2-bench-baseline and lean-gn configurations at
   B=64 over two 20-iteration segments, right after phase 9 and alone on
   the card, beside phase 9's host and device time per iteration; then,
   beside phases 10-20, ``tools.conv_battery`` (baseline-200, loqo-200),
   ``tools.diag_conv`` on cri, ``tools.fail_taxonomy`` and
   ``tools.tune_sweep lean`` at 30 iterations (B=16, tune_sweep its own
   64), each record read back under ``build/`` and held to the JAX tool's
   keys, finite values, the iteration cap and 6 ``qd_inverse`` launches per
   batch iteration.

Phases 7, 10-20, phase 21's two side runs and phase 22's four tools go side
by side with phase 5's gentle drop, one spawned process each (the tools
share one); their wall times include one another's share of the card and of
the host's cores.

The last three lines of standard output are the ``kernels`` JSON line, the
card's name and power limit, and the ``{"ok": true, "device": ...}`` line.
Imports nothing of JAX.

tests/probe_inverse_rounding.py runs the srbm_lcp path of phase 4 with other
block inverses in the kernel's place; tests/probe_block_kernels.py times the
kernels for other numbers of threads per block.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np

# the theoretical peak rates of one H100 SXM (NVIDIA data sheet): HBM3 bytes
# per second, and f32 and f64 operations per second outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
H100_F64_FLOPS = 34e12

N_SCENARIOS = 64  # the srbm_lcp path: one pool
CONVERGENCE_FLOOR = 0.6  # the srbm_lcp path's, in phases 4 and 21
N_KINO = 128  # the kinodynamic path's batch
N_DENSE = 32  # phase 10: kinodynamic_voltage batch (the first drops of phase 6)
N_DENSE_CMP = 8  # phase 10: the dense kinodynamic batch held against phase 6
N_EEPARAM = 32  # phase 11
N_BACKENDS = 16  # phase 12
N_CASCADE = 32  # phase 13: cascade batch (the first drops of phase 6)
N_REPLAN = 8  # phase 13: replanner batch
# the depth of phases 14-16, cut for the run's time (PERF.md §13): the
# chain factory -> warm start sets the script's length
N_FACTORY, FACTORY_BATCH = 64, 64  # phase 14: drops sampled by the factory, its lanes
N_WARMSTART, WARMSTART_TRIALS, WARMSTART_MAX_ITER = 16, 1, 100  # phase 15
N_MONTECARLO, MC_CHUNK = 64, 64  # phase 16
N_SWEEP = 8  # phase 16: foot-position sweep values of v_x
N_DYN, N_DYN_CHECK = 65536, 256  # phase 18: configurations, lanes held against the CPU
N_SIM, SIM_STEPS = 1024, 500  # phase 18: joint_pd_sim drops and steps (dt 1e-4)
# two lanes are held against the CPU in f64: the untilted home-pose drop of
# tests/test_torch_featherstone.py::test_joint_pd_sim and the first seeded
# drop.  No lane can be held step by step over the whole horizon: the stiff
# joint PD is chaotic in both lanes (on the CPU in f64 a one-part-in-1e15
# nudge of the configuration moves the joint rates by 3e-6 at step 10 and
# O(1) by step 20, about four times more each step), so
#  - each of the first SIM_CHECK_STEPS steps' gap to the CPU must stay within
#    20 times the CPU's own change under that nudge (plus 1e-12), the repo's
#    sensitivity rule, over the steps where the change grows;
#  - over all SIM_STEPS steps, the CPU's share of steps with ground force and
#    its final base height must lie in the range of SIM_ENSEMBLE copies of the
#    lane on the card, nudged by k * 1e-15 (k = 0 .. SIM_ENSEMBLE - 1),
#    widened on each side by the range's width or by SIM_SPREAD_FLOOR
#    (share, m), whichever is larger.
SIM_CHECK_STEPS = 30
SIM_ENSEMBLE = 64
SIM_SPREAD_FLOOR = (0.01, 1e-4)
# the side phases must end inside the run's limit (1200 s): past this many
# seconds from the start the script stops waiting and fails
SIDE_DEADLINE_S = 1120
# phases 12 and 13 give the srbm_lcp solves the bench path's first-attempt
# deadline (StreamingSolver attempt_iters (100, 150)) as their budget
BENCH_FIRST_DEADLINE = 100
# a path's block-inverse calls come six per IP iteration (one per
# cyclic-reduction level of a 21-block horizon): every 30th is the largest
# level of every fifth iteration, every 60th of every tenth
CAPTURE_EVERY = 30
CAPTURE_EVERY_KINO = 60


def log(*args):
    print(*args, flush=True)


def bench_sampler(seed: int = 0):
    """The benchmark's drop-condition sampler, numpy ``default_rng(seed)``
    (the port's ``bench.make_sampler``; imported here, after the script has
    checked for a card)."""
    from landing_controller_tpu_torch.bench import make_sampler

    return make_sampler(seed)


HIP_SRBM = np.array([[0.19, -0.1, 0.0], [0.19, 0.1, 0.0], [-0.19, -0.1, 0.0], [-0.19, 0.1, 0.0]])


def sample_drop_scenarios(seed: int, n: int):
    """The random drop conditions of the production landing script with the
    hip-clearance initial height (landing_optimization.m:207-218), numpy:
    roll, yaw U(+-0.25), pitch U(+-pi/3), omega U(+-0.5), v_xy U(+-1),
    v_z -U(0.5, 5), z0 = 0.35 + |min_leg hip_world_z| + |dt_0 v_z| with
    dt_0 = 0.05 and the XYZ rotation.  Returns (q_init (n, 6), qd_init (n, 6))."""
    rng = np.random.default_rng(seed)
    rpy = np.stack([rng.uniform(-0.25, 0.25, n), rng.uniform(-np.pi / 3, np.pi / 3, n),
                    rng.uniform(-0.25, 0.25, n)], 1)
    omega = rng.uniform(-0.5, 0.5, (n, 3))
    v = rng.uniform(-1.0, 1.0, (n, 3))
    v[:, 2] = -4.5 * rng.uniform(0.0, 1.0, n) - 0.5
    (cr, cp, cy), (sr, sp, sy) = np.cos(rpy.T), np.sin(rpy.T)
    # third row of the XYZ body-to-world rotation: world z of a body vector
    row_z = np.stack([sr * sy - cr * sp * cy, sr * cy + cr * sp * sy, cr * cp], 1)
    hip_z = HIP_SRBM @ row_z[:, :, None]  # (n, 4, 1)
    z0 = 0.35 + np.abs(hip_z[..., 0].min(1)) + np.abs(0.05 * v[:, 2])
    q0s = np.concatenate([np.zeros((n, 2)), z0[:, None], rpy], 1).astype(np.float32)
    return q0s, np.concatenate([omega, v], 1).astype(np.float32)


def random_spd_blocks(rng, m, n):
    """Random symmetric positive definite blocks (f32)."""
    A = rng.standard_normal((m, n, n))
    return (A @ A.transpose(0, 2, 1) / n + np.eye(n)[None] * 0.5).astype(np.float32)


def random_qd_blocks(rng, m, np_, nd):
    """Random quasi-definite blocks [[P, B'], [B, -D]] (f32)."""
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


def median_ms(torch, fn, reps=25, inner=5):
    """Median over reps of one call's device time (CUDA events around
    `inner` calls, divided), after a warm-up call and a synchronize.  The
    calls are queued behind a long matrix product, so that the card finds
    them all waiting: a kernel of tens of microseconds is otherwise timed by
    the host's pace of launching it, not by its own."""
    fn()
    blocker = torch.empty((8192, 8192), device="cuda")
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.mm(blocker, blocker)  # ~20 ms on an H100; the values do not matter
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def qd_inverse_bound_ms(m, np_, nd, itemsize=4):
    """Least time for m block inverses on an H100: each input read once and
    each output written once over the memory rate, against the
    factorization's operations over the peak of their type (f32, or f64
    where itemsize is 8)."""
    bs = np_ + nd
    nbytes = m * (2 * bs * bs * itemsize + 1)
    flops_one = (np_**3 / 3 + 2 * np_**3 / 3  # chol(P), P^-1
                 + 2 * np_ * np_ * nd + 2 * nd * nd * np_  # E, D + B E
                 + nd**3 / 3 + 2 * nd**3 / 3  # chol(Dt), W
                 + 2 * np_ * nd * nd + 2 * np_ * np_ * nd)  # E W, TL
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = m * flops_one / (H100_F64_FLOPS if itemsize == 8 else H100_F32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def chol_inverse_bound_ms(m, n, itemsize=4):
    """Least time for m SPD inverses on an H100: 2 m n^2 values moved
    against m n^3 operations (factor n^3/3, inverse 2 n^3/3), f32 or f64."""
    t_bytes = m * (2 * n * n * itemsize + 1) / H100_BYTES_PER_S
    t_ops = m * float(n) ** 3 / (H100_F64_FLOPS if itemsize == 8 else H100_F32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cr_launch_sizes(nb: int, lanes: int = 1, candidates: int = 1) -> list:
    """Batch sizes m of the block-inverse calls of one cyclic-reduction
    factorization of nb blocks for `lanes` scenarios with `candidates`
    ladder candidates each: the odd blocks of every level, then the root."""
    sizes = []
    while nb > 1:
        sizes.append(nb // 2)
        nb = (nb + 1) // 2
    return [k * lanes * candidates for k in sizes + [1]]


def cr_launches_per_factor(nb: int) -> int:
    """Block-inverse calls of one cyclic-reduction factorization of nb
    blocks: one per level (the odd blocks) and one for the root."""
    return len(cr_launch_sizes(nb))


def capture_block_inverse_calls(structured, captured, every):
    """Patch the Newton step's block-inverse factory so that the blocks of
    some calls are recorded into ``captured`` {call number: (m, bs, bs)}: all
    of the first factorization (calls 0-5), then every ``every``-th call.
    Returns (restore, call sizes): ``restore()`` undoes the patch, the list
    receives the batch size m of every call."""
    make_original = structured.make_qd_inverse
    sizes = []

    def make_capturing(np_, nd):
        fn = make_original(np_, nd)

        def capture(S):
            call = len(sizes)
            blocks = S.reshape((-1,) + S.shape[-2:])
            sizes.append(blocks.shape[0])
            if call < 6 or call % every == 0:
                captured[call] = blocks.detach().clone()
            return fn(S)

        return capture

    structured.make_qd_inverse = make_capturing

    def restore():
        structured.make_qd_inverse = make_original

    return restore, sizes


def check_feasible(torch, solver, z, q_np, qd_np, scaled_viol, label):
    """Converged solutions hold their constraints on the unscaled problem.
    The solver's 1e-3 contract is on the scaled rows (row scales <= 1), so
    the unscaled check allows 1e-2."""
    theta = solver.build_params(q_np, qd_np)
    E = solver.problem.eq(z, theta)
    g = solver.problem.ineq(z, theta)
    viol = torch.maximum(E.abs().amax(-1), torch.clamp(-g, min=0).amax(-1))
    log(f"[check] {label}: {z.shape[0]} converged solutions, max violation scaled "
        f"{float(scaled_viol.max()):.3e} (<= 1e-3), unscaled {float(viol.max()):.3e} (<= 1e-2)")
    if float(scaled_viol.max()) > 1e-3 or float(viol.max()) > 1e-2:
        raise AssertionError(f"{label}: a converged solution violates its constraints")


def qd_rel_least_pivot(torch, S64, np_, nd):
    """Relative least pivot of a quasi-definite block's two f64 Cholesky
    factorizations, P and the Schur complement D + B P^-1 B': min over both
    of min(diag L)^2 / max(diag L)^2; -1 where the f64 factorization fails."""
    P, Bm, D = S64[:, :np_, :np_], S64[:, np_:, :np_], -S64[:, np_:, np_:]
    lp, info_p = torch.linalg.cholesky_ex(P)
    Dt = D + Bm @ torch.cholesky_solve(Bm.transpose(1, 2), lp)
    ld, info_d = torch.linalg.cholesky_ex(Dt)

    def rel(L):
        d = torch.diagonal(L, dim1=1, dim2=2) ** 2
        return d.amin(1) / d.amax(1)

    out = torch.minimum(rel(lp), rel(ld))
    return torch.where((info_p == 0) & (info_d == 0), out, torch.full_like(out, -1.0))


# an inertia test whose f64 relative least pivot is below this (16 ulps of
# f32) is decided by rounding in f32
F32_UNDECIDABLE = 1e-6


def check_real_blocks(torch, name, kernel_fn, plain_fn, captured, rel_least_pivot=None):
    """A kernel against its plain version on matrices captured from a
    solver path (KKT blocks for qd_inverse, their SPD sub-blocks for
    chol_inverse), both held to the f64 inverse of the same matrices.
    ``kernel_fn`` / ``plain_fn``: (m, k, k) -> (inverse, ok).  Returns the
    largest absolute difference between the two on the matrices compared.

    The blocks are ill-conditioned (condition numbers ~1e6 and above), so no
    f32 inverse is accurate on all of them: the kernel's error is limited by
    the plain version's own error on the same blocks.  Per block the error is
    max|Sinv - inv64| / max|inv64|.  A block on which the plain version keeps
    no correct digit (error > 1, or non-finite) is singular in f32: both
    versions pass their pivot test there and neither gives an inverse, so it
    is counted and left out of the limits.  Checks:
    - the ok flags agree on every block, except, where ``rel_least_pivot``
      (f64 matrices -> relative least pivot) is given, on blocks whose f64
      pivot test is below f32's resolution (F32_UNDECIDABLE): there the two
      f32 versions may round to different signs; such blocks are counted,
      left out of the limits, and may be at most 2% of all blocks;
    - the kernel is finite on every block both flag ok that is not singular
      in f32, and symmetric bit for bit on every finite block both flag ok;
    - pooled over all captured calls, the kernel's median and 99th-percentile
      errors are at most 2x the plain version's, and its largest at most 10x.
    """
    errs_k, errs_p = [], []
    n_singular = n_ok = n_blocks = n_disagree = 0
    max_abs = 0.0
    for call, S in sorted(captured.items()):
        out_k, ok_k = kernel_fn(S)
        out_p, ok_p = plain_fn(S)
        disagree = ok_k != ok_p
        n_blocks += S.shape[0]
        if disagree.any():
            if rel_least_pivot is None:
                raise AssertionError(f"{name} ok flags disagree on captured call {call}")
            rel = rel_least_pivot(S[disagree].double())
            if not bool((rel < F32_UNDECIDABLE).all()):
                raise AssertionError(f"{name} ok flags disagree on a block of call {call} whose "
                                     f"f64 relative least pivot is {float(rel.max()):.3e}")
            n_disagree += int(disagree.sum())
        ok = ok_k & ok_p
        inv64 = torch.linalg.inv(S[ok].double())
        scale = inv64.abs().amax((-1, -2))

        def rel_err(out):
            return (out[ok].double() - inv64).abs().amax((-1, -2)) / scale

        ek, ep = rel_err(out_k), rel_err(out_p)
        singular = ~(ep <= 1.0)
        finite_k = torch.isfinite(out_k[ok]).flatten(1).all(1)
        if (~finite_k & ~singular).any():
            raise AssertionError(f"{name} kernel is not finite on an ok block of call {call}")
        if not torch.equal(out_k[ok][finite_k], out_k[ok][finite_k].transpose(1, 2)):
            raise AssertionError(f"{name} kernel output of call {call} is not symmetric bit for bit")
        ek, ep = ek[~singular], ep[~singular]
        n_ok += int(ok.sum())
        n_singular += int(singular.sum())
        if not ek.numel():
            continue
        max_abs = max(max_abs, float((out_k[ok][~singular] - out_p[ok][~singular]).abs().max()))
        errs_k.append(ek)
        errs_p.append(ep)
        log(f"[check] {name} call {call:4d} m={S.shape[0]:4d}: ok in both {int(ok.sum())}, flags "
            f"differ {int(disagree.sum())}, singular in f32 {int(singular.sum())} (kernel "
            f"non-finite {int((~finite_k).sum())}); rel err median/p99/max kernel "
            f"{float(ek.median()):.2e}/{float(torch.quantile(ek, 0.99)):.2e}/"
            f"{float(ek.max()):.2e}, plain {float(ep.median()):.2e}/"
            f"{float(torch.quantile(ep, 0.99)):.2e}/{float(ep.max()):.2e}")
    ek, ep = torch.cat(errs_k), torch.cat(errs_p)
    stats = [(stat, float(fn(ek)), float(fn(ep)), factor) for stat, fn, factor in (
        ("median", torch.median, 2.0),
        ("p99", lambda e: torch.quantile(e, 0.99), 2.0),
        ("max", torch.max, 10.0))]
    log(f"[check] {name} on real blocks, {len(captured)} captured calls, {n_blocks} blocks: "
        f"{n_ok} ok in both, ok flags differ on {n_disagree}"
        f"{' (each undecidable in f32)' if n_disagree else ''}, "
        f"{n_singular} singular in f32; rel err vs the f64 inverse "
        + ", ".join(f"{stat} kernel {k:.3e} plain {p:.3e} (<= {f:g}x)" for stat, k, p, f in stats))
    if n_disagree > 0.02 * n_blocks:
        raise AssertionError(f"{name}: ok flags differ on {n_disagree} of {n_blocks} blocks (> 2%)")
    for stat, k, p, factor in stats:
        if not k <= factor * p:
            raise AssertionError(f"{name} kernel's {stat} error {k:.3e} on the real blocks "
                                 f"exceeds {factor:g}x the plain version's {p:.3e}")
    return max_abs


def profile_iteration(torch, solver, q, qd, label, card, iters=3):
    """Host time, device time and kernel launches per IP iteration of the
    solver's lanes (q, qd): :func:`profile_run` of one segment of `iters`
    iterations."""
    snlp, st = solver.init_lanes(q, qd, 0)
    _, st = solver._segment_impl(None, None, st, 1, snlp=snlp)  # first-call costs
    return profile_run(torch, lambda k: solver._segment_impl(None, None, st, k, snlp=snlp), label,
                       len(q), card, iters)


def profile_run(torch, run, label, B, card, iters=3):
    """Host and device time and kernel launches per IP iteration of
    ``run(iters)`` (`iters` iterations of B lanes, then their diagnostics):
    the host clock around one run ending in a synchronize, then the same run
    under torch.profiler for the device side, with the device time of each
    hand-written kernel by its name; returns (host ms, device ms)."""
    torch.cuda.synchronize()
    t0 = time.time()
    run(iters)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.time() - t0) / iters
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(iters)
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev_attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") \
        else "self_cuda_time_total"
    # device-side events only (kernels, memcpy, memset)
    kernels = [e for e in events if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    device_us = sum(getattr(e, dev_attr) for e in kernels)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    dev_ms = device_us / 1e3 / iters
    ours = []
    for name in ("qd_inverse_kernel", "chol_inverse_kernel"):
        us = sum(getattr(e, dev_attr) for e in kernels if name in e.key)
        n = sum(e.count for e in kernels if name in e.key)
        ours.append(f"{name} {us / 1e3 / iters:.3f} ms per iteration in {n / iters:.0f} launches "
                    f"({us / max(device_us, 1):.3f} of device time)")
    log(f"[profile] {label} B={B} on {card}: host {host_ms:.1f} ms per iteration, device busy "
        f"{dev_ms:.2f} ms per iteration (idle share {1 - dev_ms / host_ms:.3f}), "
        f"{launches / iters:.0f} cudaLaunchKernel per iteration; " + "; ".join(ours))
    top = sorted(kernels, key=lambda e: -getattr(e, dev_attr))[:8]
    for e in top:
        log(f"[profile]   {getattr(e, dev_attr) / 1e3 / iters:8.3f} ms/iter  {e.count // iters:5d}x  "
            f"{e.key[:80]}")
    return host_ms, dev_ms


def run_timed(torch, fn):
    """fn() with its wall time (ending in a synchronize) and the peak device
    memory it allocated (GB)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0, torch.cuda.max_memory_allocated() / 1e9


def batch_summary(sol, wall):
    """(converged mask, one-line summary) of a batch solve's outcome."""
    conv = sol.converged.cpu().numpy()
    its = sol.iterations.cpu().numpy()
    n_iter = max(int(its.max()), 1)
    return conv, (f"converged {int(conv.sum())}/{len(conv)}, iters_p50 "
                  f"{np.percentile(its, 50):.0f}, iters_p90 {np.percentile(its, 90):.0f}, kkt_error "
                  f"p50 {float(sol.kkt_error.median()):.3e}, batch iterations {n_iter}, wall_s "
                  f"{wall:.2f}, {1e3 * wall / n_iter:.1f} ms per batch iteration, converged "
                  f"solves/s {conv.sum() / wall:.3f}")


def check_finite(torch, sol, names, label):
    for name in names:
        if not torch.isfinite(getattr(sol, name)).all():
            raise AssertionError(f"{label}: non-finite values in the solution's {name}")


def max_rel_cost_gap(cost_a, cost_b, both):
    """Largest |cost_a - cost_b| / |cost_b| over the lanes ``both`` (numpy)."""
    if not both.any():
        return float("nan")
    a, b = cost_a[both], cost_b[both]
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-12)).max())


def kinodynamic_solver(dev):
    """Phase 6's solver: the kinodynamic battery's `base` configuration
    (tools/kino_battery.py of the port)."""
    from landing_controller_tpu_torch.tools.kino_battery import battery_solver

    return battery_solver("base", dev)


def dense_path(torch, card, kino, kino_ref, qk, qdk, dev):
    """Phase 10: the dense KKT path at full width (kinodynamic_voltage, N=21,
    default settings), then kinodynamic with structured=False against phase
    6's structured solutions of the same drops (``kino_ref``: numpy
    converged, z and cost of phase 6's lanes)."""
    from landing_controller_tpu_torch import LandingSolver

    volt = LandingSolver("kinodynamic_voltage", dtype=torch.float32, device=dev)
    prob = volt.problem
    sizes = (prob.n_vars, prob.n_eq, prob.n_ineq)
    if volt.structured or sizes != (972, 264, 3540):
        raise AssertionError(f"kinodynamic_voltage: structured={volt.structured}, sizes {sizes}")
    q, qd = qk[:N_DENSE], qdk[:N_DENSE]
    sol, wall, peak = run_timed(torch, lambda: volt.solve_batch(q, qd))
    conv, line = batch_summary(sol, wall)
    log(f"[dense] kinodynamic_voltage solve_batch B={N_DENSE} N=21 (n={sizes[0]}, {sizes[1]} "
        f"equality rows, {sizes[2]} inequality rows), default settings, on {card}: {line}, "
        f"peak device memory {peak:.3f} GB")
    check_finite(torch, sol, ("z", "X", "jpos", "U", "tau", "cost", "kkt_error", "constr_viol"),
                 "kinodynamic_voltage")
    if conv.sum() < 8:
        raise AssertionError(f"kinodynamic_voltage: {int(conv.sum())} of {N_DENSE} converged (< 8)")
    check_feasible(torch, volt, sol.z[sol.converged], q[conv], qd[conv],
                   sol.constr_viol[sol.converged], "kinodynamic_voltage")
    # |motor voltage| read back from the voltage rows [V - v, v + V]; the
    # kinodynamic solutions of phase 6 (same variables, no voltage rows) beside it
    v_batt = volt.robot_params.battery_v

    def max_voltage(z, qq, qqd):
        rows = prob._voltage_rows(prob.unpack(z), volt.build_params(qq, qqd))
        return v_batt - float(rows.min())

    v_dense = max_voltage(sol.z[sol.converged], q[conv], qd[conv])
    ck = kino_ref["converged"][:N_DENSE]
    v_kino = max_voltage(torch.as_tensor(kino_ref["z"][:N_DENSE][ck], device=dev), q[ck], qd[ck])
    log(f"[dense] largest |motor voltage| on the converged solutions {v_dense:.4f} V (battery_v "
        f"{v_batt} V); phase 6's kinodynamic solutions of the same drops, without the rows: "
        f"{v_kino:.4f} V")
    if v_dense > v_batt + 1e-2:
        raise AssertionError(f"kinodynamic_voltage: a converged solution draws {v_dense:.3f} V")

    dense_kino = LandingSolver("kinodynamic", dtype=torch.float32, guess=kino.guess,
                               config=kino.config, structured=False, device=dev)
    q8, qd8 = qk[:N_DENSE_CMP], qdk[:N_DENSE_CMP]
    sol_d, wall, peak = run_timed(torch, lambda: dense_kino.solve_batch(q8, qd8))
    conv_d, line = batch_summary(sol_d, wall)
    check_finite(torch, sol_d, ("z", "cost", "kkt_error", "constr_viol"), "kinodynamic dense")
    conv_c = kino_ref["converged"][:N_DENSE_CMP]
    both = conv_d & conv_c
    log(f"[dense] kinodynamic structured=False, phase 6's settings, B={N_DENSE_CMP}: {line}, peak "
        f"device memory {peak:.3f} GB; converged dense {int(conv_d.sum())}, structured cri "
        f"(phase 6, same drops) {int(conv_c.sum())}, both {int(both.sum())}; largest relative "
        f"cost difference on those {max_rel_cost_gap(sol_d.cost.cpu().numpy(), kino_ref["cost"][:N_DENSE_CMP], both):.3e}")


def eeparam_phase(torch, card, dev):
    """Phase 11: EEParamSolver (f32, default settings) on the drops of the
    eeParam benchmark's sampler (tools/eeparam_bench.py of the port)."""
    from landing_controller_tpu_torch import EEParamSolver
    from landing_controller_tpu_torch.tools.eeparam_bench import drop_params

    ee = EEParamSolver(dtype=torch.float32, device=dev)
    prob = ee.problem
    theta = drop_params(ee, 0, N_EEPARAM)
    sol, wall, peak = run_timed(torch, lambda: ee.solve_batch(theta))
    conv, line = batch_summary(sol, wall)
    log(f"[eeparam] EEParamSolver solve_batch B={N_EEPARAM} (n={prob.n_vars}, {prob.n_eq} equality "
        f"rows, {prob.n_ineq} inequality rows), default settings, on {card}: {line}, peak device "
        f"memory {peak:.3f} GB")
    check_finite(torch, sol, ("z", "cost", "kkt_error", "constr_viol"), "eeparam")
    if conv.sum() < 16:
        raise AssertionError(f"eeparam: {int(conv.sum())} of {N_EEPARAM} converged (< 16)")
    E, g = prob.eq(sol.z, theta), prob.ineq(sol.z, theta)
    viol = torch.maximum(E.abs().amax(-1), torch.clamp(-g, min=0).amax(-1))[sol.converged]
    scaled = sol.constr_viol[sol.converged]
    log(f"[check] eeparam: {int(conv.sum())} converged solutions, max violation scaled "
        f"{float(scaled.max()):.3e} (<= 1e-3), unscaled {float(viol.max()):.3e} (<= 1e-2)")
    if float(scaled.max()) > 1e-3 or float(viol.max()) > 1e-2:
        raise AssertionError("eeparam: a converged solution violates its constraints")


def backends_phase(torch, card, srbm, launches, dev):
    """Phase 12: srbm_lcp solve_batch under the three structured backends,
    with the bench path's settings and its first-attempt deadline."""
    from landing_controller_tpu_torch import LandingSolver
    from landing_controller_tpu_torch.ops.pallas_blocks import qd_inverse

    q, qd = bench_sampler(5)(N_BACKENDS)
    sols = {}
    for backend in ("scan", "cr", "cri"):
        solver = LandingSolver(
            "srbm_lcp", dtype=torch.float32, guess=srbm.guess, theta_overrides=srbm.theta_overrides,
            config=dataclasses.replace(srbm.config, kkt_backend=backend,
                                       max_iter=BENCH_FIRST_DEADLINE), device=dev)
        qd_inverse.launches = 0
        sol, wall, _ = run_timed(torch, lambda: solver.solve_batch(q, qd))
        n_launch = qd_inverse.launches
        conv, line = batch_summary(sol, wall)
        log(f"[backends] srbm_lcp kkt_backend={backend} B={N_BACKENDS} max_iter "
            f"{BENCH_FIRST_DEADLINE} on {card}: {line}, qd_inverse launches {n_launch}")
        check_finite(torch, sol, ("z", "cost", "kkt_error", "constr_viol"), f"backend {backend}")
        if (backend == "cri") != (n_launch > 0):
            raise AssertionError(f"backend {backend}: {n_launch} qd_inverse launches")
        sols[backend] = (sol, conv)
    launches["srbm_lcp_cri_backend"] = n_launch
    all3 = sols["scan"][1] & sols["cr"][1] & sols["cri"][1]
    cost = {k: sol.cost.cpu().numpy() for k, (sol, _) in sols.items()}
    log(f"[backends] converged by all three {int(all3.sum())}; largest relative cost difference "
        f"against cri there: scan {max_rel_cost_gap(cost['scan'], cost['cri'], all3):.3e}, "
        f"cr {max_rel_cost_gap(cost['cr'], cost['cri'], all3):.3e}")
    n_cri = int(sols["cri"][1].sum())
    if 2 * int(sols["cr"][1].sum()) < n_cri:
        raise AssertionError(f"backend cr converges under half of cri's {n_cri}")
    # the sequential sweep in f32 stalls above this tolerance in the JAX
    # package as in the port (ROADMAP §3): held to its KKT level instead
    kkt_scan = float(sols["scan"][0].kkt_error.median())
    if not kkt_scan <= 1e-2:
        raise AssertionError(f"backend scan: median kkt_error {kkt_scan:.3e} > 1e-2")


def cascade_phase(torch, card, kino_ref, srbm, qk, qdk, launches, dev):
    """Phase 13: the srbm_lcp -> kinodynamic cascade with phase 6's settings
    (the solvers of the port's tools/cascade_sweep.py) on the first drops of
    phase 6, and the receding-horizon replanner on the bench path's srbm_lcp
    settings."""
    from landing_controller_tpu_torch.ops.pallas_blocks import qd_inverse
    from landing_controller_tpu_torch.tools.cascade_sweep import cascade_solvers
    from landing_controller_tpu_torch.warmstart.cascade import make_cascade
    from landing_controller_tpu_torch.warmstart.replan import Replanner

    stage1, kino = cascade_solvers(dev)
    cascade = make_cascade(stage1, kino)
    z6 = np.zeros((1, 6))
    if not torch.equal(cascade.stage1.build_params(z6, z6).dt, kino.build_params(z6, z6).dt):
        raise AssertionError("cascade: stage 1 is not on the kinodynamic dt schedule")
    q, qd = qk[:N_CASCADE], qdk[:N_CASCADE]
    qd_inverse.launches = 0
    (sol2, sol1), wall, peak = run_timed(torch, lambda: cascade(q, qd))
    launches["cascade"] = qd_inverse.launches
    conv1, line1 = batch_summary(sol1, wall)
    conv2, line2 = batch_summary(sol2, wall)
    cold = kino_ref["converged"][:N_CASCADE]
    log(f"[cascade] srbm_lcp -> kinodynamic (x_grf seed), B={N_CASCADE} N=21, on {card}: wall_s "
        f"{wall:.2f} for both stages, peak device memory {peak:.3f} GB, qd_inverse launches "
        f"{launches['cascade']}; stage 1: {line1.split(', wall_s')[0]}; stage 2: "
        f"{line2.split(', wall_s')[0]}; cold kinodynamic on the same drops (phase 6): converged "
        f"{int(cold.sum())}/{N_CASCADE}, both cascade and cold {int((conv2 & cold).sum())}")
    check_finite(torch, sol2, ("z", "X", "jpos", "U", "tau", "cost"), "cascade stage 2")
    if launches["cascade"] <= 0:
        raise AssertionError("the cascade did not go through the qd_inverse kernel")
    if conv2.sum() < 8:
        raise AssertionError(f"cascade: stage 2 converged {int(conv2.sum())} of {N_CASCADE} (< 8)")
    check_feasible(torch, kino, sol2.z[sol2.converged], q[conv2], qd[conv2],
                   sol2.constr_viol[sol2.converged], "cascade stage 2")

    rp = Replanner("srbm_lcp", dtype=torch.float32, guess=srbm.guess,
                   theta_overrides=srbm.theta_overrides,
                   plan_config=dataclasses.replace(srbm.config, max_iter=BENCH_FIRST_DEADLINE),
                   device=dev)
    qr, qdr = bench_sampler(7)(N_REPLAN)
    qd_inverse.launches = 0
    plan, wall_p, _ = run_timed(torch, lambda: rp.plan(qr, qdr))
    re, wall_r, _ = run_timed(torch, lambda: rp.replan(Replanner.carry(plan), qr + 1e-3, qdr + 1e-3))
    launches["replan"] = qd_inverse.launches
    cap = rp.solver_warm.config.max_iter
    conv_p, line_p = batch_summary(plan, wall_p)
    conv_r, line_r = batch_summary(re, wall_r)
    its_r = re.iterations.cpu().numpy()
    log(f"[replan] srbm_lcp B={N_REPLAN} on {card}: plan (max_iter {BENCH_FIRST_DEADLINE}) "
        f"{line_p}; replan from the measured state nudged by 1e-3 (iter_cap {cap}): {line_r}, "
        f"iterations {its_r.tolist()}; qd_inverse launches {launches['replan']}")
    check_finite(torch, re, ("z", "cost", "s", "lam", "y"), "replan")
    if int(its_r.max()) > cap:
        raise AssertionError(f"replan: {int(its_r.max())} iterations over iter_cap {cap}")
    if launches["replan"] <= 0:
        raise AssertionError("the replanner did not go through the qd_inverse kernel")


BUILD_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke")
NN_FACTORY_PATH = os.path.join(BUILD_OUT, "nn_factory.npz")


def factory_phase(torch, card, launches, dev):
    """Phase 14: the streaming training-data factory with the settings of
    tools/train_warmstart.py:48-67 (the port's tool: its solvers and its
    training), then training on the card, the network saved under build/
    and read back, a solver taking it as its guess, and nn_vs_nlp on one
    harvested drop."""
    from landing_controller_tpu_torch import LandingSolver
    from landing_controller_tpu_torch.analysis import nn_vs_nlp
    from landing_controller_tpu_torch.data import generate_training_data_streaming
    from landing_controller_tpu_torch.ops.pallas_blocks import qd_inverse
    from landing_controller_tpu_torch.tools.common import kino_config
    from landing_controller_tpu_torch.tools.train_warmstart import factory_solvers, train_network
    from landing_controller_tpu_torch.warmstart import nn as wsnn

    kino = factory_solvers(dev)[1]
    qd_inverse.launches = 0
    data, wall, peak = run_timed(torch, lambda: generate_training_data_streaming(
        kino, N_FACTORY, generator=torch.Generator().manual_seed(0), batch=FACTORY_BATCH,
        segment=50))
    launches["factory"] = qd_inverse.launches
    m = data["inputs"].shape[0]
    log(f"[factory] streaming kinodynamic N=21 (84-wide blocks, cri), B={FACTORY_BATCH} seg=50, "
        f"max_iter {kino.config.max_iter}, "
        f"NN retry, on {card}: harvested {m}/{N_FACTORY}, wall_s {wall:.2f} (pool set-up "
        f"included), converged solves/s {m / wall:.3f}, peak device memory {peak:.3f} GB, "
        f"qd_inverse launches {launches['factory']}")
    shapes = {k: v.shape[1:] for k, v in data.items()}
    if shapes != {"inputs": (9,), "X": (21, 12), "U": (20, 24), "jpos": (20, 12)}:
        raise AssertionError(f"factory: unexpected shapes {shapes}")
    if not all(np.isfinite(v).all() for v in data.values()):
        raise AssertionError("factory: non-finite values in the harvest")
    if launches["factory"] <= 0:
        raise AssertionError("the factory did not go through the qd_inverse kernel")
    if 2 * m < N_FACTORY:
        raise AssertionError(f"factory: harvested {m} of {N_FACTORY} drops (< half)")

    # normalization and training on the card
    (mlp, stats, losses), t_train, _ = run_timed(torch, lambda: train_network(kino, data))
    log(f"[factory] statistics, normalization and train_mlp 9->256^3->976 on {m} samples, 400 "
        f"epochs of batch {min(256, m)}, on {card}: loss {losses[0]:.5f} -> {losses[-1]:.5f}, "
        f"{t_train:.2f} s")
    if not (np.isfinite(losses).all() and losses[-1] < 0.5 * losses[0]):
        raise AssertionError(f"training: last loss {losses[-1]} not below half the first "
                             f"{losses[0]}")

    # saved under build/, read back identical, taken up by a solver
    os.makedirs(BUILD_OUT, exist_ok=True)
    tmp = NN_FACTORY_PATH.replace(".npz", ".part.npz")
    wsnn.save_warmstart(tmp, mlp, stats)
    mlp2, stats2 = wsnn.load_warmstart(tmp, device=dev)
    same = [torch.equal(a, b)
            for a, b in zip(mlp.state_dict().values(), mlp2.state_dict().values())]
    same += [torch.equal(getattr(stats, f.name), getattr(stats2, f.name))
             for f in dataclasses.fields(stats)]
    if not all(same):
        raise AssertionError("the saved network does not read back identical")
    os.replace(tmp, NN_FACTORY_PATH)
    nn_solver = LandingSolver("kinodynamic", dtype=torch.float32, config=kino_config(200),
                              guess="nn", nn_path=NN_FACTORY_PATH, device=dev)
    X0 = torch.as_tensor(data["X"][:4, 0], device=dev)
    z_solver = nn_solver._cold_guess(nn_solver.build_params(X0[:, :6], X0[:, 6:]))
    z_net = wsnn.nn_warmstart_guess(mlp, stats, X0[:, :6], X0[:, 6:], nn_solver.problem)
    log(f"[factory] saved {NN_FACTORY_PATH} ({os.path.getsize(NN_FACTORY_PATH)} bytes), read back "
        f"identical; LandingSolver(nn_path=...) guess equals the trained network's on 4 drops: "
        f"{torch.equal(z_solver, z_net)}")
    if not torch.equal(z_solver, z_net):
        raise AssertionError("the solver's nn guess is not the trained network's")

    res, wall, _ = run_timed(torch, lambda: nn_vs_nlp(mlp, stats, kino, X0[0, :6], X0[0, 6:]))
    log(f"[factory] nn_vs_nlp on the first harvested drop, on {card}: NLP converged "
        f"{res['converged']}, RMSE base position {res['rmse_base_pos']:.4f} m, orientation "
        f"{res['rmse_base_ori']:.4f} rad, feet {res['rmse_feet']:.4f} m, GRF "
        f"{res['rmse_grf']:.3f} N, joints {res['rmse_jpos']:.4f} rad, wall_s {wall:.2f}")
    if not all(np.isfinite(res[k]).all() for k in ("X_nlp", "U_nlp", "X_nn", "U_nn", "jpos_nn")):
        raise AssertionError("nn_vs_nlp: non-finite trajectories")


def warmstart_phase(torch, card, launches, dev):
    """Phase 15: the four-regime comparison of tools/train_warmstart.py:131-140
    on the committed network (the port's data/nn_TO_landing.npz; phase 14
    holds its freshly trained network to the solver's guess and nn_vs_nlp):
    the factory's kinodynamic solver and the tool's srbm_lcp solver, drops
    of seed 999 (the port's tool: its solvers and its comparison)."""
    from landing_controller_tpu_torch.api import DEFAULT_NN_PATH
    from landing_controller_tpu_torch.ops.pallas_blocks import qd_inverse
    from landing_controller_tpu_torch.tools.train_warmstart import factory_solvers
    from landing_controller_tpu_torch.tools.warmstart_compare import compare_regimes
    from landing_controller_tpu_torch.warmstart.nn import load_warmstart

    mlp, stats = load_warmstart(DEFAULT_NN_PATH, device=dev)
    srbm, kino = factory_solvers(dev, WARMSTART_MAX_ITER)
    T, B = WARMSTART_TRIALS, N_WARMSTART
    qd_inverse.launches = 0
    res, wall, _ = run_timed(torch, lambda: compare_regimes(kino, srbm, mlp, stats, T, B, 999))
    launches["warmstart"] = qd_inverse.launches
    log(f"[warmstart] B={B}, {T} trial(s) after one untimed pass, max_iter {WARMSTART_MAX_ITER}, "
        f"on {card}: wall_s {wall:.2f}, qd_inverse launches {launches['warmstart']}")
    for k, v in res["t"].items():
        log(f"[warmstart] time {k}: mean {v.mean():.4f} s, min {v.min():.4f} s per batch of {B}")
    for k, v in res["convergence"].items():
        log(f"[warmstart] convergence {k}: {v.mean():.4f}")
    if launches["warmstart"] <= 0:
        raise AssertionError("the warm-start comparison did not go through the qd_inverse kernel")
    nn_ws, cold = res["convergence"]["nn_ws"].mean(), res["convergence"]["cold"].mean()
    if nn_ws < cold - 0.15:
        raise AssertionError(f"warm start: nn_ws convergence {nn_ws:.3f} < cold {cold:.3f} - 0.15")


def montecarlo_phase(torch, card, launches, dev, readings):
    """Phase 16: monte_carlo_envelope of srbm_lcp (the port's default
    settings) with the native pool and a result log under build/, read back;
    then the foot-position sweep over v_x on the ccc solver (phase 7's
    settings)."""
    from landing_controller_tpu_torch import LandingSolver
    from landing_controller_tpu_torch.analysis.foot_positions import sweep_foot_positions
    from landing_controller_tpu_torch.ops.pallas_blocks import qd_inverse
    from landing_controller_tpu_torch.parallel.montecarlo import monte_carlo_envelope
    from landing_controller_tpu_torch.runtime import ResultLog, native_available, read_result_log

    if not native_available():
        raise AssertionError("the native scenario pool did not build")
    solver = LandingSolver("srbm_lcp", dtype=torch.float32, device=dev)
    os.makedirs(BUILD_OUT, exist_ok=True)
    path = os.path.join(BUILD_OUT, "montecarlo.log")
    if os.path.exists(path):
        os.remove(path)
    qd_inverse.launches = 0
    with ResultLog(path) as rlog:
        res, wall, _ = run_timed(torch, lambda: monte_carlo_envelope(
            solver, N_MONTECARLO, chunk=MC_CHUNK, seed=0, result_log=rlog))
    launches["montecarlo"] = qd_inverse.launches
    recs = read_result_log(path)
    log(f"[montecarlo] srbm_lcp N=21, default settings, {N_MONTECARLO} drops in chunks of "
        f"{MC_CHUNK}, native pool, on {card}: success_rate {res['success_rate']:.4f}, solves/s "
        f"{res['solves_per_sec']:.3f} (converged over solve time {res['wall_time_s']:.2f} s; wall "
        f"{wall:.2f} s), qd_inverse launches {launches['montecarlo']}; result log {len(recs)} "
        f"records read back")
    for k in ("term_min", "term_max"):
        env = None if res[k] is None else np.round(res[k].astype(np.float64), 3).tolist()
        log(f"[montecarlo] terminal-state envelope {k[5:]} {env}")
    if len(recs) != res["n_scenarios"] or res["n_scenarios"] != N_MONTECARLO:
        raise AssertionError(f"result log holds {len(recs)} records for {res['n_scenarios']} "
                             "solves")
    logged_ics = np.stack([np.concatenate([r["q_init"], r["qd_init"]]) for r in recs])
    if ([r["converged"] for r in recs] != res["converged"].tolist()
            or not np.array_equal(logged_ics, res["ics"].astype(np.float32))):
        raise AssertionError("the result log disagrees with the sweep")
    n_vars = solver.problem.n_vars
    if not (np.isfinite(res["terminal_states"]).all()
            and all(np.isfinite(r["z"]).all() and len(r["z"]) == n_vars for r in recs)):
        raise AssertionError("montecarlo: non-finite or short trajectories")
    if launches["montecarlo"] <= 0:
        raise AssertionError("the sweep did not go through the qd_inverse kernel")
    if res["success_rate"] < 0.5:
        raise AssertionError(f"montecarlo: success rate {res['success_rate']:.3f} < 0.5")

    ccc_cfg = LandingSolver("ccc", n_knots=41, dtype=torch.float32, device=dev).config
    ccc = LandingSolver("ccc", n_knots=41, dtype=torch.float32, device=dev,
                        config=dataclasses.replace(ccc_cfg, max_iter=150))
    vx = np.linspace(-1.0, 1.0, N_SWEEP)
    qd_inverse.launches = 0
    out, wall, _ = run_timed(torch, lambda: sweep_foot_positions(
        ccc, [0.0, 0.0, 0.45, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, -0.5], 3, vx))
    launches["foot_sweep"] = qd_inverse.launches
    readings["foot_sweep_f32"] = [round(o["value"], 3) for o in out if o["converged"]]
    log(f"[montecarlo] sweep_foot_positions ccc N=41 over v_x {vx.round(3).tolist()}, on {card}: "
        f"converged {sum(o['converged'] for o in out)}/{N_SWEEP}, wall_s {wall:.2f}, qd_inverse "
        f"launches {launches['foot_sweep']}")
    for o in out:
        a = o["analysis"]
        log(f"[montecarlo]   v_x {o['value']:+.3f}: converged {o['converged']}, touchdown knots "
            f"{a.td.tolist()}, dot(v, p) {np.round(a.dot_v_p, 3).tolist()}")
    if launches["foot_sweep"] <= 0:
        raise AssertionError("the foot-position sweep did not go through the qd_inverse kernel")


def montecarlo_rank(rank, world, port):
    """One rank of the two-rank sweep under NCCL (cuda:rank)."""
    import torch
    import torch.distributed as dist

    from landing_controller_tpu_torch import LandingSolver
    from landing_controller_tpu_torch.parallel.batch import backend_for, make_scenario_mesh
    from landing_controller_tpu_torch.parallel.montecarlo import monte_carlo_envelope

    torch.cuda.set_device(rank)
    dist.init_process_group(backend_for("cuda"), init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = make_scenario_mesh(f"cuda:{rank}")
        solver = LandingSolver("srbm_lcp", dtype=torch.float32, device=mesh.device)
        res = monte_carlo_envelope(solver, MC_CHUNK, chunk=MC_CHUNK, mesh=mesh)
        local = int(res["converged"].sum())
        log(f"[montecarlo] rank {rank} of {world} on {mesh.device}: {len(res['converged'])} local "
            f"rows, {local} converged; global {res['n_converged']}/{res['n_scenarios']}")
    finally:
        dist.destroy_process_group()


def f64_phase(torch, card, launches, dev, readings):
    """Phase 17: f64 on the card through the kernel's double instance:
    phase 12's srbm_lcp solve_batch (16 bench-sampler scenarios, seed 5, the
    bench path's settings and first deadline) in f64 and in f32, then phase
    16's ccc foot sweep in f64."""
    from landing_controller_tpu_torch import LandingSolver
    from landing_controller_tpu_torch.analysis.foot_positions import sweep_foot_positions
    from landing_controller_tpu_torch.ops.pallas_blocks import qd_inverse
    from landing_controller_tpu_torch.warmstart.reference import DT_PRODUCTION

    srbm = srbm_lcp_path()[0]
    q, qd = bench_sampler(5)(N_BACKENDS)
    conv = {}
    for dtype, name in ((torch.float64, "f64"), (torch.float32, "f32")):
        dt = DT_PRODUCTION.astype(np.float64 if dtype == torch.float64 else np.float32)
        solver = LandingSolver(
            "srbm_lcp", dtype=dtype, guess=srbm.guess, theta_overrides={"dt": dt},
            config=dataclasses.replace(srbm.config, max_iter=BENCH_FIRST_DEADLINE), device=dev)
        qd_inverse.launches = 0
        sol, wall, _ = run_timed(torch, lambda: solver.solve_batch(q, qd))
        n_launch = qd_inverse.launches
        conv[name], line = batch_summary(sol, wall)
        log(f"[f64] srbm_lcp {name} cri B={N_BACKENDS} max_iter {BENCH_FIRST_DEADLINE} on {card}: "
            f"{line}, qd_inverse launches {n_launch}")
        check_finite(torch, sol, ("z", "cost", "kkt_error", "constr_viol"), f"srbm_lcp {name}")
        if n_launch <= 0:
            raise AssertionError(f"srbm_lcp {name} did not go through the qd_inverse kernel")
        launches[f"srbm_lcp_{name}"] = n_launch
    log(f"[f64] srbm_lcp converged by both {int((conv['f64'] & conv['f32']).sum())}, f64 only "
        f"{int((conv['f64'] & ~conv['f32']).sum())}, f32 only {int((~conv['f64'] & conv['f32']).sum())}")

    ccc_cfg = LandingSolver("ccc", n_knots=41, dtype=torch.float64, device=dev).config
    ccc = LandingSolver("ccc", n_knots=41, dtype=torch.float64, device=dev,
                        config=dataclasses.replace(ccc_cfg, max_iter=150))
    vx = np.linspace(-1.0, 1.0, N_SWEEP)
    qd_inverse.launches = 0
    out, wall, _ = run_timed(torch, lambda: sweep_foot_positions(
        ccc, [0.0, 0.0, 0.45, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, -0.5], 3, vx))
    launches["foot_sweep_f64"] = qd_inverse.launches
    got = [round(o["value"], 3) for o in out if o["converged"]]
    readings["foot_sweep_f64"] = got
    cpu_f64 = [v for v in vx.round(3).tolist() if abs(abs(v) - 0.714) > 1e-3]
    log(f"[f64] sweep_foot_positions ccc N=41 f64 on {card}: converged {len(got)}/{N_SWEEP} at v_x "
        f"{got}, wall_s {wall:.2f}, qd_inverse launches {launches['foot_sweep_f64']}; the CPU's f64 "
        f"set (all but +-0.714) {cpu_f64}: {'equal' if got == cpu_f64 else 'different'}")
    if launches["foot_sweep_f64"] <= 0:
        raise AssertionError("the f64 foot sweep did not go through the qd_inverse kernel")
    if not all(np.isfinite(o["analysis"].dot_v_p).all() for o in out if o["converged"]):
        raise AssertionError("the f64 foot sweep gave non-finite touchdown analyses")


def dynamics_inputs(seed: int, n: int):
    """n seeded configurations of the mc3D model (numpy f64): base 0.1-0.7 m
    up and tilted up to 0.4 rad, joints within 0.3 rad of the home pose,
    velocities, torques and accelerations."""
    from landing_controller_tpu_torch.models import get_robot_model

    q_home = get_robot_model("mc3D").q_home
    rng = np.random.default_rng(seed)
    q = np.concatenate([rng.uniform(-0.3, 0.3, (n, 3)) + [0.0, 0.0, 0.4],
                        rng.uniform(-0.4, 0.4, (n, 3)), q_home[6:] + rng.uniform(-0.3, 0.3, (n, 12))],
                       1)
    return q, rng.uniform(-1, 1, (n, 18)), rng.uniform(-5, 5, (n, 18)), rng.uniform(-3, 3, (n, 18))


def kernels_per_call(torch, fn):
    """Kernels the card runs for one call of fn (torch.profiler's device-side
    events, copies and fills left out)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset")))


def _rel_err(out, ref):
    """max |out - ref| over max(1, max |ref|): numpy arrays."""
    return float(np.abs(out - ref).max() / max(1.0, np.abs(ref).max()))


def dynamics_phase(torch, card, dev):
    """Phase 18: the rigid-body dynamics layer at batch scale, f32 and f64:
    ms and kernel launches per call at B = 65,536, the first 256 lanes held
    against the port on the CPU in f64 (f64 to 1e-9 relative; f32 to 1e-4 for
    the evaluations and to 10 eps32 cond(H) for the solves, cond after Jacobi
    scaling); fd_ab against
    fd_crb and rnea(fd_ab(tau)) = tau on the card; then joint_pd_sim of 1,024
    drops for 500 steps in f64, two lanes held against the CPU by the rules
    stated at SIM_CHECK_STEPS."""
    from landing_controller_tpu_torch.dynamics import featherstone as F
    from landing_controller_tpu_torch.models import get_robot_model, get_robot_params
    from landing_controller_tpu_torch.ops import branch_sparsity as bs

    t0 = time.time()
    model = get_robot_model("mc3D")
    lam = model.parent
    rotors = F.quad3d_rotor_model(model, get_robot_params("mc3D"), 2.5e-5, rotor_mass=0.05)
    fns = {
        "fk_feet": lambda q, qd, tau, qdd, H: F.fk_feet(model, q),
        "mass_matrix": lambda q, qd, tau, qdd, H: F.mass_matrix(model, q)[0],
        "crba_open": lambda q, qd, tau, qdd, H: F.crba_open(model, q),
        "rnea": lambda q, qd, tau, qdd, H: F.rnea(model, q, qd, qdd),
        "fd_ab": lambda q, qd, tau, qdd, H: F.fd_ab(model, q, qd, tau),
        "fd_crb": lambda q, qd, tau, qdd, H: F.fd_crb(model, q, qd, tau),
        "h_and_c_rotors": lambda q, qd, tau, qdd, H: torch.cat(
            [t.flatten(1) for t in F.h_and_c_rotors(model, rotors, q, qd)], 1),
        "energy_momentum": lambda q, qd, tau, qdd, H: torch.cat(
            [t.reshape(q.shape[0], -1) for t in F.energy_momentum(model, q, qd).values()], 1),
        "ltdl": lambda q, qd, tau, qdd, H: torch.cat([t.flatten(1) for t in bs.ltdl(H, lam)], 1),
        "solve_ltl": lambda q, qd, tau, qdd, H: bs.solve_ltl(bs.ltl(H, lam), lam, tau),
    }
    solves = ("fd_ab", "fd_crb", "solve_ltl")
    q_np, qd_np, tau_np, qdd_np = dynamics_inputs(18, N_DYN)
    cpu = [torch.as_tensor(a[:N_DYN_CHECK]) for a in (q_np, qd_np, tau_np, qdd_np)]
    cpu.append(F.crba_open(model, cpu[0]))
    # the f32 solves are held to 10 eps32 times H's condition number after
    # Jacobi scaling, D^-1/2 H D^-1/2 with D = diag(H): the one that bounds the
    # error of a Cholesky solve (van der Sluis), where the unscaled one mostly
    # measures the spread of the base's mass and the legs' inertias
    scale = torch.diagonal(cpu[4], dim1=-2, dim2=-1).rsqrt()
    cond = float(torch.linalg.cond(cpu[4]).max())
    cond_scaled = float(torch.linalg.cond(scale[..., :, None] * cpu[4] * scale[..., None, :]).max())
    refs = {name: fn(*cpu).numpy() for name, fn in fns.items()}
    eps32 = float(np.finfo(np.float32).eps)
    log(f"[dynamics] B={N_DYN} seeded mc3D configurations; largest condition number of crba_open's "
        f"H on the first {N_DYN_CHECK} lanes {cond:.3e}, after Jacobi scaling {cond_scaled:.3e}")
    for dtype, name in ((torch.float32, "f32"), (torch.float64, "f64")):
        args = [torch.as_tensor(a, dtype=dtype, device=dev) for a in (q_np, qd_np, tau_np, qdd_np)]
        args.append(F.crba_open(model, args[0]))
        for fn_name, fn in fns.items():
            ms = median_ms(torch, lambda: fn(*args), reps=3, inner=1)
            n_k = kernels_per_call(torch, lambda: fn(*args))
            out = fn(*[a[:N_DYN_CHECK] for a in args]).double().cpu().numpy()
            err = _rel_err(out, refs[fn_name])
            if name == "f64":
                tol = 1e-9
            else:
                tol = 10 * eps32 * cond_scaled if fn_name in solves else 1e-4
            full = fn(*args)
            if not bool(torch.isfinite(full).all()):
                raise AssertionError(f"dynamics {fn_name} {name}: non-finite values")
            log(f"[dynamics] {fn_name} {name} B={N_DYN} on {card}: {ms:.3f} ms per call, {n_k} "
                f"kernels per call, error of the first {N_DYN_CHECK} lanes against the CPU in f64 "
                f"{err:.3e} (tolerance {tol:.1e})")
            if not err <= tol:
                raise AssertionError(f"dynamics {fn_name} {name}: error {err:.3e} > {tol:.1e}")
        del args
        torch.cuda.empty_cache()

    q, qd, tau = (torch.as_tensor(a, device=dev) for a in (q_np, qd_np, tau_np))
    ab, crb = F.fd_ab(model, q, qd, tau), F.fd_crb(model, q, qd, tau)
    gap = float(((ab - crb).abs().amax(1) / crb.abs().amax(1).clamp(min=1.0)).max())
    back = F.rnea(model, q, qd, ab)
    rt = float(((back - tau).abs().amax(1) / tau.abs().amax(1).clamp(min=1.0)).max())
    log(f"[dynamics] f64 B={N_DYN}: fd_ab against fd_crb {gap:.3e}, rnea(fd_ab(tau)) - tau {rt:.3e} "
        f"(relative, largest lane; tolerance 1e-8)")
    if not (gap <= 1e-8 and rt <= 1e-8):
        raise AssertionError("dynamics: fd_ab, fd_crb and rnea disagree")
    log(f"[dynamics] the functions at B={N_DYN} and their checks: {time.time() - t0:.1f} s")
    del q, qd, tau, ab, crb, back
    torch.cuda.empty_cache()

    rng = np.random.default_rng(181)
    q0 = np.tile(model.q_home, (N_SIM, 1))
    q0[:, 2] = rng.uniform(0.09, 0.13, N_SIM)
    q0[:, 3:6] = rng.uniform(-0.05, 0.05, (N_SIM, 3))
    qd0 = np.zeros((N_SIM, 18))
    qd0[:, 2] = rng.uniform(-1.0, 0.0, N_SIM)
    home = model.q_home.copy()
    home[2] = 0.0908  # the feet 5 mm into the ground
    held_q, held_qd = np.stack([home, q0[0]]), np.stack([np.zeros(18), qd0[0]])
    nudge = 1 + np.arange(SIM_ENSEMBLE)[None, :, None] * 1e-15
    q_all = np.concatenate([q0, (held_q[:, None] * nudge).reshape(-1, 18)])
    qd_all = np.concatenate([qd0, np.repeat(held_qd, SIM_ENSEMBLE, 0)])
    sim = dict(jpos_des=model.q_home[6:], jvel_des=np.zeros(12), kp=1000.0, kd=30.0, dt=1e-4,
               tau_limit=model.tau_max[:12])
    q0_d, qd0_d = torch.as_tensor(q_all, device=dev), torch.as_tensor(qd_all, device=dev)
    n_k = kernels_per_call(torch, lambda: F.joint_pd_sim(model, q0_d, qd0_d, n_steps=1, **sim))
    (qs, qds, grfs), wall, peak = run_timed(torch, lambda: F.joint_pd_sim(
        model, q0_d, qd0_d, n_steps=SIM_STEPS, **sim))
    finite = all(bool(torch.isfinite(t).all()) for t in (qs, qds, grfs))
    qs, qds, grfs = (t.cpu().numpy() for t in (qs, qds, grfs))

    def contact_share(g):  # share of steps with ground force, per lane
        return (g[..., 2].sum(-1) > 0).mean(-1)

    tau_pd = 1000.0 * (model.q_home[6:] - qs[:N_SIM, :-1, 6:]) - 30.0 * qds[:N_SIM, :-1, 6:]
    saturated = float((np.abs(tau_pd) >= model.tau_max[:12]).mean())
    t_cpu = time.time()
    ref = [t.numpy() for t in F.joint_pd_sim(model, torch.as_tensor(held_q),
                                             torch.as_tensor(held_qd), n_steps=SIM_STEPS, **sim)]
    nudged = [t.numpy() for t in F.joint_pd_sim(model, torch.as_tensor(held_q * (1 + 1e-15)),
                                                torch.as_tensor(held_qd), n_steps=SIM_CHECK_STEPS,
                                                **sim)]
    t_cpu = time.time() - t_cpu

    def per_step(a, b):  # the largest |a - b| of the two lanes at each step
        return np.abs(a - b).reshape(2, a.shape[1], -1).max(axis=(0, 2))

    ens = [t[N_SIM:].reshape((2, SIM_ENSEMBLE) + t.shape[1:]) for t in (qs, qds, grfs)]
    gap = [per_step(e[:, 0, :n.shape[1]], r[:, :n.shape[1]]) for e, r, n in zip(ens, ref, nudged)]
    own = [per_step(n, r[:, :n.shape[1]]) for n, r in zip(nudged, ref)]
    held = all(bool((g <= 20 * o + 1e-12).all()) for g, o in zip(gap, own))
    in_range, spread = True, []
    for name, card_v, cpu_v, floor in (
            ("share of steps with ground force", contact_share(ens[2]), contact_share(ref[2]),
             SIM_SPREAD_FLOOR[0]),
            ("final base height", ens[0][:, :, -1, 2], ref[0][:, -1, 2], SIM_SPREAD_FLOOR[1])):
        lo, hi = card_v.min(1), card_v.max(1)
        w = np.maximum(hi - lo, floor)
        ok = (cpu_v >= lo - w) & (cpu_v <= hi + w)
        in_range &= bool(ok.all())
        spread.append(f"{name}: " + "; ".join(
            f"{lane} card {card_v[i, 0]:.4f}, CPU {cpu_v[i]:.4f}, card nudged [{lo[i]:.4f}, "
            f"{hi[i]:.4f}]" for i, lane in enumerate(("home pose", "seeded drop"))))
    log(f"[dynamics] joint_pd_sim f64 B={N_SIM} drops + {2 * SIM_ENSEMBLE} nudged copies of two "
        f"lanes, {SIM_STEPS} steps of 1e-4 s (kp 1000, kd 30, torque limits) on {card}: wall_s "
        f"{wall:.2f} ({1e3 * wall / SIM_STEPS:.2f} ms per step, about {n_k} kernels per step), peak "
        f"{peak:.3f} GB, finite {finite}; the {N_SIM} drops: share of steps with ground force "
        f"{float(contact_share(grfs[:N_SIM]).mean()):.3f}, final base height p50 "
        f"{float(np.median(qs[:N_SIM, -1, 2])):.4f} m, share of joint torques at their limit "
        f"{saturated:.3f}")
    log(f"[dynamics] joint_pd_sim two lanes (home pose, seeded drop) against the CPU in f64 "
        f"({t_cpu:.1f} s on the CPU), joint rates at steps 1 / 5 / 10 / {SIM_CHECK_STEPS}: gap "
        f"{' / '.join(f'{gap[1][k]:.1e}' for k in (1, 5, 10, SIM_CHECK_STEPS))}, the CPU's own "
        f"change under a 1e-15 nudge "
        f"{' / '.join(f'{own[1][k]:.1e}' for k in (1, 5, 10, SIM_CHECK_STEPS))}; every step's gap "
        f"within 20x the own change + 1e-12: {held}")
    log(f"[dynamics] joint_pd_sim over all {SIM_STEPS} steps, the CPU against {SIM_ENSEMBLE} "
        f"nudged copies on the card: {' | '.join(spread)}; largest vertical ground force card "
        f"{float(ens[2][:, 0, :, :, 2].sum(-1).max()):.1f} N, CPU "
        f"{float(ref[2][..., 2].sum(-1).max()):.1f} N; inside the widened range: {in_range}")
    if not finite or not held or not in_range:
        raise AssertionError("joint_pd_sim: non-finite trajectories or a gap to the CPU")


def vbl_phase(torch, card, dev, X, U):
    """Phase 19: the Riccati value function (default weights, f64) along the
    converged srbm_lcp trajectories of phase 4 (X (n, 21, 12), U (n, 20, 24);
    the production dt schedule): P finite and symmetric, the terminal P equal
    to F, two trajectories held against the CPU in f64 to 1e-9 relative."""
    from landing_controller_tpu_torch.analysis import default_vbl_weights, riccati_value_function
    from landing_controller_tpu_torch.warmstart.reference import DT_PRODUCTION

    t_star = np.concatenate([[0.0], np.cumsum(DT_PRODUCTION)])
    Xd, Ud = (torch.as_tensor(a, dtype=torch.float64, device=dev) for a in (X, U))
    (P, P_fwd), wall, peak = run_timed(torch, lambda: riccati_value_function(Xd, Ud, t_star))
    F_, _, _ = default_vbl_weights(torch.float64, dev)
    scale = float(P.abs().max())
    sym = float((P - P.transpose(-1, -2)).abs().max()) / max(1.0, scale)
    finite = bool(torch.isfinite(P).all())
    # the forward RK4 sweep (the reference's consistency check) grows without
    # bound over the 0.75 s horizon at this step, in both packages
    fwd_finite = float(torch.isfinite(P_fwd).flatten(2).all(2).float().mean())
    terminal = bool((P[:, -1] == F_).all())
    ref = riccati_value_function(torch.as_tensor(X[:2], dtype=torch.float64),
                                 torch.as_tensor(U[:2], dtype=torch.float64), t_star)[0]
    err = _rel_err(P[:2].cpu().numpy(), ref.numpy())
    zz = P[:, 0, 2, 2].cpu().numpy()
    log(f"[vbl] riccati_value_function f64 on {len(X)} converged srbm_lcp trajectories of phase 4 "
        f"(N=21, {P.shape[1]} Riccati steps of 0.022 s) on {card}: wall_s {wall:.2f}, peak "
        f"{peak:.3f} GB, P finite {finite}, asymmetry {sym:.3e}, terminal P equal to F {terminal}, "
        f"P(0)[z, z] median {float(np.median(zz)):.4f} range [{zz.min():.4f}, {zz.max():.4f}], "
        f"share of finite forward-sweep steps {fwd_finite:.3f}; P of two trajectories against the "
        f"CPU in f64 {err:.3e} (tolerance 1e-9)")
    if not (finite and terminal and sym <= 1e-10 and err <= 1e-9):
        raise AssertionError("vbl: the value function fails its checks")


ARTIFACT_PATH = os.path.join(BUILD_OUT, "srbm_lcp_b64.lct")
STEP_PATH = os.path.join(BUILD_OUT, "srbm_lcp_step_p64.lcs")
# phase 20: the loaded solve's z against the live one's, scaled by max(1, |z|)
# (the same ops on the same inputs: bit-equal on the CPU)
ARTIFACT_Z_TOL = 1e-5


def load_artifact_child(path, io_path):
    """Phase 20's fresh process: load the saved solver, solve the pool of
    ``io_path + ".in.npz"`` with its qd_inverse launches counted here, time
    its iterations, and write the results to ``io_path + ".out.npz"``.  The
    process never imports the port's problems, solver or api."""
    import torch

    from landing_controller_tpu_torch.ops.pallas_blocks import qd_inverse
    from landing_controller_tpu_torch.runtime.artifact import load_solver

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    inputs = np.load(io_path + ".in.npz")
    t0 = time.time()
    fn = load_solver(path)
    load_s = time.time() - t0
    qd_inverse.launches = 0
    t0 = time.time()
    sol = fn(inputs["q"], inputs["qd"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = qd_inverse.launches
    init, iterate, finish = fn.programs
    n_scaled = fn.header["n_scaled"]
    lanes = init(torch.as_tensor(inputs["q"], device="cuda"),
                 torch.as_tensor(inputs["qd"], device="cuda"))
    scaled, state = lanes[:n_scaled], iterate(*lanes)

    def run(k):
        st = state
        for _ in range(k):
            st = iterate(*scaled, *st)
        return finish(*scaled, *st)

    host_ms, dev_ms = profile_run(torch, run, "srbm_lcp loaded artifact", len(inputs["q"]), card)
    unwanted = [m for m in sys.modules if m.startswith("landing_controller_tpu_torch.")
                and m.split(".")[1] in ("problems", "solver", "api")]
    np.savez(io_path + ".out.npz", z=sol.z.cpu().numpy(), it=sol.iterations.cpu().numpy(),
             conv=sol.converged.cpu().numpy(), launches=launches, load_s=load_s, wall=wall,
             host_ms=host_ms, dev_ms=dev_ms, unwanted=np.array(unwanted, dtype=str))


def deploy_phase(torch, card, launches, dev, kino_ref, qk, qdk, stream_ref):
    """Phase 20: the saved solver and the saved stream step on the card,
    and the viewers on a converged kinodynamic trajectory of phase 6."""
    from landing_controller_tpu_torch import StreamingSolver
    from landing_controller_tpu_torch.dynamics.legs import leg_torques
    from landing_controller_tpu_torch.models import get_robot_model
    from landing_controller_tpu_torch.ops.pallas_blocks import qd_inverse
    from landing_controller_tpu_torch.runtime import enable_persistent_cache, save_solver
    from landing_controller_tpu_torch.viz import export_html, motor_voltages

    repo = os.path.dirname(os.path.abspath(__file__))
    cache = enable_persistent_cache(os.path.join(repo, "build", "kernels"))
    log(f"[deploy] kernel build cache {os.path.relpath(cache, repo)}")
    os.makedirs(BUILD_OUT, exist_ok=True)
    solver, make_stream = srbm_lcp_path()
    q, qd = bench_sampler(0)(N_SCENARIOS)  # phase 4's pool
    t0 = time.time()
    save_solver(solver, ARTIFACT_PATH, batch=N_SCENARIOS)
    log(f"[deploy] save_solver srbm_lcp B={N_SCENARIOS} N=21 f32: traced and written in "
        f"{time.time() - t0:.1f} s, {os.path.getsize(ARTIFACT_PATH) / 1e6:.2f} MB")
    live = solver.solve_batch(q, qd)
    torch.cuda.synchronize()
    # the saved solve in a fresh process that never imports the problem code
    io_path = os.path.join(BUILD_OUT, "artifact_io")
    np.savez(io_path + ".in.npz", q=q, qd=qd)
    code = (f"import chip_smoke; chip_smoke.load_artifact_child({ARTIFACT_PATH!r}, "
            f"{io_path!r})")
    t0 = time.time()
    child = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                           timeout=600)
    for line in child.stdout.strip().splitlines():
        log(f"[deploy]   {line}")
    if child.returncode != 0:
        raise AssertionError(f"the loading process failed:\n{child.stderr[-3000:]}")
    out = np.load(io_path + ".out.npz")
    launches["artifact"] = int(out["launches"])
    it_live, conv_live = live.iterations.cpu().numpy(), live.converged.cpu().numpy()
    z_live = live.z.cpu().numpy()
    dz = float(np.max(np.abs(out["z"] - z_live) / np.maximum(1.0, np.abs(z_live))))
    log(f"[deploy] loaded in a fresh process ({time.time() - t0:.1f} s in all, load "
        f"{float(out['load_s']):.1f} s, solve {float(out['wall']):.2f} s): converged "
        f"{int(out['conv'].sum())}/{N_SCENARIOS} (live {int(conv_live.sum())}), iterations equal "
        f"{bool(np.array_equal(out['it'], it_live))}, largest |dz| / max(1, |z|) {dz:.3e} (limit "
        f"{ARTIFACT_Z_TOL:g}; bit-equal {bool(np.array_equal(out['z'], z_live))}), qd_inverse "
        f"launches in that process {launches['artifact']}, problem modules imported there "
        f"{list(out['unwanted'])}")
    if not (np.array_equal(out["conv"], conv_live) and np.array_equal(out["it"], it_live)
            and dz <= ARTIFACT_Z_TOL and launches["artifact"] > 0 and out["unwanted"].size == 0):
        raise AssertionError("the loaded artifact disagrees with the live solver")
    live_host, live_dev = profile_iteration(torch, solver, q, qd, "srbm_lcp live", card)
    log(f"[deploy] per IP iteration at B={N_SCENARIOS}: live host {live_host:.1f} ms / device "
        f"{live_dev:.2f} ms, loaded host {float(out['host_ms']):.1f} ms / device "
        f"{float(out['dev_ms']):.2f} ms")

    # the StreamingSolver's saved step, run on phase 4's pool
    t0 = time.time()
    make_stream(0).export_step(STEP_PATH, N_SCENARIOS)
    log(f"[deploy] export_step B=64 seg=25 P={N_SCENARIOS}: {time.time() - t0:.1f} s, "
        f"{os.path.getsize(STEP_PATH) / 1e6:.2f} MB")
    loaded = make_stream(0)
    t0 = time.time()
    if loaded.load_step(STEP_PATH, N_SCENARIOS) is not True:
        raise AssertionError("load_step refused the step it was just given")
    load_s = time.time() - t0
    qd_inverse.launches = 0
    stats = loaded.run(N_SCENARIOS)
    torch.cuda.synchronize()
    launches["stream_aot"] = qd_inverse.launches
    other = StreamingSolver(solver, batch=64, segment=24, sampler=bench_sampler(0),
                            attempt_iters=(100, 150))
    refused = other.load_step(STEP_PATH, N_SCENARIOS) is False
    same = np.array_equal(stats["converged_mask"], stream_ref)
    log(f"[deploy] load_step {load_s:.1f} s; loaded stream on {card}: n_finished "
        f"{stats['n_finished']}, converged {stats['n_converged']} (phase 4: "
        f"{int(stream_ref.sum())}), converged_mask equal {same}, wall_s {stats['wall_s']:.2f}, "
        f"qd_inverse launches {launches['stream_aot']}; another segment's key refused {refused}")
    if not (same and refused and launches["stream_aot"] > 0):
        raise AssertionError("the loaded stream step disagrees with phase 4's run")

    # the viewers on the first converged kinodynamic drop of phase 6
    i = int(np.flatnonzero(kino_ref["converged"])[0])
    kino = kinodynamic_solver("cpu")
    z = torch.as_tensor(kino_ref["z"][i : i + 1], dtype=torch.float64)
    v = kino.problem.unpack(z)
    model = get_robot_model()
    tau = leg_torques(model.params, v.jpos, v.X[:, :-1, 3:6], v.U[..., 12:])
    dt = kino.build_params(qk[i : i + 1], qdk[i : i + 1]).dt[0].numpy()
    volts = motor_voltages(model, tau[0].numpy(), v.jpos[0].numpy(), dt)
    html = export_html(os.path.join(BUILD_OUT, "kinodynamic_landing.html"), v.X[0].numpy(),
                       v.U[0].numpy(), dt)
    with open(html) as f:
        page = f.read()
    log(f"[deploy] viewers of kinodynamic drop {i}: largest motor voltage "
        f"{float(np.abs(volts).max()):.2f} V (battery {model.battery_v} V), "
        f"{os.path.relpath(html, repo)} {len(page)} bytes")
    if not (np.isfinite(volts).all() and volts.shape == (20, 12) and "__DATA__" not in page):
        raise AssertionError("the viewers failed on a converged trajectory")


def qd_pair(np_, nd):
    """kernel, plain version and f64 pivot measure at one block split."""
    import torch

    from landing_controller_tpu_torch.ops.pallas_blocks import qd_inverse, qd_inverse_ref

    return ((lambda S: qd_inverse(S, np_, nd)), (lambda S: qd_inverse_ref(S, np_, nd)),
            (lambda S64: qd_rel_least_pivot(torch, S64, np_, nd)))


def variants_phase(torch, card, launches, dev):
    """Phase 5's gentle drop on the card and on the CPU, and phase 7: the
    srbm variants on the card, one scenario each (beside phases 10-20)."""
    from landing_controller_tpu_torch import IPConfig, LandingSolver
    from landing_controller_tpu_torch.ops.pallas_blocks import chol_inverse, qd_inverse
    from landing_controller_tpu_torch.solver import structured

    # one gentle drop on the card (kernel) and on the CPU (plain versions)
    small = dict(kind="srbm_lcp", n_knots=21, dtype=torch.float32, guess="ballistic",
                 config=IPConfig(max_iter=150, hessian_mode="hybrid", mu_min=1e-5, tol=2e-4,
                                 sigma_max=1e5, refine_steps=2, relax_scale=1.0, delta_c=1e-6,
                                 kkt_backend="cri"))
    q0, qd0 = [0.0, 0.0, 0.45, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, -0.5]
    s_gpu = LandingSolver(**small, device=dev).solve(q0, qd0)
    s_cpu = LandingSolver(**small, device="cpu").solve(q0, qd0)
    c_gpu, c_cpu = float(s_gpu.cost), float(s_cpu.cost)
    log(f"[check] gentle drop: card converged {bool(s_gpu.converged)} in {int(s_gpu.iterations)} "
        f"iterations, cost {c_gpu:.6e}; CPU converged {bool(s_cpu.converged)} in "
        f"{int(s_cpu.iterations)}, cost {c_cpu:.6e}")
    if not (bool(s_gpu.converged) and bool(s_cpu.converged)
            and abs(c_gpu - c_cpu) <= 1e-2 * abs(c_cpu) + 1e-12):
        raise AssertionError("the card's solve disagrees with the CPU's")

    # the srbm variants on the card, one scenario each
    def run_variant(name, vsolver, q0, qd0):
        cap = {}
        restore, vsizes = capture_block_inverse_calls(structured, cap, CAPTURE_EVERY)
        qd_inverse.launches = chol_inverse.launches = 0
        try:
            t0 = time.time()
            vsol = vsolver.solve(q0, qd0)
            torch.cuda.synchronize()
            wall = time.time() - t0
        finally:
            restore()
        launches[name] = qd_inverse.launches
        n_levels = cr_launches_per_factor(vsolver.problem.config.n_knots)
        log(f"[{name}] N={vsolver.problem.config.n_knots} on {card}: converged "
            f"{bool(vsol.converged)} in {int(vsol.iterations)} iterations, kkt_error "
            f"{float(vsol.kkt_error):.3e}, constr_viol {float(vsol.constr_viol):.3e}, cost "
            f"{float(vsol.cost):.6e}, wall_s {wall:.2f}, qd_inverse launches {launches[name]} "
            f"({n_levels} per factorization), launch sizes {vsizes[:n_levels]}")
        if launches[name] <= 0 or launches[name] != len(vsizes):
            raise AssertionError(f"{name}: the solve did not go through the qd_inverse kernel")
        if not (torch.isfinite(vsol.z).all() and torch.isfinite(vsol.cost)):
            raise AssertionError(f"{name}: non-finite solution")
        return vsol, cap

    def unscaled_violation(vsolver, vsol, q0, qd0):
        theta = vsolver.build_params(np.asarray([q0], np.float32), np.asarray([qd0], np.float32))
        E = vsolver.problem.eq(vsol.z[None], theta)
        g = vsolver.problem.ineq(vsol.z[None], theta)
        return max(float(E.abs().max()), float(torch.clamp(-g, min=0).max()))

    # sliding: a fast tangential drop on low-friction ground, tol 5e-3 (the
    # family's f32 KKT floor), loqo + corrector
    q0, qd0 = [0.0, 0.0, 0.55, 0.0, 0.1, 0.0], [0.0, 0.0, 0.0, 2.0, 0.0, -2.2]
    sliding = LandingSolver(
        "sliding", n_knots=15, dtype=torch.float32, guess="ballistic", device=dev,
        theta_overrides={"mu": np.float32(0.3)},
        config=IPConfig(max_iter=400, hessian_mode="hybrid", mu_init=0.3, kappa_mu=0.5,
                        mu_min=1e-5, tol=5e-3, sigma_max=1e5, refine_steps=1, relax_scale=1.0,
                        delta_c=1e-6, kkt_backend="cri", mu_strategy="loqo", stall_window=60,
                        stall_min_iter=80, corrector=1))
    vsol, _ = run_variant("sliding", sliding, q0, qd0)
    viol = unscaled_violation(sliding, vsol, q0, qd0)
    log(f"[sliding] unscaled violation {viol:.3e} (< 1e-3)")
    if not (bool(vsol.converged) and float(vsol.constr_viol) < 1e-3 and viol < 1e-3):
        raise AssertionError("sliding: the solve did not converge to a feasible point")

    # contact_scheduled: its own horizon of 16 knots, default settings
    q0, qd0 = [0.0, 0.0, 0.26, 0.03, 0.1, -0.02], [0.1, -0.05, 0.0, 0.05, -0.05, -0.8]
    sched = LandingSolver("contact_scheduled", n_knots=16, dtype=torch.float32, device=dev)
    vsol, cap_sched = run_variant("contact_scheduled", sched, q0, qd0)
    fz_flight = float(vsol.U[:2, 14::3].abs().max())
    log(f"[contact_scheduled] largest flight-leg force {fz_flight:.3e} N (< 2e-3)")
    if not (bool(vsol.converged) and int(vsol.iterations) < 60
            and float(vsol.constr_viol) < 1e-3 and fz_flight < 2e-3):
        raise AssertionError("contact_scheduled: not converged within 60 iterations")
    k40, p40, piv40 = qd_pair(36, 40)
    check_real_blocks(torch, "qd_inverse (36,40) contact_scheduled", k40, p40, cap_sched, piv40)

    # ccc: 41 blocks, f32, the solver's default settings with 150 iterations
    # on the gentle drop; held to finiteness and launches, the outcome is logged
    q0, qd0 = [0.0, 0.0, 0.45, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, -0.5]
    ccc_cfg = LandingSolver("ccc", n_knots=41, dtype=torch.float32, device=dev).config
    ccc = LandingSolver("ccc", n_knots=41, dtype=torch.float32, device=dev,
                        config=dataclasses.replace(ccc_cfg, max_iter=150))
    run_variant("ccc", ccc, q0, qd0)


N_MC_RECORD, MC_RECORD_CHUNK = 256, 128  # phase 21: the Monte-Carlo record's drops, its pool
# the keys of bench.py's row without vs_baseline (bench.py:297-314, 417-421)
BENCH_KEYS = {"metric", "value", "unit", "mode", "n_scenarios", "wall_s", "convergence_rate",
              "iters_p50", "iters_p90", "batch", "segment", "guess", "retry_guess", "tol",
              "mu_strategy", "retry_failed", "compile_s"}
BENCH_TIMEOUT_S = 480


def bench_phase(card, launches):
    """Phase 21: the port's bench with its defaults in a process of its own;
    its last line (the row) and its "# measured run" line are read back."""
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    out = subprocess.run([sys.executable, "-m", "landing_controller_tpu_torch.bench"], cwd=repo,
                         capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.time() - t0
    os.makedirs(BUILD_OUT, exist_ok=True)
    with open(os.path.join(BUILD_OUT, "bench.log"), "w") as f:
        f.write(out.stdout + out.stderr)
    if out.returncode != 0:
        raise AssertionError(f"the bench exited {out.returncode}: {out.stderr[-2000:]}")
    lines = out.stdout.strip().splitlines()
    row = json.loads(lines[-1])
    tag = "# measured run: "
    run = json.loads(next(line for line in lines if line.startswith(tag))[len(tag):])
    snapshots = sum(line.startswith("{") for line in lines[:-1])
    for line in lines:
        if line.startswith("#"):
            log(f"[bench] {line}")
    log(f"[bench] python -m landing_controller_tpu_torch.bench, on {card}: {wall:.1f} s in all, "
        f"{snapshots} snapshot rows; last line {json.dumps(row)}")
    per_iter = run["qd_inverse_launches"] / max(run["batch_iterations"], 1)
    log(f"[bench] qd_inverse launches {run['qd_inverse_launches']} in {run['batch_iterations']} "
        f"batch iterations ({per_iter:.2f} per iteration), peak device memory "
        f"{run['peak_device_memory_gb']:.3f} GB, pool set-up {run['pool_setup_s']} s")
    if set(row) != BENCH_KEYS:
        raise AssertionError(f"the bench's row has keys {sorted(row)}")
    if (row["n_scenarios"], row["batch"], row["segment"]) != (384, 64, 25) or not snapshots:
        raise AssertionError("the bench did not run its pool of 384 at B=64, segment 25")
    if row["convergence_rate"] < CONVERGENCE_FLOOR:
        raise AssertionError(f"the bench's convergence_rate {row['convergence_rate']} < "
                             f"{CONVERGENCE_FLOOR}")
    if run["qd_inverse_launches"] <= 0 or run["qd_inverse_launches"] != 6 * run["batch_iterations"]:
        raise AssertionError("the bench did not launch qd_inverse 6 times per batch iteration")
    launches["bench"] = run["qd_inverse_launches"]


def montecarlo_record_phase(torch, card, launches):
    """Phase 21, beside phases 10-20: the port's tools.montecarlo_100k over
    two pools, its record read back."""
    from landing_controller_tpu_torch.ops.pallas_blocks import qd_inverse
    from landing_controller_tpu_torch.tools import montecarlo_100k

    path = os.path.join(BUILD_OUT, "montecarlo_100k.json")
    qd_inverse.launches = 0
    _, wall, _ = run_timed(torch, lambda: montecarlo_100k.main(
        ["--n", str(N_MC_RECORD), "--chunk", str(MC_RECORD_CHUNK), "--out", path]))
    launches["montecarlo_100k"] = qd_inverse.launches
    with open(path) as f:
        rec = json.load(f)
    region = rec["success_region"]
    counted = sum(map(sum, region["count"]))
    log(f"[montecarlo_100k] --n {N_MC_RECORD} --chunk {MC_RECORD_CHUNK}, on {card}: finished "
        f"{rec['n_finished']}, convergence_rate {rec['convergence_rate']}, "
        f"converged_per_sec_per_chip {rec['converged_per_sec_per_chip']}, iters p50 "
        f"{rec['iters_p50']} p90 {rec['iters_p90']}, pool set-up {rec['pool_setup_s']} s, peak "
        f"device memory {rec['peak_device_memory_gb']:.3f} GB, tool wall {wall:.1f} s, "
        f"qd_inverse launches {launches['montecarlo_100k']}; map cells count {counted}")
    if rec["n_finished"] != N_MC_RECORD or counted != N_MC_RECORD:
        raise AssertionError("the Monte-Carlo record does not hold every drop once")
    if rec["convergence_rate"] < CONVERGENCE_FLOOR or launches["montecarlo_100k"] <= 0:
        raise AssertionError("the Monte-Carlo record failed its checks")


def example_phase(torch, card, launches):
    """Phase 21, beside phases 10-20: examples.solve_landing --cascade with
    the HTML viewer under build/."""
    from landing_controller_tpu_torch.examples import solve_landing
    from landing_controller_tpu_torch.ops.pallas_blocks import qd_inverse

    path = os.path.join(BUILD_OUT, "solve_landing.html")
    os.makedirs(BUILD_OUT, exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    qd_inverse.launches = 0
    _, wall, _ = run_timed(torch, lambda: solve_landing.main(["--cascade", "--plot", path]))
    launches["solve_landing"] = qd_inverse.launches
    with open(path) as f:
        page = f.read()
    log(f"[example] solve_landing --cascade --plot, on {card}: {wall:.1f} s, qd_inverse launches "
        f"{launches['solve_landing']}, viewer {len(page)} bytes")
    if "__DATA__" in page or launches["solve_landing"] <= 0:
        raise AssertionError("the example failed its checks")


# phase 22: the convergence diagnostics at cut depth (PERF.md §13).  iter_bench
# runs two of its quick configurations with a budget of two segments (of
# 20 iterations), alone on the card; the other four tools run beside phases
# 10-20 at batch DIAG_BATCH (tune_sweep keeps its own 64) and DIAG_MAX_ITER
# iterations.  On a slow host the script reached 1102 s of its 1200 s with
# 100 iterations there and B=32, 60 iterations here (PERF.md §13)
ITER_BENCH_CONFIGS, ITER_BENCH_ITERS = ("r2-bench-baseline", "lean-gn"), 40
CONV_BATTERY_RUNS = ("baseline-200", "loqo-200")
DIAG_BATCH, DIAG_MAX_ITER = 16, 30


def check_diag_record(label, rec, keys, cap, iters, passes=1):
    """A tool's record (or one run of it): the keys ``keys``, every number
    finite, the iterations ``iters`` at most ``cap``, at most ``cap`` batch
    iterations in each of its ``passes`` solves, and 6 qd_inverse launches
    per batch iteration (one per cyclic-reduction level of the 21-block
    horizon)."""
    missing = [k for k in keys if k not in rec]
    if missing:
        raise AssertionError(f"{label}: the record lacks {missing}")

    def numbers(x):
        if isinstance(x, dict):
            return [v for y in x.values() for v in numbers(y)]
        if isinstance(x, list):
            return [v for y in x for v in numbers(y)]
        return [x] if isinstance(x, (int, float)) and not isinstance(x, bool) else []

    if not np.isfinite(numbers(rec)).all():
        raise AssertionError(f"{label}: non-finite numbers in the record")
    if max(iters) > cap:
        raise AssertionError(f"{label}: {max(iters)} iterations over the cap {cap}")
    n_iter, n_launch = rec["batch_iterations"], rec["qd_inverse_launches"]
    if not 0 < n_iter <= passes * cap:
        raise AssertionError(f"{label}: {n_iter} batch iterations in {passes} solves of at most "
                             f"{cap}")
    if n_launch != 6 * n_iter:
        raise AssertionError(f"{label}: {n_launch} qd_inverse launches in {n_iter} batch "
                             f"iterations, not 6 per iteration")


def iter_bench_phase(torch, card, launches, phase9):
    """Phase 22, alone on the card after phase 9: tools.iter_bench's
    configurations ITER_BENCH_CONFIGS at B=64 over two segments of half of
    ITER_BENCH_ITERS (the first one untimed), beside phase 9's srbm_lcp host and device ms
    per iteration ``phase9``."""
    from landing_controller_tpu_torch.ops.pallas_blocks import qd_inverse
    from landing_controller_tpu_torch.tools import iter_bench

    runs = {name: (B, kw) for name, B, kw in iter_bench.QUICK_RUNS}
    qd_inverse.launches = 0
    t0 = time.time()
    recs = [iter_bench.run_config(name, *runs[name], "cuda", n_iters=ITER_BENCH_ITERS)
            for name in ITER_BENCH_CONFIGS]
    launches["iter_bench"] = qd_inverse.launches
    for rec in recs:
        label = f"iter_bench {rec['name']}"
        check_diag_record(label, rec, iter_bench.RUN_KEYS, ITER_BENCH_ITERS, [rec["iters_p90"]])
        log(f"[diagnostics] {label} B={rec['B']}, {ITER_BENCH_ITERS} iterations on {card}: "
            f"{rec['ms_per_iter_batch']} ms per batch iteration ({rec['us_per_iter_lane']} us per "
            f"lane), compile_s {rec['compile_s']}, conv {rec['conv']}, iters p50 "
            f"{rec['iters_p50']:.0f} p90 {rec['iters_p90']:.0f}, est_solves_s "
            f"{rec['est_solves_s']}, qd_inverse launches {rec['qd_inverse_launches']} in "
            f"{rec['batch_iterations']} batch iterations")
    if sum(rec["qd_inverse_launches"] for rec in recs) != launches["iter_bench"]:
        raise AssertionError(f"iter_bench: its records miss some of its "
                             f"{launches['iter_bench']} qd_inverse launches")
    log(f"[diagnostics] iter_bench r2-bench-baseline {recs[0]['ms_per_iter_batch']} ms per batch "
        f"iteration (monotone, no corrector) against phase 9's srbm_lcp (the bench's loqo with "
        f"a corrector) host {phase9[0]:.1f} ms, device busy {phase9[1]:.2f} ms per iteration; "
        f"the phase {time.time() - t0:.1f} s")


def diagnostics_phase(torch, card, launches):
    """Phase 22, beside phases 10-20: tools.conv_battery (CONV_BATTERY_RUNS),
    diag_conv on cri, fail_taxonomy and tune_sweep ``lean`` at cut depth,
    each record read back and checked, its launches against the count of
    the tool's run."""
    from landing_controller_tpu_torch.ops.pallas_blocks import qd_inverse
    from landing_controller_tpu_torch.tools import conv_battery, diag_conv, fail_taxonomy, tune_sweep

    cap, B = DIAG_MAX_ITER, DIAG_BATCH
    os.makedirs(BUILD_OUT, exist_ok=True)

    def counted_run(name, fn, launches_of):
        qd_inverse.launches = 0
        t0 = time.time()
        out = fn()
        launches[name] = qd_inverse.launches
        if launches_of(out) != launches[name]:
            raise AssertionError(f"{name}: its record holds {launches_of(out)} of its "
                                 f"{launches[name]} qd_inverse launches")
        return out, time.time() - t0

    def tool(name, module, argv, launches_of=lambda rec: rec["qd_inverse_launches"]):
        path = os.path.join(BUILD_OUT, f"{name}.json")
        if os.path.exists(path):
            os.remove(path)

        def main():
            module.main(argv + ["--max-iter", str(cap), "--out", path])
            with open(path) as f:
                return json.load(f)

        return counted_run(name, main, launches_of)

    runs = dict(conv_battery.QUICK_RUNS)
    recs, wall = counted_run(
        "conv_battery",
        lambda: [conv_battery.run_config(n, B, runs[n], "cuda", max_iter=cap)
                 for n in CONV_BATTERY_RUNS],
        lambda recs: sum(rec["qd_inverse_launches"] for rec in recs))
    for rec in recs:
        label = f"conv_battery {rec['name']}"
        check_diag_record(label, rec, conv_battery.RUN_KEYS, cap, [rec["iters_p90"]])
        log(f"[diagnostics] {label} B={B} max_iter {cap} on {card}: conv {rec['conv']}, iters "
            f"mean {rec['iters_mean']} p50 {rec['iters_p50']:.0f} p90 {rec['iters_p90']:.0f}, "
            f"failed {rec['n_fail']} (kkt only {rec['fail_kkt_only']}), qd_inverse launches "
            f"{rec['qd_inverse_launches']} in {rec['batch_iterations']} batch iterations")
    log(f"[diagnostics] conv_battery: {wall:.1f} s")

    rec, wall = tool("diag_conv", diag_conv, [str(B), "cri"])
    check_diag_record("diag_conv", rec, diag_conv.RECORD_KEYS, cap, [rec["it_max"]], passes=2)
    log(f"[diagnostics] diag_conv B={B} cri monotone legacy max_iter {cap} on {card}: timed pass "
        f"{rec['wall_s']:.2f} s (first {rec['first_pass_s']:.2f} s), conv {rec['conv']:.3f}, it "
        f"p50/p90/max {rec['it_p50']:.0f}/{rec['it_p90']:.0f}/{rec['it_max']}, solves/s "
        f"{rec['solves_s']:.2f}, {len(rec['lanes'])} failed lanes' histories; qd_inverse launches "
        f"{rec['qd_inverse_launches']} in {rec['batch_iterations']} batch iterations (two "
        f"passes); tool wall {wall:.1f} s")

    rec, wall = tool("fail_taxonomy", fail_taxonomy, [str(B)])
    check_diag_record("fail_taxonomy", rec, fail_taxonomy.RECORD_KEYS, cap,
                      [lane["it"] for lane in rec["failed_lanes"]] + [0])
    log(f"[diagnostics] fail_taxonomy B={B} loqo max_iter {cap} on {card}: conv {rec['conv']:.3f}, "
        f"{len(rec['failed_lanes'])} failed lanes, dominant groups "
        f"{rec.get('dominant_group_counts', {})}; qd_inverse launches {rec['qd_inverse_launches']} "
        f"in {rec['batch_iterations']} batch iterations; tool wall {wall:.1f} s")

    rec, wall = tool("tune_sweep", tune_sweep, ["lean"],
                     lambda rec: rec["configs"]["lean"]["qd_inverse_launches"])
    lean = rec["configs"]["lean"]
    check_diag_record("tune_sweep lean", lean, tune_sweep.RUN_KEYS, cap, [lean["it_p90"]],
                      passes=2)
    log(f"[diagnostics] tune_sweep lean B={lean['B']} max_iter {cap} on {card}: wall "
        f"{lean['wall_s']:.2f} s (comp {lean['comp_s']:.2f} s), conv {lean['conv']:.3f}, it "
        f"p50/p90 {lean['it_p50']:.0f}/{lean['it_p90']:.0f}, solves/s {lean['solves_s']:.2f}; "
        f"qd_inverse launches {lean['qd_inverse_launches']} in {lean['batch_iterations']} batch "
        f"iterations (two passes); tool wall {wall:.1f} s")


SIDE_PHASES = ("dense", "eeparam", "backends", "cascade", "factory", "warmstart", "montecarlo",
               "f64", "dynamics", "vbl", "deploy", "montecarlo_100k", "example", "variants",
               "diagnostics")


def side_phase(name, card, qk, qdk, kino_ref, vbl_traj, stream_ref):
    """One of phases 10-20 or phase 21's and phase 22's side runs in a process of its own;
    returns its kernel launch counts {path: launches} and its readings
    {name: value} for the checks across phases."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches, readings = {}, {}
    t0 = time.time()
    if name == "dense":
        dense_path(torch, card, kinodynamic_solver("cuda"), kino_ref, qk, qdk, "cuda")
    elif name == "eeparam":
        eeparam_phase(torch, card, "cuda")
    elif name == "backends":
        backends_phase(torch, card, srbm_lcp_path()[0], launches, "cuda")
    elif name == "cascade":
        cascade_phase(torch, card, kino_ref, srbm_lcp_path()[0], qk, qdk, launches, "cuda")
    elif name in ("factory", "warmstart"):
        {"factory": factory_phase, "warmstart": warmstart_phase}[name](torch, card, launches,
                                                                     "cuda")
    elif name == "dynamics":
        dynamics_phase(torch, card, "cuda")
    elif name == "vbl":
        vbl_phase(torch, card, "cuda", *vbl_traj)
    elif name == "deploy":
        deploy_phase(torch, card, launches, "cuda", kino_ref, qk, qdk, stream_ref)
    elif name == "montecarlo_100k":
        montecarlo_record_phase(torch, card, launches)
    elif name == "example":
        example_phase(torch, card, launches)
    elif name == "variants":
        variants_phase(torch, card, launches, "cuda")
    elif name == "diagnostics":
        diagnostics_phase(torch, card, launches)
    else:
        {"montecarlo": montecarlo_phase, "f64": f64_phase}[name](torch, card, launches, "cuda",
                                                                 readings)
    log(f"[{name}] phase done in {time.time() - t0:.1f} s")
    return launches, readings


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def srbm_lcp_path():
    """The srbm_lcp solver of the repo's benchmark settings on the card, and
    a function seed -> its streaming solver (B=64, 25-iteration segments,
    deadlines (100, 150)): the port's bench (``bench_solver``,
    ``bench_stream``)."""
    from landing_controller_tpu_torch.bench import bench_solver, bench_stream

    solver = bench_solver("cuda")

    def make_stream(seed):
        return bench_stream(solver, bench_sampler(seed), collect_z=True)

    return solver, make_stream


def main() -> int:
    t_start = time.time()
    import torch

    # ---- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; {card}")

    from landing_controller_tpu_torch import LandingSolver
    from landing_controller_tpu_torch import ops
    from landing_controller_tpu_torch.ops import _build, pallas_blocks
    from landing_controller_tpu_torch.ops.pallas_blocks import (chol_inverse, chol_inverse_ref,
                                                               qd_inverse)
    from landing_controller_tpu_torch.solver import structured

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")

    # ---- 2. build
    t0 = time.time()
    _build.load_libraries(_build.KERNELS)
    log(f"[build] {', '.join(_build.KERNELS)}: {time.time() - t0:.1f} s")
    for name, out in _build.build_logs.items():
        for line in out.strip().splitlines():
            log(f"[build] {name}: {line}")

    # ---- 3. kernel parity on random blocks; timings at the largest level of
    # the srbm_lcp path (64 lanes x 2 ladder candidates x 10 blocks) and of the
    # kinodynamic path (128 x 4 x 10), at their one-wave levels (x 1 block),
    # and of the run-time instance at a shape no template serves
    rng = np.random.default_rng(0)

    def parity(name, kernel_fn, plain_fn, x_np, label):
        """Kernel vs plain version on blocks whose block 3 is made
        indefinite; returns (blocks on the card, max abs error)."""
        m = x_np.shape[0]
        if m > 3:
            x_np[3, 0, 0] = -5.0
        n_bad = int(m > 3)
        x = torch.as_tensor(x_np, device=dev)
        out_k, ok_k = kernel_fn(x)
        out_p, ok_p = plain_fn(x)
        torch.cuda.synchronize()
        if not torch.equal(ok_k, ok_p) or int(ok_k.sum()) != m - n_bad or (n_bad and bool(ok_k[3])):
            raise AssertionError(f"{name} ok flags disagree at {label}")
        if not torch.isfinite(out_k[ok_k]).all():
            raise AssertionError(f"{name} kernel output is not finite on ok blocks at {label}")
        a, b = out_k[ok_k], out_p[ok_k]
        err = float((a - b).abs().max())
        if not bool(((a - b).abs() <= 2e-4 + 2e-4 * b.abs()).all()):
            raise AssertionError(f"{name} kernel disagrees at {label}: {err}")
        if not torch.equal(a, a.transpose(1, 2)):
            raise AssertionError(f"{name} kernel output is not symmetric bit for bit at {label}")
        log(f"[parity] {name} {label}: max_abs_err {err:.3e} (rtol=atol=2e-4), ok flags agree "
            f"({m - n_bad}/{m} ok), symmetric bit for bit")
        return x, err

    def timed(name, kernel_fn, plain_fn, library, x, err, bound, label):
        """One record of the kernels line: kernel, plain version and library
        calls {name: fn} timed on x."""
        rec = {"max_abs_err": err, "ms": median_ms(torch, lambda: kernel_fn(x)),
               "plain_ms": median_ms(torch, lambda: plain_fn(x))}
        lib = {k: median_ms(torch, fn) for k, fn in library.items()}
        rec["library_ms"] = min(lib.values())
        rec["bound_ms"], rec["bound_by"] = bound
        log(f"[time] {name} {label} on {card}: kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in lib.items())
            + f", bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), kernel / bound "
            f"{rec['ms'] / rec['bound_ms']:.1f}")
        return rec

    qd_recs = {}
    for np_, nd, m in ((36, 24, 1280), (36, 24, 128), (48, 36, 5120), (48, 36, 512),
                       (36, 40, 256), (30, 20, 1280)):
        kernel_fn, plain_fn, _ = qd_pair(np_, nd)
        label = f"({np_},{nd}) m={m}"
        S, err = parity("qd_inverse", kernel_fn, plain_fn, random_qd_blocks(rng, m, np_, nd), label)
        if (np_, nd) != (36, 40):
            qd_recs[(np_, nd, m)] = timed(
                "qd_inverse", kernel_fn, plain_fn, {"torch.linalg.inv": lambda: torch.linalg.inv(S)},
                S, err, qd_inverse_bound_ms(m, np_, nd), label)
    rec_qd = {**qd_recs[(36, 24, 1280)], "one_wave_shape": "(np, nd) = (36, 24), m = 128",
              "one_wave_ms": qd_recs[(36, 24, 128)]["ms"],
              "one_wave_bound_ms": qd_recs[(36, 24, 128)]["bound_ms"]}
    rec_qd_kino = {**qd_recs[(48, 36, 5120)], "one_wave_shape": "(np, nd) = (48, 36), m = 512",
                   "one_wave_ms": qd_recs[(48, 36, 512)]["ms"],
                   "one_wave_bound_ms": qd_recs[(48, 36, 512)]["bound_ms"]}
    chol_recs = {}
    for n, m in ((24, 1280), (36, 1280), (48, 5120), (48, 512), (84, 256)):
        label = f"n={n} m={m}"
        A, err = parity("chol_inverse", chol_inverse, chol_inverse_ref, random_spd_blocks(rng, m, n),
                        label)
        if n == 48:
            A_ok = torch.cat([A[:3], A[4:]])  # the library calls raise on an indefinite block
            chol_recs[m] = timed(
                "chol_inverse", chol_inverse, chol_inverse_ref,
                {"torch.linalg.inv": lambda: torch.linalg.inv(A_ok),
                 f"cholesky + cholesky_inverse (m={m - 1})":
                     lambda: torch.cholesky_inverse(torch.linalg.cholesky(A_ok))},
                A, err, chol_inverse_bound_ms(m, n), label)
    rec_chol = {**chol_recs[5120], "one_wave_shape": "n = 48, m = 512",
                "one_wave_ms": chol_recs[512]["ms"], "one_wave_bound_ms": chol_recs[512]["bound_ms"]}
    # shared memory (as the loaded library sizes its launches) and resident
    # blocks per SM of the instances the paths run
    occupancy = {}
    for name, sizes in ([("qd_inverse", s) for s in ((36, 24), (48, 36), (36, 40))]
                        + [("chol_inverse", (n,)) for n in (36, 48)]):
        smem = pallas_blocks.library_smem_bytes(name, *sizes)
        if smem != pallas_blocks.block_smem_bytes(sum(sizes)):
            raise AssertionError(f"{name} {sizes}: the library takes {smem} bytes of shared memory, "
                                 f"its Python mirror says {pallas_blocks.block_smem_bytes(sum(sizes))}")
        occupancy[(name, sizes)] = (smem, pallas_blocks.blocks_per_sm(name, *sizes))
        log(f"[build] {name} {sizes}: {smem} bytes of shared memory per block, "
            f"{occupancy[(name, sizes)][1]} blocks per SM")
    for rec, key in ((rec_qd, ("qd_inverse", (36, 24))), (rec_qd_kino, ("qd_inverse", (48, 36))),
                     (rec_chol, ("chol_inverse", (48,)))):
        rec["smem_bytes"], rec["blocks_per_sm"] = occupancy[key]

    # the double instances: against the plain version in f64 (on the CPU) and
    # against the f32 kernel's error at the same shape; timed like the f32 ones
    def parity64(name, kernel_fn, plain_fn, x_np, label, err32):
        m = x_np.shape[0]
        x_np = x_np.astype(np.float64)
        x_np[3, 0, 0] = -5.0
        x = torch.as_tensor(x_np, device=dev)
        out_k, ok_k = kernel_fn(x)
        out_p, ok_p = plain_fn(x.cpu())
        torch.cuda.synchronize()
        if (out_k.dtype != torch.float64 or not torch.equal(ok_k.cpu(), ok_p)
                or int(ok_p.sum()) != m - 1 or bool(ok_p[3])):
            raise AssertionError(f"{name} f64 ok flags disagree at {label}")
        a, b = out_k[ok_k].cpu(), out_p[ok_p]
        err = float((a - b).abs().max())
        if not bool(((a - b).abs() <= 1e-10 + 1e-10 * b.abs()).all()) or not err < err32:
            raise AssertionError(f"{name} f64 kernel disagrees at {label}: {err} (f32 kernel {err32})")
        if not torch.equal(out_k[ok_k], out_k[ok_k].transpose(1, 2)):
            raise AssertionError(f"{name} f64 kernel output is not symmetric bit for bit at {label}")
        log(f"[parity] {name} f64 {label}: max_abs_err {err:.3e} against the plain version in f64 on "
            f"the CPU (rtol=atol=1e-10; the f32 kernel's {err32:.3e}), ok flags agree ({m - 1}/{m} ok), "
            f"symmetric bit for bit")
        return x, err

    qd64_recs = {}
    for np_, nd, m in ((36, 24, 1280), (48, 36, 5120), (30, 20, 1280)):
        kernel_fn, plain_fn, _ = qd_pair(np_, nd)
        label = f"({np_},{nd}) m={m}"
        S, err = parity64("qd_inverse", kernel_fn, plain_fn, random_qd_blocks(rng, m, np_, nd),
                          label, qd_recs[(np_, nd, m)]["max_abs_err"])
        qd64_recs[(np_, nd)] = timed(
            "qd_inverse f64", kernel_fn, plain_fn, {"torch.linalg.inv": lambda: torch.linalg.inv(S)},
            S, err, qd_inverse_bound_ms(m, np_, nd, itemsize=8), label)
    A, err = parity64("chol_inverse", chol_inverse, chol_inverse_ref, random_spd_blocks(rng, 5120, 48),
                      "n=48 m=5120", chol_recs[5120]["max_abs_err"])
    A_ok = torch.cat([A[:3], A[4:]])
    rec_chol64 = timed("chol_inverse f64", chol_inverse, chol_inverse_ref,
                       {"torch.linalg.inv": lambda: torch.linalg.inv(A_ok),
                        "cholesky + cholesky_inverse (m=5119)":
                            lambda: torch.cholesky_inverse(torch.linalg.cholesky(A_ok))},
                       A, err, chol_inverse_bound_ms(5120, 48, itemsize=8), "n=48 m=5120")
    for name, sizes, rec in (("qd_inverse", (36, 24), qd64_recs[(36, 24)]),
                             ("qd_inverse", (48, 36), qd64_recs[(48, 36)]),
                             ("qd_inverse", (30, 20), qd64_recs[(30, 20)]),
                             ("chol_inverse", (48,), rec_chol64)):
        smem = pallas_blocks.library_smem_bytes(name, *sizes, dtype=torch.float64)
        mirror = pallas_blocks.block_smem_bytes(sum(sizes), torch.float64)
        if smem != mirror:
            raise AssertionError(f"{name} {sizes} f64: the library takes {smem} bytes of shared "
                                 f"memory, its Python mirror says {mirror}")
        rec["smem_bytes"] = smem
        rec["blocks_per_sm"] = pallas_blocks.blocks_per_sm(name, *sizes, dtype=torch.float64)
        log(f"[build] {name} {sizes} f64: {smem} bytes of shared memory per block, "
            f"{rec['blocks_per_sm']} blocks per SM")

    # ---- 4. the srbm_lcp path
    t0 = time.time()
    solver, make_stream = srbm_lcp_path()
    log(f"[srbm_lcp] tf32 after solver build: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    # warm-up: one segment on a 64-scenario pool (first-call costs)
    make_stream(1).run(64, max_wall_s=0.0)
    torch.cuda.synchronize()
    log(f"[srbm_lcp] warm-up {time.time() - t0:.1f} s")
    ss = make_stream(0)
    cap_srbm = {}
    restore, sizes_srbm = capture_block_inverse_calls(structured, cap_srbm, CAPTURE_EVERY)
    launches = {}
    qd_inverse.launches = chol_inverse.launches = 0
    try:
        t0 = time.time()
        stats = ss.run(N_SCENARIOS)
        torch.cuda.synchronize()
        t_run = time.time() - t0
    finally:
        restore()
    launches["srbm_lcp"] = qd_inverse.launches
    log(f"[srbm_lcp] streaming B=64 seg=25 on {card}: n_finished {stats['n_finished']}, "
        f"convergence_rate {stats['convergence_rate']:.4f}, iters_p50 {stats['iters_p50']:.0f}, "
        f"iters_p90 {stats['iters_p90']:.0f}, wall_s {stats['wall_s']:.2f} "
        f"(with pool set-up {t_run:.2f}), converged solves/s {stats['converged_per_sec']:.3f}")
    log(f"[srbm_lcp] qd_inverse kernel launches: {launches['srbm_lcp']}")
    if stats["n_finished"] != N_SCENARIOS:
        raise AssertionError(f"only {stats['n_finished']} of {N_SCENARIOS} scenarios finished")
    if not (np.isfinite(stats["z"]).all() and np.isfinite(stats["viol"]).all()):
        raise AssertionError("NaN in the harvested results")
    if launches["srbm_lcp"] <= 0:
        raise AssertionError("the srbm_lcp path launched no qd_inverse kernel")
    if sizes_srbm[:6] != cr_launch_sizes(21, 64, 2):
        raise AssertionError(f"unexpected srbm_lcp launch sizes {sizes_srbm[:6]}")
    if stats["convergence_rate"] < CONVERGENCE_FLOOR:
        raise AssertionError(f"convergence_rate {stats['convergence_rate']:.3f} < "
                             f"{CONVERGENCE_FLOOR}")

    # ---- 5. checks of the srbm_lcp output
    # (a) kernel vs plain on the real KKT blocks of the path
    k36, p36, piv36 = qd_pair(36, 24)
    check_real_blocks(torch, "qd_inverse (36,24) srbm_lcp", k36, p36, cap_srbm, piv36)
    # (b) harvested converged solutions are feasible on the unscaled problem
    q_np, qd_np = bench_sampler(0)(N_SCENARIOS)
    conv = stats["converged_mask"]
    check_feasible(torch, solver, torch.as_tensor(stats["z"][conv], device=dev), q_np[conv],
                   qd_np[conv], stats["viol"][conv], "srbm_lcp")
    lanes = solver.problem.unpack(torch.as_tensor(stats["z"][conv]))
    vbl_traj = (lanes.X.numpy(), lanes.U.numpy())  # phase 19's trajectories
    # ---- 6. the kinodynamic path at full width: N=21, 84-wide blocks
    kino = kinodynamic_solver("cuda")
    qk, qdk = sample_drop_scenarios(11, N_KINO)
    cap_kino = {}
    restore, sizes = capture_block_inverse_calls(structured, cap_kino, CAPTURE_EVERY_KINO)
    torch.cuda.reset_peak_memory_stats()
    qd_inverse.launches = chol_inverse.launches = 0
    try:
        t0 = time.time()
        sol = kino.solve_batch(qk, qdk)
        torch.cuda.synchronize()
        t_kino = time.time() - t0
    finally:
        restore()
    launches["kinodynamic"] = qd_inverse.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    conv_k = sol.converged.cpu().numpy()
    its = sol.iterations.cpu().numpy()
    n_iter = int(its.max())
    log(f"[kinodynamic] solve_batch B={N_KINO} N=21 on {card}: convergence_rate "
        f"{conv_k.mean():.4f}, iters_p50 {np.percentile(its, 50):.0f}, iters_p90 "
        f"{np.percentile(its, 90):.0f}, batch iterations {n_iter}, wall_s {t_kino:.2f} "
        f"(set-up included), converged solves/s {conv_k.sum() / t_kino:.3f}, "
        f"{1e3 * t_kino / max(n_iter, 1):.1f} ms per batch iteration, peak device memory "
        f"{peak_gb:.3f} GB")
    log(f"[kinodynamic] qd_inverse kernel launches: {launches['kinodynamic']} "
        f"({launches['kinodynamic'] / max(n_iter, 1):.2f} per batch iteration), launch sizes of "
        f"one iteration m = {sizes[:6]}, joint torque max {float(sol.tau.abs().max()):.2f} N m")
    if launches["kinodynamic"] <= 0 or launches["kinodynamic"] != len(sizes):
        raise AssertionError("the kinodynamic path did not go through the qd_inverse kernel")
    if sizes[:6] != cr_launch_sizes(21, N_KINO, 4):
        raise AssertionError(f"unexpected kinodynamic launch sizes {sizes[:6]}")
    for name in ("z", "X", "jpos", "U", "tau", "cost", "kkt_error", "constr_viol"):
        if not torch.isfinite(getattr(sol, name)).all():
            raise AssertionError(f"kinodynamic: non-finite values in the solution's {name}")
    if sol.jpos.shape != (N_KINO, 20, 12) or sol.z.shape != (N_KINO, kino.problem.n_vars):
        raise AssertionError("kinodynamic: unexpected solution shapes")
    if conv_k.mean() < 0.4:
        raise AssertionError(f"kinodynamic convergence_rate {conv_k.mean():.3f} < 0.4")
    check_feasible(torch, kino, sol.z[sol.converged], qk[conv_k], qdk[conv_k],
                   sol.constr_viol[sol.converged], "kinodynamic")
    k48, p48, piv48 = qd_pair(48, 36)
    check_real_blocks(torch, "qd_inverse (48,36) kinodynamic", k48, p48, cap_kino, piv48)

    # ---- 8. the ops.chol_inverse entry point on the SPD sub-blocks P of the
    # captured KKT blocks of both families (P = S[:np, :np]; taken from the
    # blocks the qd_inverse kernel flags ok, whose P its Cholesky accepted)
    spd = {}
    for label, cap, np_, nd in (("srbm_lcp", cap_srbm, 36, 24), ("kinodynamic", cap_kino, 48, 36)):
        for call in sorted(cap)[:12]:
            S = cap[call]
            spd[(label, call)] = S[qd_inverse(S, np_, nd)[1]][:, :np_, :np_].contiguous()
    qd_inverse.launches = chol_inverse.launches = 0
    n_spd = 0
    for (label, call), P in sorted(spd.items()):
        Pinv, ok = ops.chol_inverse(P)
        n_spd += P.shape[0]
        if not bool(ok.all()):
            raise AssertionError(f"chol_inverse rejects an SPD sub-block of {label} call {call}")
    torch.cuda.synchronize()
    launches["chol_inverse"] = chol_inverse.launches
    log(f"[chol_inverse] entry point on {n_spd} SPD sub-blocks of {len(spd)} captured calls "
        f"(n = 36 and 48): {launches['chol_inverse']} kernel launches, all ok")
    if launches["chol_inverse"] != len(spd) or launches["chol_inverse"] <= 0:
        raise AssertionError("the chol_inverse entry point did not launch its kernel")
    for label in ("srbm_lcp", "kinodynamic"):
        check_real_blocks(torch, f"chol_inverse {label}", chol_inverse, chol_inverse_ref,
                          {call: P for (lab, call), P in spd.items() if lab == label})
    # the same entry point in f64 (the kernel's double instance) on the same
    # sub-blocks, against the plain version in f64 on the CPU
    chol_inverse.launches = 0
    err64 = 0.0
    for (label, call), P in sorted(spd.items()):
        Pinv, ok = ops.chol_inverse(P.double())
        ref, ok_ref = chol_inverse_ref(P.double().cpu())
        if not (bool(ok.all()) and bool(ok_ref.all())):
            raise AssertionError(f"chol_inverse f64 rejects an SPD sub-block of {label} call {call}")
        err64 = max(err64, float(((Pinv.cpu() - ref).abs() / ref.abs().amax((1, 2), keepdim=True))
                                 .max()))
    launches["chol_inverse_f64"] = chol_inverse.launches
    log(f"[chol_inverse] entry point in f64 on the same {n_spd} sub-blocks: "
        f"{launches['chol_inverse_f64']} kernel launches, all ok, largest error relative to each "
        f"block's largest entry against the plain version in f64 {err64:.3e} (tolerance 1e-6: real "
        f"KKT sub-blocks reach condition numbers of 1e6 and more)")
    if launches["chol_inverse_f64"] != len(spd) or err64 > 1e-6:
        raise AssertionError("the f64 chol_inverse entry point failed its checks")

    # ---- 9. where one batch-iteration's time goes (B=64; the dense path B=32)
    phase9_srbm = profile_iteration(torch, solver, *bench_sampler(2)(64), "srbm_lcp", card)
    profile_iteration(torch, kino, *sample_drop_scenarios(12, 64), "kinodynamic", card)
    volt = LandingSolver("kinodynamic_voltage", dtype=torch.float32, device="cuda")
    profile_iteration(torch, volt, *sample_drop_scenarios(12, 32), "kinodynamic_voltage (dense)",
                      card)
    log(f"[phases 1-9] {time.time() - t_start:.1f} s")

    # ---- 22. the convergence diagnostics: iter_bench alone on the card (the
    # other four tools go with phases 10-20)
    iter_bench_phase(torch, card, launches, phase9_srbm)
    log(f"[phase 22 iter_bench] {time.time() - t_start:.1f} s")

    # ---- 21. the entry points: the port's bench at its full pool, alone on
    # the card (its two side runs go with phases 10-20)
    bench_phase(card, launches)

    # ---- 10-20. the dense path, EEParamSolver, the backends, cascade and
    # replan, the factory and training, the warm-start comparison, the
    # Monte-Carlo sweep, f64, the dynamics layer, VBL and the deployment
    # surface, phase 7, phase 21's Monte-Carlo record and example, and phase
    # 22's four other tools: fifteen processes side by side on the card.
    # Each path is host-bound (the device idles 75-95% of an iteration,
    # phase 9), so together they take about as long as the longest of them;
    # their wall times include the others' share of the card and the host's
    # cores
    log(f"[phase 21 bench] {time.time() - t_start:.1f} s")
    kino_ref = {"converged": sol.converged.cpu().numpy(), "z": sol.z.cpu().numpy(),
                "cost": sol.cost.cpu().numpy()}
    pool = multiprocessing.get_context("spawn").Pool(len(SIDE_PHASES))
    readings = {}
    try:
        jobs = [pool.apply_async(side_phase, (name, card, qk, qdk, kino_ref, vbl_traj,
                                              stats["converged_mask"]))
                for name in SIDE_PHASES]
        for job in jobs:
            # a worker that dies loses its job: wait no longer than the run allows
            got, read = job.get(timeout=max(1.0, SIDE_DEADLINE_S - (time.time() - t_start)))
            launches.update(got)
            readings.update(read)
    finally:
        pool.terminate()
        pool.join()
    f32_set, f64_set = readings["foot_sweep_f32"], readings["foot_sweep_f64"]
    log(f"[f64] ccc foot sweep converged: f64 {len(f64_set)}/{N_SWEEP} {f64_set}, f32 (phase 16) "
        f"{len(f32_set)}/{N_SWEEP} {f32_set}")
    if len(f64_set) < 5 or len(f64_set) < len(f32_set):
        raise AssertionError("the f64 foot sweep converges fewer than 5 drops or than the f32 one")
    if torch.cuda.device_count() >= 2:
        torch.multiprocessing.start_processes(montecarlo_rank, args=(2, free_port()), nprocs=2,
                                              start_method="spawn")
    else:
        log(f"[montecarlo] two ranks under NCCL: not run, this machine has "
            f"{torch.cuda.device_count()} card (tests/test_torch_parallel.py runs two gloo ranks "
            f"on the CPU)")

    log(f"[done] {time.time() - t_start:.1f} s in all")
    # ---- the kernels line, the card line, the result line
    solver_paths = ("srbm_lcp", "kinodynamic", "sliding", "contact_scheduled", "ccc",
                    "srbm_lcp_cri_backend", "cascade", "replan", "factory", "warmstart",
                    "montecarlo", "foot_sweep", "srbm_lcp_f32", "artifact", "stream_aot", "bench",
                    "montecarlo_100k", "solve_landing", "iter_bench", "conv_battery", "diag_conv",
                    "fail_taxonomy", "tune_sweep")
    f64_paths = ("srbm_lcp_f64", "foot_sweep_f64")
    kernels = [{
        "name": "qd_inverse",
        "route": "cuda",
        "source": "landing_controller_tpu_torch/csrc/qd_inverse.cu",
        "replaces": "landing_controller_tpu/ops/pallas_blocks.py:111",
        "launches": sum(launches[p] for p in solver_paths),
        "launches_by_path": {p: launches[p] for p in solver_paths},
        "shape": "(np, nd) = (36, 24), m = 1280",
        **rec_qd,
        "at_48_36_m5120": rec_qd_kino,
        "generic_at_30_20_m1280": qd_recs[(30, 20, 1280)],
    }, {
        "name": "chol_inverse",
        "route": "cuda",
        "source": "landing_controller_tpu_torch/csrc/chol_inverse.cu",
        "replaces": "landing_controller_tpu/ops/pallas_blocks.py:137",
        "launches": launches["chol_inverse"],
        "shape": "n = 48, m = 5120",
        **rec_chol,
    }, {
        "name": "qd_inverse_f64",
        "route": "cuda",
        "source": "landing_controller_tpu_torch/csrc/qd_inverse.cu",
        "replaces": "landing_controller_tpu/ops/pallas_blocks.py:111",
        "launches": sum(launches[p] for p in f64_paths),
        "launches_by_path": {p: launches[p] for p in f64_paths},
        "shape": "(np, nd) = (36, 24), m = 1280, float64",
        **qd64_recs[(36, 24)],
        "at_48_36_m5120": qd64_recs[(48, 36)],
        "generic_at_30_20_m1280": qd64_recs[(30, 20)],
    }, {
        "name": "chol_inverse_f64",
        "route": "cuda",
        "source": "landing_controller_tpu_torch/csrc/chol_inverse.cu",
        "replaces": "landing_controller_tpu/ops/pallas_blocks.py:137",
        "launches": launches["chol_inverse_f64"],
        "shape": "n = 48, m = 5120, float64",
        **rec_chol64,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
