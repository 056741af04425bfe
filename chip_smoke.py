"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero, before the result line):

1. device: CUDA must be available; prints torch's version, the card's name
   and power limit, and the TF32 flags;
2. build: compiles every CUDA kernel of the port from ``csrc/`` (one nvcc
   process per source, all started together);
3. kernel parity: every kernel against its plain PyTorch version on the
   card, on random inputs at the paths' shapes, with timings;
4. the srbm_lcp path: the streaming solve of the repo's benchmark settings
   (B=64, 25-iteration segments, deadlines (100, 150), ballistic guess with
   an NN retry, production dt schedule) over one pool of 64 scenarios, with
   the kernel launch counts of that run;
5. checks of its output: kernel parity on the real KKT blocks captured from
   several block-inverse calls of the run, feasibility of the harvested
   solutions, and one gentle drop solved on the card and on the CPU (plain
   versions) with agreeing costs;
6. the kinodynamic path: ``LandingSolver("kinodynamic")`` at N=21 with the
   family's settings (monotone barrier rule, hybrid Hessian, refine 3,
   reference guess), ``solve_batch`` on 128 drop scenarios, with launch
   counts, launch sizes, peak memory, feasibility of the converged
   solutions and kernel parity on its captured 84-wide KKT blocks;
7. the srbm variants, one scenario each: sliding, contact_scheduled (with
   kernel parity on its 76-wide blocks) and ccc (41 blocks);
8. the ``ops.chol_inverse`` entry point on the SPD sub-blocks of the
   captured KKT blocks of both families: its launch count, then the kernel
   against its plain version and an f64 inverse;
9. profile: host time, device time and kernel launches per IP iteration at
   B=64 for the srbm_lcp and the kinodynamic solver (host clock, then
   torch.profiler).

The last three lines of standard output are the ``kernels`` JSON line, the
card's name and power limit, and the ``{"ok": true, "device": ...}`` line.
Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

# the theoretical peak rates of one H100 SXM (NVIDIA data sheet): HBM3 bytes
# per second and f32 operations per second outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12

N_SCENARIOS = 64  # the srbm_lcp path: one pool
N_KINO = 128  # the kinodynamic path's batch
# a path's block-inverse calls come six per IP iteration (one per
# cyclic-reduction level of a 21-block horizon): every 30th is the largest
# level of every fifth iteration, every 60th of every tenth
CAPTURE_EVERY = 30
CAPTURE_EVERY_KINO = 60


def log(*args):
    print(*args, flush=True)


def bench_sampler(seed: int = 0):
    """The benchmark's drop-condition sampler (numpy, seed 0): roll/yaw
    U(+-0.25), pitch U(+-pi/3), omega U(+-0.5), v_xy U(+-1), v_z -U(0.5, 5),
    z0 = 0.6."""
    rng = np.random.default_rng(seed)

    def sample(n):
        q0s = np.zeros((n, 6), np.float32)
        q0s[:, 2] = 0.6
        q0s[:, 3] = rng.uniform(-0.25, 0.25, n)
        q0s[:, 4] = rng.uniform(-np.pi / 3, np.pi / 3, n)
        q0s[:, 5] = rng.uniform(-0.25, 0.25, n)
        qd0s = np.zeros((n, 6), np.float32)
        qd0s[:, :3] = rng.uniform(-0.5, 0.5, (n, 3))
        qd0s[:, 3:5] = rng.uniform(-1, 1, (n, 2))
        qd0s[:, 5] = -rng.uniform(0.5, 5.0, n)
        return q0s, qd0s

    return sample


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


def median_ms(torch, fn, reps=25):
    """Median over reps of one call's device time (CUDA events), after a
    warm-up call and a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def qd_inverse_bound_ms(m, np_, nd):
    """Least time for m block inverses on an H100: each input read once and
    each output written once over the memory rate, against the
    factorization's f32 operations over the f32 peak."""
    bs = np_ + nd
    nbytes = m * (2 * bs * bs * 4 + 1)
    flops_one = (np_**3 / 3 + 2 * np_**3 / 3  # chol(P), P^-1
                 + 2 * np_ * np_ * nd + 2 * nd * nd * np_  # E, D + B E
                 + nd**3 / 3 + 2 * nd**3 / 3  # chol(Dt), W
                 + 2 * np_ * nd * nd + 2 * np_ * np_ * nd)  # E W, TL
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = m * flops_one / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def chol_inverse_bound_ms(m, n):
    """Least time for m SPD inverses on an H100: 2 m n^2 f32 values moved
    against m n^3 f32 operations (factor n^3/3, inverse 2 n^3/3)."""
    t_bytes = m * (2 * n * n * 4 + 1) / H100_BYTES_PER_S
    t_ops = m * float(n) ** 3 / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cr_launches_per_factor(nb: int) -> int:
    """Block-inverse calls of one cyclic-reduction factorization of nb
    blocks: one per level (the odd blocks) and one for the root."""
    levels = 0
    while nb > 1:
        nb = (nb + 1) // 2
        levels += 1
    return levels + 1


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
      in f32;
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
    lanes (q, qd): the host clock around `iters` iterations ending in a
    synchronize, then the same under torch.profiler for the device side,
    with the device time of each hand-written kernel by its name."""
    snlp, st = solver.init_lanes(q, qd, 0)
    _, st = solver._segment_impl(None, None, st, 1, snlp=snlp)  # first-call costs
    torch.cuda.synchronize()
    t0 = time.time()
    solver._segment_impl(None, None, st, iters, snlp=snlp)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.time() - t0) / iters
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        solver._segment_impl(None, None, st, iters, snlp=snlp)
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
    log(f"[profile] {label} B={len(q)} on {card}: host {host_ms:.1f} ms per iteration, device busy "
        f"{dev_ms:.2f} ms per iteration (idle share {1 - dev_ms / host_ms:.3f}), "
        f"{launches / iters:.0f} cudaLaunchKernel per iteration; " + "; ".join(ours))
    top = sorted(kernels, key=lambda e: -getattr(e, dev_attr))[:8]
    for e in top:
        log(f"[profile]   {getattr(e, dev_attr) / 1e3 / iters:8.3f} ms/iter  {e.count // iters:5d}x  "
            f"{e.key[:80]}")


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

    from landing_controller_tpu_torch import IPConfig, LandingSolver, StreamingSolver
    from landing_controller_tpu_torch import ops
    from landing_controller_tpu_torch.ops import _build
    from landing_controller_tpu_torch.ops.pallas_blocks import (chol_inverse, chol_inverse_ref,
                                                               qd_inverse, qd_inverse_ref)
    from landing_controller_tpu_torch.solver import structured
    from landing_controller_tpu_torch.warmstart.reference import DT_PRODUCTION

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")

    def qd_pair(np_, nd):
        """kernel, plain version and f64 pivot measure at one block split."""
        return ((lambda S: qd_inverse(S, np_, nd)), (lambda S: qd_inverse_ref(S, np_, nd)),
                (lambda S64: qd_rel_least_pivot(torch, S64, np_, nd)))

    # ---- 2. build
    t0 = time.time()
    _build.load_libraries(_build.KERNELS)
    log(f"[build] {', '.join(_build.KERNELS)}: {time.time() - t0:.1f} s")
    for name, out in _build.build_logs.items():
        for line in out.strip().splitlines():
            log(f"[build] {name}: {line}")

    # ---- 3. kernel parity on random blocks, timings at the largest levels
    rng = np.random.default_rng(0)
    rec_qd, rec_qd_kino, rec_chol = {}, {}, {}
    for np_, nd, m in ((36, 24, 1280), (36, 24, 128), (48, 36, 5120), (36, 40, 256)):
        S_np = random_qd_blocks(rng, m, np_, nd)
        S_np[3, 0, 0] = -5.0  # one indefinite block
        S = torch.as_tensor(S_np, device=dev)
        out_k, ok_k = qd_inverse(S, np_, nd)
        out_p, ok_p = qd_inverse_ref(S, np_, nd)
        torch.cuda.synchronize()
        if not torch.equal(ok_k, ok_p) or bool(ok_k[3]) or int(ok_k.sum()) != m - 1:
            raise AssertionError(f"qd_inverse ok flags disagree at ({np_}, {nd}), m={m}")
        if not torch.isfinite(out_k[ok_k]).all():
            raise AssertionError("qd_inverse kernel output is not finite on ok blocks")
        a, b = out_k[ok_k], out_p[ok_k]
        err = float((a - b).abs().max())
        if not bool(((a - b).abs() <= 2e-4 + 2e-4 * b.abs()).all()):
            raise AssertionError(f"qd_inverse kernel disagrees at ({np_}, {nd}), m={m}: {err}")
        log(f"[parity] qd_inverse ({np_},{nd}) m={m}: max_abs_err {err:.3e} (rtol=atol=2e-4), "
            f"ok flags agree ({m - 1}/{m} ok)")
        # timed at the largest level of the srbm_lcp path (64 lanes x 2 ladder
        # candidates x 10 blocks) and of the kinodynamic path (128 x 4 x 10)
        record = {(36, 24, 1280): rec_qd, (48, 36, 5120): rec_qd_kino}.get((np_, nd, m))
        if record is not None:
            record["max_abs_err"] = err
            record["ms"] = median_ms(torch, lambda: qd_inverse(S, np_, nd))
            record["plain_ms"] = median_ms(torch, lambda: qd_inverse_ref(S, np_, nd))
            record["library_ms"] = median_ms(torch, lambda: torch.linalg.inv(S))
            record["bound_ms"], record["bound_by"] = qd_inverse_bound_ms(m, np_, nd)
            log(f"[time] qd_inverse ({np_},{nd}) m={m} on {card}: kernel {record['ms']:.4f} ms, "
                f"plain {record['plain_ms']:.4f} ms, torch.linalg.inv {record['library_ms']:.4f} ms, "
                f"bound {record['bound_ms']:.4f} ms ({record['bound_by']})")
    for n, m in ((24, 1280), (36, 1280), (48, 5120), (84, 256)):
        A_np = random_spd_blocks(rng, m, n)
        A_np[3, 0, 0] = -5.0  # one indefinite block
        A = torch.as_tensor(A_np, device=dev)
        out_k, ok_k = chol_inverse(A)
        out_p, ok_p = chol_inverse_ref(A)
        torch.cuda.synchronize()
        if not torch.equal(ok_k, ok_p) or bool(ok_k[3]) or int(ok_k.sum()) != m - 1:
            raise AssertionError(f"chol_inverse ok flags disagree at n={n}, m={m}")
        if not torch.isfinite(out_k[ok_k]).all():
            raise AssertionError("chol_inverse kernel output is not finite on ok blocks")
        a, b = out_k[ok_k], out_p[ok_k]
        err = float((a - b).abs().max())
        if not bool(((a - b).abs() <= 2e-4 + 2e-4 * b.abs()).all()):
            raise AssertionError(f"chol_inverse kernel disagrees at n={n}, m={m}: {err}")
        log(f"[parity] chol_inverse n={n} m={m}: max_abs_err {err:.3e} (rtol=atol=2e-4), "
            f"ok flags agree ({m - 1}/{m} ok)")
        if (n, m) == (48, 5120):
            A_ok = A[ok_k].contiguous()  # the library calls raise on an indefinite block
            lib_inv = median_ms(torch, lambda: torch.linalg.inv(A_ok))
            lib_chol = median_ms(
                torch, lambda: torch.cholesky_inverse(torch.linalg.cholesky(A_ok)))
            rec_chol.update(
                max_abs_err=err,
                ms=median_ms(torch, lambda: chol_inverse(A)),
                plain_ms=median_ms(torch, lambda: chol_inverse_ref(A)),
                library_ms=min(lib_inv, lib_chol),
            )
            rec_chol["bound_ms"], rec_chol["bound_by"] = chol_inverse_bound_ms(m, n)
            log(f"[time] chol_inverse n={n} m={m} on {card}: kernel {rec_chol['ms']:.4f} ms, "
                f"plain {rec_chol['plain_ms']:.4f} ms, torch.linalg.inv {lib_inv:.4f} ms, "
                f"cholesky + cholesky_inverse {lib_chol:.4f} ms (m={m - 1}), "
                f"bound {rec_chol['bound_ms']:.4f} ms ({rec_chol['bound_by']})")

    # ---- 4. the srbm_lcp path
    cfg = IPConfig(
        max_iter=200, hessian_mode="hybrid", mu_init=0.3, kappa_mu=0.5, mu_min=1e-5, tol=1e-4,
        sigma_max=1e5, refine_steps=1, relax_scale=1.0, delta_c=1e-6, kkt_backend="cri",
        ladder_scales=(0.0, 1.0), n_linesearch=4, mu_strategy="loqo", stall_window=40,
        stall_min_iter=40, corrector=1,
    )
    solver = LandingSolver(
        "srbm_lcp", dtype=torch.float32, config=cfg, guess="ballistic",
        theta_overrides={"dt": DT_PRODUCTION.astype(np.float32)}, retry_guess="nn",
        device="cuda",
    )
    log(f"[srbm_lcp] tf32 after solver build: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    # warm-up: one segment on a 64-scenario pool (first-call costs)
    t0 = time.time()
    StreamingSolver(solver, batch=64, segment=25, sampler=bench_sampler(1),
                    attempt_iters=(100, 150)).run(64, max_wall_s=0.0)
    torch.cuda.synchronize()
    log(f"[srbm_lcp] warm-up {time.time() - t0:.1f} s")

    ss = StreamingSolver(solver, batch=64, segment=25, sampler=bench_sampler(0),
                         attempt_iters=(100, 150), collect_z=True)
    cap_srbm = {}
    restore, _ = capture_block_inverse_calls(structured, cap_srbm, CAPTURE_EVERY)
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
    if stats["convergence_rate"] < 0.6:
        raise AssertionError(f"convergence_rate {stats['convergence_rate']:.3f} < 0.6")

    # ---- 5. checks of the srbm_lcp output
    # (a) kernel vs plain on the real KKT blocks of the path
    k36, p36, piv36 = qd_pair(36, 24)
    check_real_blocks(torch, "qd_inverse (36,24) srbm_lcp", k36, p36, cap_srbm, piv36)
    # (b) harvested converged solutions are feasible on the unscaled problem
    q_np, qd_np = bench_sampler(0)(N_SCENARIOS)
    conv = stats["converged_mask"]
    check_feasible(torch, solver, torch.as_tensor(stats["z"][conv], device=dev), q_np[conv],
                   qd_np[conv], stats["viol"][conv], "srbm_lcp")
    # (c) one gentle drop on the card (kernel) and on the CPU (plain versions)
    small = dict(kind="srbm_lcp", n_knots=21, dtype=torch.float32, guess="ballistic",
                 config=IPConfig(max_iter=150, hessian_mode="hybrid", mu_min=1e-5, tol=2e-4,
                                 sigma_max=1e5, refine_steps=2, relax_scale=1.0, delta_c=1e-6,
                                 kkt_backend="cri"))
    q0, qd0 = [0.0, 0.0, 0.45, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, -0.5]
    s_gpu = LandingSolver(**small, device="cuda").solve(q0, qd0)
    s_cpu = LandingSolver(**small, device="cpu").solve(q0, qd0)
    c_gpu, c_cpu = float(s_gpu.cost), float(s_cpu.cost)
    log(f"[check] gentle drop: card converged {bool(s_gpu.converged)} in {int(s_gpu.iterations)} "
        f"iterations, cost {c_gpu:.6e}; CPU converged {bool(s_cpu.converged)} in "
        f"{int(s_cpu.iterations)}, cost {c_cpu:.6e}")
    if not (bool(s_gpu.converged) and bool(s_cpu.converged)
            and abs(c_gpu - c_cpu) <= 1e-2 * abs(c_cpu) + 1e-12):
        raise AssertionError("the card's solve disagrees with the CPU's")

    # ---- 6. the kinodynamic path at full width: N=21, 84-wide blocks
    kino = LandingSolver(
        "kinodynamic", dtype=torch.float32, guess="reference", device="cuda",
        config=IPConfig(max_iter=200, hessian_mode="hybrid", mu_min=1e-5, tol=2e-4,
                        sigma_max=1e5, refine_steps=3, relax_scale=1.0, delta_c=1e-6,
                        kkt_backend="cri"))
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
    if sizes[:6] != [N_KINO * 4 * k for k in (10, 5, 3, 1, 1, 1)]:
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

    # ---- 7. the srbm variants on the card, one scenario each
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
        "sliding", n_knots=15, dtype=torch.float32, guess="ballistic", device="cuda",
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
    sched = LandingSolver("contact_scheduled", n_knots=16, dtype=torch.float32, device="cuda")
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
    ccc_cfg = LandingSolver("ccc", n_knots=41, dtype=torch.float32, device="cuda").config
    ccc = LandingSolver("ccc", n_knots=41, dtype=torch.float32, device="cuda",
                        config=dataclasses.replace(ccc_cfg, max_iter=150))
    run_variant("ccc", ccc, q0, qd0)

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

    # ---- 9. where one batch-iteration's time goes (B=64)
    profile_iteration(torch, solver, *bench_sampler(2)(64), "srbm_lcp", card)
    profile_iteration(torch, kino, *sample_drop_scenarios(12, 64), "kinodynamic", card)

    log(f"[done] {time.time() - t_start:.1f} s in all")
    # ---- the kernels line, the card line, the result line
    solver_paths = ("srbm_lcp", "kinodynamic", "sliding", "contact_scheduled", "ccc")
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
    }, {
        "name": "chol_inverse",
        "route": "cuda",
        "source": "landing_controller_tpu_torch/csrc/chol_inverse.cu",
        "replaces": "landing_controller_tpu/ops/pallas_blocks.py:137",
        "launches": launches["chol_inverse"],
        "shape": "n = 48, m = 5120",
        **rec_chol,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
