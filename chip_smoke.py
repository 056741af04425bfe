"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero, before the result line):

1. device: CUDA must be available; prints torch's version, the card's name
   and power limit, and the TF32 flags;
2. build: compiles every CUDA kernel of the port from ``csrc/`` (one nvcc
   process per source, all started together);
3. kernel parity: every kernel against its plain PyTorch version on the
   card, on random inputs at the main path's shapes, with timings;
4. main path: the streaming srbm_lcp solve of the repo's benchmark settings
   (B=64, 25-iteration segments, deadlines (100, 150), ballistic guess with
   an NN retry, production dt schedule) over 128 scenarios, with the kernel
   launch counts of that run;
5. checks of the output: kernel parity on the real KKT blocks captured from
   several block-inverse calls of the main path, feasibility of the harvested solutions, and one gentle
   drop solved on the card and on the CPU (plain versions) with agreeing
   costs;
6. profile: host time, device time and kernel launches per IP iteration at
   B=64 (host clock, then torch.profiler).

The last two lines of standard output are the ``kernels`` JSON line and the
``{"ok": true, "device": ...}`` line.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# the theoretical peak rates of one H100 SXM (NVIDIA data sheet): HBM3 bytes
# per second and f32 operations per second outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12

N_SCENARIOS = 128
# the main path's block-inverse calls come six per IP iteration (one per
# cyclic-reduction level): every 30th is the largest level of every fifth
# iteration
CAPTURE_EVERY = 30


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


def check_real_blocks(torch, qd_inverse, qd_inverse_ref, captured, np_=36, nd=24):
    """The kernel against the plain version on KKT blocks captured from the
    main path, both held to the f64 inverse of the same blocks.

    The blocks are ill-conditioned (condition numbers ~1e6 and above), so no
    f32 inverse is accurate on all of them: the kernel's error is limited by
    the plain version's own error on the same blocks.  Per block the error is
    max|Sinv - inv64| / max|inv64|.  A block on which the plain version keeps
    no correct digit (error > 1, or non-finite) is singular in f32: both
    versions pass their pivot test there and neither gives an inverse, so it
    is counted and left out of the limits.  Checks:
    - the ok flags agree on every block;
    - the kernel is finite on every ok block that is not singular in f32;
    - pooled over all captured calls, the kernel's median and 99th-percentile
      errors are at most 2x the plain version's, and its largest at most 10x.
    """
    errs_k, errs_p = [], []
    n_singular = n_ok = n_blocks = 0
    for call, S in sorted(captured.items()):
        out_k, ok_k = qd_inverse(S, np_, nd)
        out_p, ok_p = qd_inverse_ref(S, np_, nd)
        if not torch.equal(ok_k, ok_p):
            raise AssertionError(f"qd_inverse ok flags disagree on main-path call {call}")
        inv64 = torch.linalg.inv(S[ok_k].double())
        scale = inv64.abs().amax((-1, -2))

        def rel_err(out):
            return (out[ok_k].double() - inv64).abs().amax((-1, -2)) / scale

        ek, ep = rel_err(out_k), rel_err(out_p)
        singular = ~(ep <= 1.0)
        finite_k = torch.isfinite(out_k[ok_k]).flatten(1).all(1)
        if (~finite_k & ~singular).any():
            raise AssertionError(f"qd_inverse kernel is not finite on an ok block of call {call}")
        ek, ep = ek[~singular], ep[~singular]
        if not ek.numel():
            continue
        errs_k.append(ek)
        errs_p.append(ep)
        n_blocks += S.shape[0]
        n_ok += int(ok_k.sum())
        n_singular += int(singular.sum())
        log(f"[check] call {call:4d} m={S.shape[0]:4d}: ok {int(ok_k.sum())}, singular in f32 "
            f"{int(singular.sum())} (kernel non-finite {int((~finite_k).sum())}); rel err "
            f"median/p99/max kernel {float(ek.median()):.2e}/{float(torch.quantile(ek, 0.99)):.2e}/"
            f"{float(ek.max()):.2e}, plain {float(ep.median()):.2e}/"
            f"{float(torch.quantile(ep, 0.99)):.2e}/{float(ep.max()):.2e}")
    ek, ep = torch.cat(errs_k), torch.cat(errs_p)
    stats = [(name, float(fn(ek)), float(fn(ep)), factor) for name, fn, factor in (
        ("median", torch.median, 2.0),
        ("p99", lambda e: torch.quantile(e, 0.99), 2.0),
        ("max", torch.max, 10.0))]
    log(f"[check] real KKT blocks, {len(captured)} main-path calls, {n_blocks} blocks: ok flags "
        f"agree, {n_ok} ok, {n_singular} singular in f32; rel err vs the f64 inverse "
        + ", ".join(f"{name} kernel {k:.3e} plain {p:.3e} (<= {f:g}x)" for name, k, p, f in stats))
    for name, k, p, factor in stats:
        if not k <= factor * p:
            raise AssertionError(f"qd_inverse kernel's {name} error {k:.3e} on the real KKT "
                                 f"blocks exceeds {factor:g}x the plain version's {p:.3e}")


def profile_iteration(torch, solver, card, iters=3):
    """Host time, device time and kernel launches per IP iteration at B=64:
    the host clock around `iters` iterations ending in a synchronize, then
    the same under torch.profiler for the device side."""
    q, qd = bench_sampler(2)(64)
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
    qdi_us = sum(getattr(e, dev_attr) for e in kernels if "qd_inverse_kernel" in e.key)
    dev_ms = device_us / 1e3 / iters
    log(f"[profile] B=64 on {card}: host {host_ms:.1f} ms per iteration, device busy "
        f"{dev_ms:.2f} ms per iteration (idle share {1 - dev_ms / host_ms:.3f}), "
        f"{launches / iters:.0f} cudaLaunchKernel per iteration, qd_inverse "
        f"{qdi_us / 1e3 / iters:.3f} ms per iteration ({qdi_us / max(device_us, 1):.3f} of device time)")
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
    from landing_controller_tpu_torch.ops import _build
    from landing_controller_tpu_torch.ops.pallas_blocks import qd_inverse, qd_inverse_ref
    from landing_controller_tpu_torch.solver import structured
    from landing_controller_tpu_torch.warmstart.reference import DT_PRODUCTION

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")

    # ---- 2. build
    t0 = time.time()
    _build.load_library("qd_inverse")
    log(f"[build] {time.time() - t0:.1f} s")
    for name, out in _build.build_logs.items():
        for line in out.strip().splitlines():
            log(f"[build] {name}: {line}")

    # ---- 3. kernel parity on random blocks, timings at the largest level
    rng = np.random.default_rng(0)
    record = {}
    for np_, nd, m in ((36, 24, 1280), (36, 24, 128), (48, 36, 256), (36, 40, 256)):
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
        if (np_, nd, m) == (36, 24, 1280):
            record["max_abs_err"] = err
            record["ms"] = median_ms(torch, lambda: qd_inverse(S, np_, nd))
            record["plain_ms"] = median_ms(torch, lambda: qd_inverse_ref(S, np_, nd))
            record["library_ms"] = median_ms(torch, lambda: torch.linalg.inv(S))
            record["bound_ms"], record["bound_by"] = qd_inverse_bound_ms(m, np_, nd)
            log(f"[time] qd_inverse (36,24) m=1280 on {card}: kernel {record['ms']:.4f} ms, "
                f"plain {record['plain_ms']:.4f} ms, torch.linalg.inv {record['library_ms']:.4f} ms, "
                f"bound {record['bound_ms']:.4f} ms ({record['bound_by']})")

    # ---- 4. the main path
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
    log(f"[main] tf32 after solver build: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    # warm-up: one segment on a 64-scenario pool (first-call costs)
    t0 = time.time()
    StreamingSolver(solver, batch=64, segment=25, sampler=bench_sampler(1),
                    attempt_iters=(100, 150)).run(64, max_wall_s=0.0)
    torch.cuda.synchronize()
    log(f"[main] warm-up {time.time() - t0:.1f} s")

    ss = StreamingSolver(solver, batch=64, segment=25, sampler=bench_sampler(0),
                         attempt_iters=(100, 150), collect_z=True)
    # record the blocks of some of the main path's block-inverse calls: all
    # six levels of the first factorization, then the largest level of every
    # fifth IP iteration.  The Newton step gets its block-inverse function
    # from make_qd_inverse.
    captured = {}
    n_calls = [0]
    make_original = structured.make_qd_inverse

    def make_capturing(np_, nd):
        fn = make_original(np_, nd)

        def capture(S):
            call = n_calls[0]
            n_calls[0] += 1
            if call < 6 or call % CAPTURE_EVERY == 0:
                captured[call] = S.detach().reshape((-1,) + S.shape[-2:]).clone()
            return fn(S)

        return capture

    structured.make_qd_inverse = make_capturing
    qd_inverse.launches = 0
    try:
        t0 = time.time()
        stats = ss.run(N_SCENARIOS)
        torch.cuda.synchronize()
        t_run = time.time() - t0
    finally:
        structured.make_qd_inverse = make_original
    launches = qd_inverse.launches
    log(f"[main] streaming srbm_lcp B=64 seg=25 on {card}: n_finished {stats['n_finished']}, "
        f"convergence_rate {stats['convergence_rate']:.4f}, iters_p50 {stats['iters_p50']:.0f}, "
        f"iters_p90 {stats['iters_p90']:.0f}, wall_s {stats['wall_s']:.2f} "
        f"(with pool set-up {t_run:.2f}), converged solves/s {stats['converged_per_sec']:.3f}")
    log(f"[main] qd_inverse kernel launches: {launches}")
    if stats["n_finished"] != N_SCENARIOS:
        raise AssertionError(f"only {stats['n_finished']} of {N_SCENARIOS} scenarios finished")
    if not (np.isfinite(stats["z"]).all() and np.isfinite(stats["viol"]).all()):
        raise AssertionError("NaN in the harvested results")
    if launches <= 0:
        raise AssertionError("the main path launched no qd_inverse kernel")
    if stats["convergence_rate"] < 0.6:
        raise AssertionError(f"convergence_rate {stats['convergence_rate']:.3f} < 0.6")

    # ---- 5. checks of the output
    # (a) kernel vs plain on the real KKT blocks of the main path
    check_real_blocks(torch, qd_inverse, qd_inverse_ref, captured)
    # (b) harvested converged solutions are feasible on the unscaled problem
    q_np, qd_np = bench_sampler(0)(N_SCENARIOS)
    conv = stats["converged_mask"]
    zc = torch.as_tensor(stats["z"][conv], device=dev)
    theta = solver.build_params(q_np[conv], qd_np[conv])
    E = solver.problem.eq(zc, theta)
    g = solver.problem.ineq(zc, theta)
    viol = torch.maximum(E.abs().amax(-1), torch.clamp(-g, min=0).amax(-1))
    # the solver's 1e-3 contract is on the scaled rows (row scales <= 1),
    # so the unscaled check allows 1e-2
    scaled = stats["viol"][conv]
    log(f"[check] {int(conv.sum())} converged solutions: max violation scaled "
        f"{float(scaled.max()):.3e} (<= 1e-3), unscaled {float(viol.max()):.3e} (<= 1e-2)")
    if float(scaled.max()) > 1e-3 or float(viol.max()) > 1e-2:
        raise AssertionError("a converged solution violates its constraints")
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

    # ---- 6. where one batch-iteration's time goes (B=64, bench settings)
    profile_iteration(torch, solver, card)

    log(f"[done] {time.time() - t_start:.1f} s in all")
    # ---- the kernels line, the card line, the result line
    kernels = [{
        "name": "qd_inverse",
        "route": "cuda",
        "source": "landing_controller_tpu_torch/csrc/qd_inverse.cu",
        "replaces": "landing_controller_tpu/ops/pallas_blocks.py:111",
        "launches": launches,
        "max_abs_err": record["max_abs_err"],
        "ms": record["ms"],
        "plain_ms": record["plain_ms"],
        "bound_ms": record["bound_ms"],
        "bound_by": record["bound_by"],
        "library_ms": record["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
