"""Primal-dual interior-point NLP solver, batch-first (B independent lanes).

Solves   min f(z)  s.t.  E(z) = 0,  g(z) >= 0   for every lane at once, via
slacks and the log barrier, with fraction-to-boundary, an optional Gondzio
corrector, a filter line search over n_linesearch candidates evaluated
together, the monotone or loqo barrier rules, a slack-reset rescue and a
windowed stall detector with best-iterate restores.

The Newton step is pluggable: the stage-structured step of :mod:`.structured`
(landing problems), or by default the dense inertia-corrected Schur step
(:func:`_solve_kkt`) on dense Jacobians and Hessians taken by ``torch.func``.

Every per-lane decision is branch-free: lanes that converged, failed or hit
their iteration budget freeze (``torch.where`` on per-lane masks) while the
others keep stepping.  There is no host synchronization inside the
iteration loop: a segmented solve (``state0`` / ``segment_iters``) runs
exactly ``segment_iters`` iterations; a full solve checks once every
``_SYNC_EVERY`` iterations whether any lane is still running.

The closures ``cost_fn`` (B*k, n) -> (B*k,), ``eq_fn`` -> (B*k, me) and
``ineq_fn`` -> (B*k, mi) take k >= 1 lane-major rows per lane (see
:class:`.scaling.ScaledNLP`).  Tolerances follow the reference bar
(landing_optimization.m:326-329): ``tol=1e-4`` on the scaled KKT error,
``constr_viol_tol=1e-3``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.func import grad, jvp, vjp

from .._device import constant
from .._tree import tree_map, tree_where
from ..ops.block_tridiag import chol_nan
from ..tracing import count, count_on_device, span

# a full (unsegmented) solve reads "any lane still running?" once per this
# many iterations
_SYNC_EVERY = 10


@dataclasses.dataclass(frozen=True)
class IPConfig:
    """The JAX package's IPConfig: same fields, same defaults (see
    landing_controller_tpu/solver/ip.py for the reasoning behind each)."""

    max_iter: int = 60
    tol: float = 1e-4
    constr_viol_tol: float = 1e-3
    mu_init: float = 1e-1
    mu_min: float = 1e-6
    kappa_mu: float = 0.2
    theta_mu: float = 1.5
    kappa_eps: float = 10.0
    mu_strategy: str = "monotone"  # "monotone" | "loqo"
    tau_min: float = 0.99
    s_init_min: float = 1e-2
    delta_w: float = 1e-6
    delta_w_fail: float = 1e-2
    delta_c: float = 1e-8
    n_linesearch: int = 12
    gamma_theta: float = 1e-5
    gamma_phi: float = 1e-5
    delta_switch: float = 1.0
    s_theta: float = 1.1
    s_phi: float = 2.3
    eta_phi: float = 1e-4
    theta_max_fac: float = 1e4
    filter_size: int = 32
    kappa_sigma: float = 1e10
    hessian_mode: str = "hybrid"  # "gn" | "exact" | "hybrid"
    hybrid_viol_switch: float = 1e-3
    hybrid_kkt_switch: float = 1.0
    hybrid_mu_switch: float = 2e-3
    y_max: float = 1e5
    sigma_max: float = 1e8
    slack_floor: float = 1e-2
    rescue_alpha: float = 1e-7
    stall_window: int = 50
    stall_min_iter: int = 60
    stall_restarts: int = 2
    stall_grace: float = 50.0
    corrector: int = 0
    refine_steps: int = 1
    ladder_scales: tuple = (0.0, 1.0, 10.0, 1000.0)
    # the JAX package's MXU precision knob; the port's counterpart is full
    # f32 matmuls (TF32 off), which the solver API sets
    matmul_precision: str = "highest"
    kkt_backend: str = "scan"  # structured step: "scan", "cr" or "cri"
    relax_scale: float = 0.0
    alpha_for_y: str = "bound-mult"  # "bound-mult" | "primal"
    bound_relax_factor: float = 1e-6


@dataclasses.dataclass(frozen=True)
class IPResult:
    z: torch.Tensor  # (B, n) primal solution
    s: torch.Tensor
    lam: torch.Tensor
    y: torch.Tensor
    converged: torch.Tensor  # (B,) bool
    iterations: torch.Tensor  # (B,) int
    kkt_error: torch.Tensor
    constr_viol: torch.Tensor
    cost: torch.Tensor
    kkt_history: torch.Tensor  # (B, max_iter) ring buffers
    mu_history: torch.Tensor
    alpha_history: torch.Tensor


@dataclasses.dataclass(frozen=True)
class IPState:
    """Full resumable solver state of B lanes (segmented solves carry it)."""

    z: torch.Tensor
    s: torch.Tensor
    lam: torch.Tensor
    y: torch.Tensor
    mu: torch.Tensor
    delta: torch.Tensor  # adaptive inertia-correction regularization
    filt_theta: torch.Tensor  # (B, filter_size) filter corners
    filt_phi: torch.Tensor
    filt_ptr: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor
    best_score: torch.Tensor
    best_z: torch.Tensor
    best_s: torch.Tensor
    best_lam: torch.Tensor
    best_y: torch.Tensor
    snap_score: torch.Tensor
    snap_mu: torch.Tensor
    n_restores: torch.Tensor
    kkt_hist: torch.Tensor
    mu_hist: torch.Tensor
    alpha_hist: torch.Tensor
    # the filter's ceiling, fixed from z0 at init (the JAX solver recomputes
    # it from z0 on every call; the state carries it instead)
    theta_max: torch.Tensor


def _kkt_error_rd(r_d, E, g, s, lam, y, mu):
    """Scaled KKT error per lane from a precomputed dual residual r_d."""
    m = s.shape[-1] + y.shape[-1]
    s_d = torch.clamp((lam.abs().sum(-1) + y.abs().sum(-1)) / m, min=100.0) / 100.0
    s_c = torch.clamp(lam.abs().sum(-1) / s.shape[-1], min=100.0) / 100.0
    mu_b = mu[:, None] if isinstance(mu, torch.Tensor) else mu
    err_d = r_d.abs().amax(-1) / s_d
    err_e = E.abs().amax(-1)
    err_g = (g - s).abs().amax(-1)
    err_c = (s * lam - mu_b).abs().amax(-1) / s_c
    return torch.maximum(torch.maximum(err_d, err_e), torch.maximum(err_g, err_c)), r_d


# dense derivatives take at most this many rows (lanes x tangent columns) per
# forward-mode call; more columns are taken in chunks.  kinodynamic_voltage
# at B=32 (31,104 rows) fits one call in about 7 GB of device memory
_JAC_ROWS = 32768


def _first_ok(oks):
    """Per lane, the index of the first True of oks (B, k), else k - 1."""
    return torch.where(oks.any(1), torch.argmax(oks.to(torch.int32), 1),
                       torch.full_like(oks[:, 0], oks.shape[1] - 1, dtype=torch.int64))


def _chol_solve(L, b):
    """(L L') x = b of lower Cholesky factors L (B, n, n), b (B, n, k): two
    triangular solves, which is LAPACK's potrs (the same bits as
    ``torch.cholesky_solve`` on the CPU); on a card the batched
    ``cholesky_solve`` goes to MAGMA, which cannot be captured in a CUDA
    graph, and the triangular solves to cuBLAS, which can."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _refine_residual(H0, shift, Je, delta_c, dz, dy, rhs_z, rhs_y):
    """The residual of the shifted KKT system [[H0 + diag(shift), Je'],
    [Je, -delta_c]] at (dz, dy): (rhs_z - (H0 + diag(shift)) dz - Je' dy,
    rhs_y - Je dz + delta_c dy).  The shift is added to the product, so the
    shifted copy of H0 (B x n x n) is never formed."""
    r_z = rhs_z - (_mv(H0, dz) + shift * dz + _mv(Je.transpose(1, 2), dy))
    r_y = rhs_y - (_mv(Je, dz) - delta_c[:, None] * dy)
    return r_z, r_y


def _solve_kkt(H0, Je, rhs_z, rhs_y, delta_last, cfg: IPConfig):
    """Inertia-corrected Schur-complement KKT solve of B lanes.

    Solves [[H0 + dI, Je'], [Je, -delta_c I]] [dz; dy] = [rhs_z; rhs_y] per
    lane, where d is the smallest shift of the ladder {delta_w, s delta_last}
    (``cfg.ladder_scales``) whose shifted, Jacobi-equilibrated H0 has a
    Cholesky factor; all candidates are factored in one batched call, and a
    lane where none succeeds takes the emergency shift 1e3 delta_last + 1e3
    (counted on the device as ``dense_kkt.emergency``, beside
    ``dense_kkt.lane_iterations``, the lanes factored).
    H0 (B, n, n), Je (B, me, n), rhs_z (B, n), rhs_y (B, me), delta_last (B,).

    Returns (dz, dy, delta_used, resolve); ``resolve(rhs_z, rhs_y)`` re-solves
    with the same factors (corrector steps)."""
    B, n = rhs_z.shape
    me = rhs_y.shape[-1]
    dtype, dev = H0.dtype, H0.device
    with span("newton.factor"):
        lanes = torch.arange(B, device=dev)
        eye = torch.eye(n, dtype=dtype, device=dev)
        # Jacobi equilibration D = (diag(H) + base)^(-1/2) with an absolute floor
        # base = 1e-2 mean(diag) (zero-curvature variables keep a bounded scale
        # and their share of the shift)
        diag0 = torch.diagonal(H0, dim1=-2, dim2=-1)
        base = 1e-2 * diag0.mean(-1) + 1e-12
        dH = torch.sqrt(diag0 + base[:, None])
        dinv = 1.0 / dH
        Hn = H0 * dinv[:, :, None] * dinv[:, None, :]
        deltas = torch.stack(
            [torch.full_like(delta_last, cfg.delta_w) if sc == 0.0 else sc * delta_last
             for sc in cfg.ladder_scales] + [1e3 * delta_last + 1e3], 1)  # (B, L + 1)
        Ls, oks = chol_nan(Hn[:, None] + deltas[:, :, None, None] * eye)
        nl = len(cfg.ladder_scales)
        # first successful ladder candidate; where none succeeds, the emergency
        # shift (the last slot), chosen per lane
        pick = torch.where(oks[:, :nl].any(1), _first_ok(oks[:, :nl]),
                           torch.full_like(lanes, nl))
        count_on_device("dense_kkt.emergency", pick == nl)
        count("dense_kkt.lane_iterations", B)
        L = Ls[lanes, pick]
        delta_used = deltas[lanes, pick]

        # Schur complement on the equality block (also equilibrated):
        #   S dy = Je H^-1 rhs_z - rhs_y,   dz = H^-1 (rhs_z - Je' dy)
        # Je H^-1 Je' is formed as the Gram matrix F'F, F = L^-1 D Je', which is
        # positive semidefinite by construction: formed as Je (H^-1 Je') in f32
        # its rounding fails the 1e-7 shift below where the exact matrix passes
        # (eeParam: an f32 step 30x less accurate than at the shift f64 takes)
        JeT = Je.transpose(1, 2)
        F = torch.linalg.solve_triangular(L, dinv[:, :, None] * JeT, upper=False)  # (B, n, me)
        delta_c = torch.clamp(1e-6 * delta_used, min=cfg.delta_c)
        eye_s = torch.eye(me, dtype=dtype, device=dev)
        S = F.transpose(1, 2) @ F + delta_c[:, None, None] * eye_s
        dS = torch.sqrt(torch.clamp(torch.diagonal(S, dim1=-2, dim2=-1), min=1e-12))
        dSinv = 1.0 / dS
        Sn = S * dSinv[:, :, None] * dSinv[:, None, :]
        # Schur shift ladder: with redundant equality rows Je H^-1 Je' is only
        # PSD; take the smallest shift whose factor exists
        s_shifts = constant([1e-7, 1e-5, 1e-3, 1e-1], dtype, dev)
        Ls_s, oks_s = chol_nan(Sn[:, None] + s_shifts[:, None, None] * eye_s)
        L_s = Ls_s[lanes, _first_ok(oks_s)]

    def hsolve(b):
        """(H + d diag(H + base))^-1 b through the equilibrated factor; b (B, n)."""
        return _chol_solve(L, (b * dinv)[..., None])[..., 0] * dinv

    def ssolve(b):
        return _chol_solve(L_s, (b * dSinv)[..., None])[..., 0] * dSinv

    # the diagonal of the actual shift, for refinement
    shift = delta_used[:, None] * dH * dH

    def resolve(rhs_z_v, rhs_y_v):
        with span("newton.solve"):
            dy_v = ssolve(_mv(Je, hsolve(rhs_z_v)) - rhs_y_v)
            dz_v = hsolve(rhs_z_v - _mv(JeT, dy_v))
            for _ in range(cfg.refine_steps):
                # one sweep of iterative refinement on the full KKT system
                r_z, r_y = _refine_residual(H0, shift, Je, delta_c, dz_v, dy_v, rhs_z_v, rhs_y_v)
                ddy = ssolve(_mv(Je, hsolve(r_z)) - r_y)
                ddz = hsolve(r_z - _mv(JeT, ddy))
                dz_v = dz_v + ddz
                dy_v = dy_v + ddy
            return dz_v, dy_v

    dz, dy = resolve(rhs_z, rhs_y)
    return dz, dy, delta_used, resolve


def _dense_columns(fn, z, *row_args):
    """Dense derivative matrices of a row function by forward mode.

    ``fn(zr, *args)`` maps lane-major rows (B*k, n) to (B*k, m); ``row_args``
    are per-lane tensors (B, ...) repeated alongside.  Returns (B, n, m): entry
    [b, j] is d fn / d z_j of lane b, i.e. the Jacobian's column j.  One jvp
    over B*c rows with identity tangents takes c columns; columns are taken
    in chunks of at most ``_JAC_ROWS`` rows."""
    B, n = z.shape
    eye = torch.eye(n, dtype=z.dtype, device=z.device)
    chunk = max(1, min(n, _JAC_ROWS // B))
    cols = []
    for c0 in range(0, n, chunk):
        c = min(chunk, n - c0)
        zr = z.repeat_interleave(c, 0)
        tan = eye[c0 : c0 + c].repeat(B, 1)
        args = [a.repeat_interleave(c, 0) for a in row_args]
        out = jvp(lambda zz: fn(zz, *args), (zr,), (tan,))[1]
        cols.append(out.reshape(B, c, -1))
    return torch.cat(cols, 1)


def make_dense_newton_step(cost_fn, eq_fn, ineq_fn, cfg: IPConfig):
    """The default Newton step of :func:`solve`: dense Je, Jg and the
    Hessian of ``cfg.hessian_mode`` ("exact": the Lagrangian's; "gn": the
    cost's; "hybrid": the Lagrangian's with the multipliers scaled by the
    per-lane switch flag, which gives the cost's where it is 0), then
    H = W + Jg' diag(sigma) Jg and :func:`_solve_kkt`, under the spans
    ``newton.derivatives``, ``newton.factor`` and ``newton.solve`` (the
    structured step's names).

    All three come from one forward-mode pass over the gradient of the
    weighted Lagrangian: the rows E and g that the gradient's forward pass
    evaluates are returned beside it, so their tangents are Je and Jg."""

    def grad_and_rows(zr, y_r=None, lam_r=None):
        def lag(zz):
            E, g = eq_fn(zz), ineq_fn(zz)
            total = cost_fn(zz)
            if y_r is not None:
                total = total + (E * y_r).sum(-1) - (g * lam_r).sum(-1)
            # rows are independent: the sum's gradient is per row
            return total.sum(), (E, g)

        gr, (E, g) = grad(lag, has_aux=True)(zr)
        return torch.cat([gr, E, g], -1)

    def newton_step(z, y, lam, sigma, mu, use_exact, r_d, r_g, rhs_z, rhs_y, delta_last):
        n, me = z.shape[1], y.shape[1]
        with span("newton.derivatives"):
            if cfg.hessian_mode == "gn":
                cols = _dense_columns(grad_and_rows, z)
            else:
                if cfg.hessian_mode == "hybrid":
                    uf = use_exact.to(z.dtype)[:, None]
                    y, lam = uf * y, uf * lam
                cols = _dense_columns(grad_and_rows, z, y, lam)
            # column j of each block is d / d z_j: W[b, i, j] as jacfwd(grad)
            W, Je, Jg = cols.transpose(1, 2).split([n, me, cols.shape[2] - n - me], 1)
            H = W + Jg.transpose(1, 2) @ (sigma[:, :, None] * Jg)
        return _solve_kkt(H, Je, rhs_z, rhs_y, delta_last, cfg)

    return newton_step


def _ring_set(hist, it, val, max_iter):
    return hist.scatter(1, (it % max_iter)[:, None], val[:, None])


@dataclasses.dataclass(frozen=True)
class IPProgram:
    """The iteration and the end of a solve over :class:`IPState` (a fresh
    state comes from :func:`init_state`), plain functions of tensors that a
    saved solver traces: ``body(st)`` is one iteration of every lane,
    ``finish(st)`` the final diagnostics as an :class:`IPResult`."""

    body: Callable
    finish: Callable
    config: IPConfig

    def step(self, st: IPState) -> IPState:
        """One iteration of the lanes still running (below ``max_iter`` and
        not done), as a full solve takes it; the others keep their state."""
        return tree_where((st.it < self.config.max_iter) & ~st.done, self.body(st), st)

    def settle(self, st: IPState, result: IPResult) -> IPState:
        """``st`` with the lanes that converged or reached the iteration cap
        marked done: a segmented solve's state between segments."""
        return dataclasses.replace(
            st, done=st.done | result.converged | (st.it >= self.config.max_iter))


def ip_program(cost_fn: Callable, eq_fn: Callable, ineq_fn: Callable, config: IPConfig,
               relax_mask=None, newton_step_fn=None) -> IPProgram:
    """The :class:`IPProgram` of B NLP instances (see :func:`solve`)."""
    cfg = config
    if newton_step_fn is None:
        newton_step_fn = make_dense_newton_step(cost_fn, eq_fn, ineq_fn, cfg)
    br = cfg.bound_relax_factor
    nls = cfg.n_linesearch
    mask = None
    if relax_mask is not None and cfg.relax_scale > 0.0:
        mask = torch.as_tensor(relax_mask)

    def relax(g_true, mu_rows):
        if mask is None:
            return g_true
        off = cfg.relax_scale * torch.clamp(mu_rows - cfg.mu_min, min=0.0)
        return g_true + off[:, None] * mask.to(g_true)

    def jvp_ineq(z, dz):
        return jvp(ineq_fn, (z,), (dz,))[1]

    def body(st: IPState) -> IPState:
        z, s, lam, y, mu = st.z, st.s, st.lam, st.y, st.mu
        with span("solver.residuals"):
            B, dtype, dev = z.shape[0], z.dtype, z.device
            ones_b = torch.ones(B, dtype=dtype, device=dev)
            big = torch.finfo(dtype).max / 4
            mu_c = mu[:, None]
            f, vjp_f = vjp(cost_fn, z)
            E, vjp_e = vjp(eq_fn, z)
            g_raw, vjp_g = vjp(ineq_fn, z)
            g_true = g_raw + br
            g = relax(g_true, mu)
            grad_f = vjp_f(ones_b)[0]
            # matrix-free dual residual: r_d = grad_f + Je'y - Jg'lam
            r_d = grad_f + vjp_e(y)[0] - vjp_g(lam)[0]

            kkt_err, _ = _kkt_error_rd(r_d, E, g, s, lam, y, mu)
            viol = torch.maximum(E.abs().amax(-1), torch.clamp(-g_true, min=0.0).amax(-1))
            kkt_err0, _ = _kkt_error_rd(r_d, E, g_true, s, lam, y, 0.0)
            converged = (kkt_err0 <= cfg.tol) & (viol <= cfg.constr_viol_tol)

            # ---- Newton step on the barrier KKT system (slack elimination)
            sigma = torch.clamp(lam / s, max=cfg.sigma_max)
            use_exact = (
                (viol < cfg.hybrid_viol_switch)
                & (kkt_err0 < cfg.hybrid_kkt_switch)
                & (mu <= cfg.hybrid_mu_switch)
            )
            r_g = g - s
            rhs_z = -r_d + vjp_g(mu_c / s - lam - sigma * r_g)[0]
            rhs_y = -E
        dz, dy, delta_used, resolve = newton_step_fn(
            z, y, lam, sigma, mu, use_exact, r_d, r_g, rhs_z, rhs_y, st.delta
        )
        ds = jvp_ineq(z, dz) + r_g
        dlam = mu_c / s - lam - sigma * ds

        # ---- fraction-to-boundary
        tau = torch.clamp(1.0 - mu, min=cfg.tau_min)

        def max_step(v, dv, pinned=None):
            neg = dv < 0
            ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                                torch.full_like(v, float("inf")))
            if pinned is not None:
                ratio = torch.where(pinned, torch.full_like(v, float("inf")), ratio)
            return torch.clamp(tau * ratio.amin(-1), max=1.0)

        s_pinned = s <= 2.0 * cfg.slack_floor * mu_c
        alpha_s = max_step(s, ds, pinned=s_pinned)
        alpha_lam = max_step(lam, dlam)

        # ---- second-order complementarity corrector (Gondzio acceptance)
        for _ in range(cfg.corrector):
            with span("solver.corrector"):
                corr = -(ds * dlam) / s
                dz_c, dy_c = resolve(rhs_z + vjp_g(corr)[0], rhs_y)
                ds_c = jvp_ineq(z, dz_c) + r_g
                dlam_c = mu_c / s - lam + corr - sigma * ds_c
                alpha_s_c = max_step(s, ds_c, pinned=s_pinned)
                alpha_lam_c = max_step(lam, dlam_c)
                better_c = (
                    (torch.minimum(alpha_s_c, alpha_lam_c) >= torch.minimum(alpha_s, alpha_lam))
                    & torch.isfinite(dz_c).all(-1)
                    & torch.isfinite(dlam_c).all(-1)
                )
                bc = better_c[:, None]
                dz = torch.where(bc, dz_c, dz)
                dy = torch.where(bc, dy_c, dy)
                ds = torch.where(bc, ds_c, ds)
                dlam = torch.where(bc, dlam_c, dlam)
                alpha_s = torch.where(better_c, alpha_s_c, alpha_s)
                alpha_lam = torch.where(better_c, alpha_lam_c, alpha_lam)

        # ---- filter line search (Waechter-Biegler 2006): all candidates of
        # all lanes in one (B*n_linesearch)-row evaluation
        with span("solver.line_search"):
            theta0 = E.abs().sum(-1) + (g - s).abs().sum(-1)
            phi0 = f - mu * torch.log(s).sum(-1)
            grad_phi_dz = (grad_f * dz).sum(-1) - mu * (ds / s).sum(-1)

            alphas = alpha_s[:, None] * (0.5 ** torch.arange(nls, dtype=dtype, device=dev))
            a3 = alphas[..., None]
            z_t = (z[:, None] + a3 * dz[:, None]).reshape(B * nls, -1)
            # same floor clip as the accepted step
            s_t = torch.maximum(s[:, None] + a3 * ds[:, None], cfg.slack_floor * mu[:, None, None])
            mu_rows = mu.repeat_interleave(nls)
            E_t = eq_fn(z_t).reshape(B, nls, -1)
            g_t = relax(ineq_fn(z_t) + br, mu_rows).reshape(B, nls, -1)
            thetas = E_t.abs().sum(-1) + (g_t - s_t).abs().sum(-1)
            phis = cost_fn(z_t).reshape(B, nls) - mu[:, None] * torch.log(s_t).sum(-1)

            f_th = torch.cat([st.filt_theta, theta0[:, None]], 1)
            f_ph = torch.cat([st.filt_phi, phi0[:, None]], 1)
            acc_mat = (thetas[..., None] <= (1.0 - cfg.gamma_theta) * f_th[:, None]) | (
                phis[..., None] <= f_ph[:, None] - cfg.gamma_phi * f_th[:, None]
            )
            acc_filter = acc_mat.all(-1) & (thetas <= st.theta_max[:, None])

            # switching condition: f-type iteration requires Armijo on phi
            descent = grad_phi_dz < 0
            switch = descent[:, None] & (
                alphas * ((-grad_phi_dz) ** cfg.s_phi)[:, None]
                > cfg.delta_switch * (theta0**cfg.s_theta)[:, None]
            )
            armijo_ok = phis <= phi0[:, None] + cfg.eta_phi * alphas * grad_phi_dz[:, None]
            acceptable = acc_filter & torch.where(switch, armijo_ok, torch.ones_like(armijo_ok))

            step_finite = (
                torch.isfinite(dz).all(-1)
                & torch.isfinite(dy).all(-1)
                & torch.isfinite(ds).all(-1)
                & torch.isfinite(dlam).all(-1)
            )
            acceptable = (acceptable & step_finite[:, None] & torch.isfinite(thetas)
                          & torch.isfinite(phis))
            any_ok = acceptable.any(-1)
            idx_ok = torch.argmax(acceptable.to(torch.int32), -1)  # largest acceptable alpha
            # fallback (restoration surrogate): most feasibility-reducing candidate
            idx_fb = torch.argmin(
                torch.where(torch.isfinite(thetas), thetas, torch.full_like(thetas, float("inf"))), -1
            )
            idx = torch.where(any_ok, idx_ok, idx_fb)[:, None]
            alpha = torch.where(step_finite, alphas.gather(1, idx)[:, 0], torch.zeros_like(alpha_s))
            # a theta-type acceptance augments the filter
            theta_type = any_ok & ~(switch.gather(1, idx) & armijo_ok.gather(1, idx))[:, 0]
            slot = (st.filt_ptr % cfg.filter_size)[:, None]
            tt = theta_type[:, None]
            filt_theta_new = torch.where(
                tt, st.filt_theta.scatter(1, slot, ((1.0 - cfg.gamma_theta) * theta0)[:, None]),
                st.filt_theta)
            filt_phi_new = torch.where(
                tt, st.filt_phi.scatter(1, slot, (phi0 - cfg.gamma_phi * theta0)[:, None]),
                st.filt_phi)
            filt_ptr_new = st.filt_ptr + theta_type.to(st.filt_ptr.dtype)

        # carry the inertia-correction shift: decay after a good step, bump
        # after a rejected one
        delta_new = torch.where(
            any_ok,
            torch.clamp(delta_used / 3.0, min=cfg.delta_w_fail * 1e-2),
            torch.clamp(torch.clamp(delta_used, min=cfg.delta_w_fail) * 10.0, max=1e6),
        )

        def safe(d):
            return torch.where(torch.isfinite(d), d, torch.zeros_like(d))

        dz, ds, dlam, dy = safe(dz), safe(ds), safe(dlam), safe(dy)
        z_new = z + alpha[:, None] * dz
        s_new = torch.maximum(s + alpha[:, None] * ds, cfg.slack_floor * mu_c)
        lam_new = torch.clamp(lam + alpha_lam[:, None] * dlam, min=1e-12)
        # IPOPT kappa_Sigma safeguard: lam within a band of mu/s
        lam_new = torch.minimum(
            torch.maximum(lam_new, mu_c / (cfg.kappa_sigma * s_new)),
            cfg.kappa_sigma * mu_c / s_new,
        )
        alpha_y = alpha_lam if cfg.alpha_for_y == "bound-mult" else alpha
        y_new = torch.clamp(y + alpha_y[:, None] * dy, -cfg.y_max, cfg.y_max)

        # ---- stall rescue: fraction-to-boundary collapse -> re-center
        # (s, lam) on the barrier manifold at the unchanged z, clear filter
        collapsed = step_finite & (alpha_s < cfg.rescue_alpha)
        cl = collapsed[:, None]
        s_resc = torch.maximum((g + torch.sqrt(g * g + 4.0 * mu_c)) / 2.0, cfg.slack_floor * mu_c)
        lam_resc = torch.clamp(mu_c / s_resc, 1e-8, 1e3)
        z_new = torch.where(cl, z, z_new)
        s_new = torch.where(cl, s_resc, s_new)
        lam_new = torch.where(cl, lam_resc, lam_new)
        y_new = torch.where(cl, y, y_new)
        theta_max_f = st.theta_max[:, None].expand_as(filt_theta_new)
        filt_theta_new = torch.where(cl, theta_max_f, filt_theta_new)
        filt_phi_new = torch.where(cl, torch.full_like(filt_phi_new, -big), filt_phi_new)
        filt_ptr_new = torch.where(collapsed, torch.zeros_like(filt_ptr_new), filt_ptr_new)

        # ---- best-iterate snapshot (score at the CURRENT iterate)
        score = viol + kkt_err0
        is_best = (score < st.best_score)[:, None]
        best_z_new = torch.where(is_best, z, st.best_z)
        best_s_new = torch.where(is_best, s, st.best_s)
        best_lam_new = torch.where(is_best, lam, st.best_lam)
        best_y_new = torch.where(is_best, y, st.best_y)

        # ---- barrier update
        if cfg.mu_strategy == "loqo":
            comp = s_new * lam_new
            avg = torch.clamp(comp.mean(-1), min=1e-30)
            xi = comp.amin(-1) / avg
            sig_c = 0.1 * torch.clamp(0.05 * (1.0 - xi) / torch.clamp(xi, min=1e-12), max=2.0) ** 3
            mu_new = torch.clamp(sig_c * avg, cfg.mu_min, cfg.mu_init)
            mu_new = torch.maximum(mu_new, cfg.kappa_mu * mu)
        else:
            barrier_err, _ = _kkt_error_rd(r_d, E, g, s, lam, y, mu)
            shrink = barrier_err <= cfg.kappa_eps * mu
            mu_new = torch.where(
                shrink,
                torch.clamp(torch.minimum(cfg.kappa_mu * mu, mu**cfg.theta_mu), min=cfg.tol / 10.0),
                mu,
            )
            mu_new = torch.clamp(mu_new, min=cfg.mu_min)
            mc = (mu_new != mu)[:, None]
            filt_theta_new = torch.where(mc, theta_max_f, filt_theta_new)
            filt_phi_new = torch.where(mc, torch.full_like(filt_phi_new, -big), filt_phi_new)
            filt_ptr_new = torch.where(mc[:, 0], torch.zeros_like(filt_ptr_new), filt_ptr_new)

        # ---- windowed stall detector with best-iterate restores
        best_new = torch.minimum(st.best_score, score)
        if cfg.stall_window > 0:
            at_boundary = (st.it + 1) % cfg.stall_window == 0
            if cfg.mu_strategy == "loqo":
                mu_same_stage = mu_new > 0.5 * st.snap_mu
            else:
                mu_same_stage = mu_new == st.snap_mu
            stalled_raw = (
                at_boundary
                & (best_new > 0.9 * st.snap_score)
                & (best_new > cfg.stall_grace * cfg.tol)
                & mu_same_stage
                & (st.it >= cfg.stall_min_iter)
            )
            do_restore = stalled_raw & (st.n_restores < cfg.stall_restarts)
            stalled = stalled_raw & ~do_restore
            dr = do_restore[:, None]
            z_new = torch.where(dr, best_z_new, z_new)
            s_new = torch.where(dr, best_s_new, s_new)
            lam_new = torch.where(dr, best_lam_new, lam_new)
            y_new = torch.where(dr, best_y_new, y_new)
            delta_new = torch.where(
                do_restore,
                torch.clamp(torch.clamp(delta_used, min=cfg.delta_w_fail) * 30.0, max=1e6),
                delta_new,
            )
            filt_theta_new = torch.where(dr, theta_max_f, filt_theta_new)
            filt_phi_new = torch.where(dr, torch.full_like(filt_phi_new, -big), filt_phi_new)
            filt_ptr_new = torch.where(do_restore, torch.zeros_like(filt_ptr_new), filt_ptr_new)
            n_restores_new = st.n_restores + do_restore.to(st.n_restores.dtype)
            snap_score_new = torch.where(at_boundary, best_new, st.snap_score)
            snap_mu_new = torch.where(at_boundary, mu_new, st.snap_mu)
        else:
            stalled = torch.zeros_like(converged)
            snap_score_new = st.snap_score
            snap_mu_new = st.snap_mu
            n_restores_new = st.n_restores

        # freeze once converged (or hopeless)
        keep = st.done | converged | stalled

        def upd(new, old):
            return torch.where(keep.reshape((B,) + (1,) * (new.dim() - 1)), old, new)

        return IPState(
            z=upd(z_new, z),
            s=upd(s_new, s),
            lam=upd(lam_new, lam),
            y=upd(y_new, y),
            mu=upd(mu_new, mu),
            delta=upd(delta_new, st.delta),
            filt_theta=upd(filt_theta_new, st.filt_theta),
            filt_phi=upd(filt_phi_new, st.filt_phi),
            filt_ptr=upd(filt_ptr_new, st.filt_ptr),
            it=st.it + 1,
            done=keep,
            best_score=best_new,
            best_z=upd(best_z_new, st.best_z),
            best_s=upd(best_s_new, st.best_s),
            best_lam=upd(best_lam_new, st.best_lam),
            best_y=upd(best_y_new, st.best_y),
            snap_score=upd(snap_score_new, st.snap_score),
            snap_mu=upd(snap_mu_new, st.snap_mu),
            n_restores=upd(n_restores_new, st.n_restores),
            kkt_hist=_ring_set(st.kkt_hist, st.it, kkt_err0, cfg.max_iter),
            mu_hist=_ring_set(st.mu_hist, st.it, mu, cfg.max_iter),
            alpha_hist=_ring_set(
                st.alpha_hist, st.it, torch.where(keep, torch.zeros_like(alpha), alpha), cfg.max_iter
            ),
            theta_max=st.theta_max,
        )

    def finish(st: IPState) -> IPResult:
        """Final diagnostics on the true constraints."""
        z, s, lam, y = st.z, st.s, st.lam, st.y
        f, vjp_f = vjp(cost_fn, z)
        E, vjp_e = vjp(eq_fn, z)
        g_raw, vjp_g = vjp(ineq_fn, z)
        g = g_raw + br
        r_d = vjp_f(torch.ones_like(f))[0] + vjp_e(y)[0] - vjp_g(lam)[0]
        kkt_err0, _ = _kkt_error_rd(r_d, E, g, s, lam, y, 0.0)
        viol = torch.maximum(E.abs().amax(-1), torch.clamp(-g, min=0.0).amax(-1))
        converged = (kkt_err0 <= cfg.tol) & (viol <= cfg.constr_viol_tol)
        return IPResult(
            z=z, s=s, lam=lam, y=y, converged=converged, iterations=st.it,
            kkt_error=kkt_err0, constr_viol=viol, cost=f,
            kkt_history=st.kkt_hist, mu_history=st.mu_hist, alpha_history=st.alpha_hist,
        )

    return IPProgram(body=body, finish=finish, config=cfg)


def solve(
    cost_fn: Callable,
    eq_fn: Callable,
    ineq_fn: Callable,
    z0: torch.Tensor,
    config: IPConfig = IPConfig(),
    y0=None,
    lam0=None,
    s0=None,
    relax_mask=None,
    newton_step_fn=None,
    state0: "IPState | None" = None,
    segment_iters: int | None = None,
    return_state: bool = False,
):
    """Solve B NLP instances (z0: (B, n)); see the module docstring.

    Segmented mode: pass ``state0`` (from a previous call with
    ``return_state=True``) to resume, and ``segment_iters=K`` to run at most
    K further iterations per lane (``segment_iters=0`` with
    ``return_state`` just initializes)."""
    cfg = config
    prog = ip_program(cost_fn, eq_fn, ineq_fn, cfg, relax_mask, newton_step_fn)
    st = state0
    if st is None:
        st = init_state(cost_fn, eq_fn, ineq_fn, z0, cfg, y0, lam0, s0)
    if segment_iters is None:
        it_stop = torch.full_like(st.it, cfg.max_iter)
    else:
        it_stop = torch.clamp(st.it + segment_iters, max=cfg.max_iter)

    def running(st):
        return (st.it < it_stop) & ~st.done

    # lanes whose loop condition is false keep their state exactly (the
    # semantics of a vmapped while_loop)
    n_steps = cfg.max_iter if segment_iters is None else segment_iters
    chunk = n_steps if segment_iters is not None else _SYNC_EVERY
    taken = 0
    while taken < n_steps:
        n = min(chunk, n_steps - taken)
        for _ in range(n):
            st = tree_where(running(st), prog.body(st), st)
        count("ip.iterations", n)
        taken += chunk
        if segment_iters is None and not bool(running(st).any()):
            break

    result = prog.finish(st)
    if return_state:
        # a converged/stalled lane stays frozen across later segments; a
        # lane at the iteration cap can never progress again: mark it done
        return result, prog.settle(st, result)
    return result


def init_state(cost_fn, eq_fn, ineq_fn, z0, cfg: IPConfig, y0=None, lam0=None, s0=None) -> IPState:
    """Fresh IPState of B lanes at z0 (barrier-consistent slacks, CG
    least-squares equality duals)."""
    dtype, dev = z0.dtype, z0.device
    B = z0.shape[0]
    g0, vjp_g = vjp(ineq_fn, z0)
    E0, vjp_e = vjp(eq_fn, z0)
    s_floor = min(cfg.s_init_min, cfg.slack_floor * cfg.mu_init)
    if s0 is None:
        s_init = torch.clamp((g0 + torch.sqrt(g0 * g0 + 4.0 * cfg.mu_init)) / 2.0, min=s_floor)
    else:
        s_init = s0
    lam_init = torch.clamp(cfg.mu_init / s_init, 1e-8, 1e3) if lam0 is None else lam0
    if y0 is None:
        # least-squares equality-dual init, matrix-free CG on the normal
        # equations (Je Je' y = -Je r) with jvp/vjp matvecs, 25 iterations
        _, vjp_f = vjp(cost_fn, z0)
        r = vjp_f(torch.ones(B, dtype=dtype, device=dev))[0] - vjp_g(lam_init)[0]

        def G_mv(v):
            return jvp(eq_fn, (z0,), (vjp_e(v)[0],))[1] + 1e-8 * v

        b = -jvp(eq_fn, (z0,), (r,))[1]
        yk, rk, pk = torch.zeros_like(b), b, b
        rs = (b * b).sum(-1)
        for _ in range(25):
            Ap = G_mv(pk)
            alpha_cg = rs / torch.clamp((pk * Ap).sum(-1), min=1e-30)
            yk = yk + alpha_cg[:, None] * pk
            rk = rk - alpha_cg[:, None] * Ap
            rs_new = (rk * rk).sum(-1)
            pk = rk + (rs_new / torch.clamp(rs, min=1e-30))[:, None] * pk
            rs = rs_new
        y_init = torch.clamp(yk, -cfg.y_max, cfg.y_max)
        y_init = torch.where(torch.isfinite(y_init), y_init, torch.zeros_like(y_init))
    else:
        y_init = y0

    theta_0 = E0.abs().sum(-1) + (g0 - s_init).abs().sum(-1)
    theta_max = cfg.theta_max_fac * torch.clamp(theta_0, min=1.0)
    big = torch.finfo(dtype).max / 4

    def full(shape, v, dt=dtype):
        return torch.full(shape, v, dtype=dt, device=dev)

    zeros_i = torch.zeros(B, dtype=torch.int64, device=dev)
    return IPState(
        z=z0,
        s=s_init,
        lam=lam_init,
        y=y_init,
        mu=full((B,), cfg.mu_init),
        delta=full((B,), cfg.delta_w_fail),
        filt_theta=theta_max[:, None].expand(B, cfg.filter_size).clone(),
        filt_phi=full((B, cfg.filter_size), -big),
        filt_ptr=zeros_i,
        it=zeros_i,
        done=torch.zeros(B, dtype=torch.bool, device=dev),
        best_score=full((B,), big),
        best_z=z0,
        best_s=s_init,
        best_lam=lam_init,
        best_y=y_init,
        snap_score=full((B,), big),
        snap_mu=full((B,), cfg.mu_init),
        n_restores=zeros_i,
        kkt_hist=full((B, cfg.max_iter), 0.0),
        mu_hist=full((B, cfg.max_iter), 0.0),
        alpha_hist=full((B, cfg.max_iter), 0.0),
        theta_max=theta_max,
    )


def solve_batch(cost_fn, eq_fn, ineq_fn, z0_batch, config: IPConfig = IPConfig(), theta=None,
                theta_axes=None, **solve_kw):
    """Solve B instances of a problem written over (z, theta).

    ``cost_fn(z, theta)`` and friends take lane-major rows z (B*k, n) and a
    parameter ``theta`` (a tensor, a dataclass of tensors, or None):
    ``theta_axes=None`` shares one theta among the lanes, ``theta_axes=0``
    gives each lane its own (leading axis B), repeated here for the k rows
    of each lane.  The rest is :func:`solve`."""
    B = z0_batch.shape[0]
    if theta_axes not in (None, 0):
        raise ValueError(f"theta_axes must be None or 0, got {theta_axes!r}")

    def rows(k):
        if theta_axes is None or k == 1:
            return theta
        if isinstance(theta, torch.Tensor):
            return theta.repeat_interleave(k, 0)
        return tree_map(lambda t: t.repeat_interleave(k, 0), theta)

    def bind(fn):
        return lambda z: fn(z, rows(z.shape[0] // B))

    return solve(bind(cost_fn), bind(eq_fn), bind(ineq_fn), z0_batch, config, **solve_kw)


__all__ = ["IPConfig", "IPProgram", "IPResult", "IPState", "init_state", "ip_program",
           "make_dense_newton_step", "solve", "solve_batch"]
