"""Stage-structured Newton step for the landing NLPs (batch-first).

Replaces a dense KKT factorization with per-knot blocks and a
block-tridiagonal factorization chosen by ``kkt_backend``: "cri" (the
default of the port's solvers), the inverse-based block cyclic reduction of
:mod:`..ops.cr_inverse` whose block inverses are the hand-written kernel;
"cr", the Cholesky-based cyclic reduction of :mod:`..ops.cyclic_reduction`;
any other name, the sequential sweep of :mod:`..ops.block_tridiag`
("scan", the JAX package's IPConfig default).  The structure used:

- inequality rows of knot k touch only v_k = [x_k, u_k, jpos_k, c_{k+1}];
- dynamics defects touch (x_k, u_k) and x_{k+1} diagonally;
- the scheduled variant's ground/no-slip equalities are linear in
  (u_k, c_{k+1}) with constant coefficients;
- the Lagrangian Hessian is block-tridiagonal in knot bundles.

Per-knot Jacobians and Hessians come from ``torch.func`` (``jacfwd`` /
``hessian``) vmapped over the B x (N-1) knot rows of all lanes at once.  The
step runs in the solver's scaled space: stage functions compose the
per-variable and per-row scales of the :class:`ScaledNLP`.  The inertia
ladder is an extra axis L, so every cyclic-reduction level of "cri" makes one
kernel launch over B * L * n_odd blocks.
"""

from __future__ import annotations

import types

import numpy as np
import torch
from torch.func import hessian, jacfwd, vmap

from .._device import constant
from ..ops.block_tridiag import qd_block_tridiag_factor, qd_block_tridiag_solve
from ..ops.cr_inverse import cri_factor, cri_solve
from ..ops.cyclic_reduction import cr_factor, cr_solve
from ..ops.pallas_blocks import make_qd_inverse
from ..problems.landing import knot_params
from ..tracing import span


def _layout(problem):
    """Static index layout for the flat z vector <-> knot blocks."""
    cfg = problem.config
    n = cfg.n_knots
    nx, nu, nj = 12, 24, cfg.n_joints
    nw = nx + nu + nj
    nh = 12 + (12 if (cfg.kinodynamic or cfg.init_foot_eq) else 0)  # head eq rows
    # scheduled variant: 4 ground-pin + 12 no-slip equality rows per knot
    # (quadruped_SRBM_NLP.m:158-163), linear in (u_k, c_{k+1})
    nsch = 16 if cfg.contact_scheduled else 0
    nd = 12 + nsch + nh  # dynamics + scheduled + (padded) head slots per block
    bs = nw + nd
    nb = n  # blocks: N-1 knots + tail

    idx = np.full((nb, nw), -1, dtype=np.int64)
    off_x, off_j, off_u = 0, 12 * n, 12 * n + nj * (n - 1)
    for k in range(n - 1):
        idx[k, :nx] = off_x + 12 * k + np.arange(12)
        idx[k, nx : nx + nu] = off_u + 24 * k + np.arange(24)
        if nj:
            idx[k, nx + nu :] = off_j + 12 * k + np.arange(12)
    idx[n - 1, :nx] = off_x + 12 * (n - 1) + np.arange(12)
    return dict(
        n=n, nx=nx, nu=nu, nj=nj, nw=nw, nh=nh, nsch=nsch, nd=nd, bs=bs, nb=nb, idx=idx
    )


def make_structured_newton_step(problem, theta, cfg, snlp):
    """Build a newton_step_fn for :func:`..solver.ip.solve` (scaled space).

    ``theta``: the lanes' LandingParams; ``snlp``: the ScaledNLP whose
    closures the outer loop uses (provides the z and row scales)."""
    backend = cfg.kkt_backend
    if backend.startswith("cri") and backend != "cri":
        raise NotImplementedError(
            f"kkt_backend={backend!r} forces a TPU or interpret path of the JAX package; "
            "the port has 'cri', 'cr' and 'scan'"
        )
    L = _layout(problem)
    n, nx, nu, nw, nh, nsch, nd, bs, nb = (
        L["n"], L["nx"], L["nu"], L["nw"], L["nh"], L["nsch"], L["nd"], L["bs"], L["nb"],
    )
    pcfg = problem.config
    zs = snlp.z_scale
    dtype, dev = zs.dtype, zs.device
    B = snlp.batch
    R = B * (n - 1)
    n_vars = problem.n_vars
    # the layout's index tensors, made once per dtype and device (constant)
    idx = L["idx"]
    valid_np = idx >= 0
    flat_pos_np = np.flatnonzero(valid_np)
    valid = constant(valid_np, torch.bool, dev)
    valid_f = constant(valid_np, dtype, dev)
    idx_safe = constant(np.where(valid_np, idx, 0), torch.int64, dev)
    flat_pos = constant(flat_pos_np, torch.int64, dev)
    flat_idx = constant(idx.reshape(-1)[flat_pos_np], torch.int64, dev)

    mg_term = 24 if pcfg.terminal_box else 0
    mgk = (problem.n_ineq - mg_term) // (n - 1)

    # scales in block layout
    zs_b = torch.where(valid, zs[:, idx_safe], torch.ones((), dtype=dtype, device=dev))
    gsc = snlp.ineq_scale[:, : (n - 1) * mgk].reshape(B, n - 1, mgk)
    gsc_t = snlp.ineq_scale[:, (n - 1) * mgk :]
    esc_head = snlp.eq_scale[:, :nh]
    esc_dyn = snlp.eq_scale[:, nh : nh + 12 * (n - 1)].reshape(B, n - 1, 12)
    f_scale = snlp.f_scale
    off_hd = nw + 12 + nsch  # the head multiplier slots of block 0
    if nsch:
        # scheduled eq rows follow the defects in problem.eq: all ground
        # rows (n-1, 4) then all no-slip rows (n-1, 12)
        off_gd = nh + 12 * (n - 1)
        esc_ground = snlp.eq_scale[:, off_gd : off_gd + 4 * (n - 1)].reshape(B, n - 1, 4)
        esc_noslip = snlp.eq_scale[:, off_gd + 4 * (n - 1) :].reshape(B, n - 1, 12)

    def z_to_blocks(z):
        return z[:, idx_safe] * valid_f

    def blocks_to_z(wb):
        flat = wb.new_zeros((wb.shape[0], n_vars))
        flat[:, flat_idx] = wb.reshape(wb.shape[0], -1)[:, flat_pos]
        return flat

    # ---- scaled stage functions (one knot; vmapped over B*(N-1) rows) ----
    def stage_ineq_s(v_t, vscale, gscale, kp):
        v = v_t * vscale
        x, u, jp, cn = v[:nx], v[nx : nx + nu], v[nx + nu : nw], v[nw:]
        return gscale * problem.knot_ineq(x, u, jp, cn, kp)

    def stage_defect_s(w_t, wscale, escale, kp):
        """Scaled defect minus its x_{k+1} term (handled diagonally)."""
        w = w_t * wscale
        x, u = w[:nx], w[nx : nx + nu]
        xdot = problem._xdot(x, u, kp["mass"], kp["ib"], kp["ib_inv"])
        return escale * (-x - xdot * kp["dt"])

    def stage_cost_s(w_t, wscale, fs, kp):
        """Scaled running cost of one knot (only with ``running_cost``)."""
        w = w_t * wscale
        return fs * problem._stage_cost(w[:nx], w[nx : nx + nu], kp)

    def head_eq_s(w0_t, zscale0, escale, head_ref):
        """x_0 = x_init and, where the problem has them, c_0 = c_init."""
        return escale * ((w0_t * zscale0)[:nh] - head_ref)

    def term_cost_s(xl_t, zscale, fs, qn, x_ref_n):
        err = xl_t * zscale - x_ref_n
        return fs * (qn * err * err).sum()

    def term_ineq_s(xl_t, zscale, gscale, bounds):
        return gscale * problem._terminal_ineq(xl_t * zscale, types.SimpleNamespace(**bounds))

    # per-knot scale bundles for v = [w_k, c_{k+1}]
    cnext_scale = torch.cat([zs_b[:, 1 : n - 1, nx : nx + 12], zs_b[:, n - 1 :, nx : nx + 12]], 1)
    v_scale = torch.cat([zs_b[:, : n - 1], cnext_scale], -1)  # (B, n-1, nw+12)
    kp = {k: v.reshape((R,) + v.shape[2:]) for k, v in knot_params(theta, n).items()}
    vs_f = v_scale.reshape(R, -1)
    gs_f = gsc.reshape(R, mgk)
    es_f = esc_dyn.reshape(R, 12)
    fs_f = f_scale[:, None].expand(B, n - 1).reshape(R)
    # w_0 starts with [x_0 (12), c_0 (12)]: the head rows pin its first nh entries
    head_ref = torch.cat([theta.q_init, theta.qd_init, theta.c_init], -1)[:, :nh]
    bounds = {k: getattr(theta, k) for k in ("q_term_min", "q_term_max", "qd_term_min", "qd_term_max")}
    eye_nd = torch.eye(nd, dtype=dtype, device=dev)
    ar = torch.arange(nw, device=dev)
    ladder = cfg.ladder_scales
    if backend == "cri":
        qdi = make_qd_inverse(nw, nd)

        def factor_fn(As, Cs):
            return cri_factor(As, Cs, qdi)

        solve_fn = cri_solve
    elif backend == "cr":
        def factor_fn(As, Cs):
            return cr_factor(As, Cs, nw, nd)

        def solve_fn(fac, rhs):
            return cr_solve(fac, rhs, nw, nd)
    else:
        def factor_fn(As, Cs):
            return qd_block_tridiag_factor(As, Cs, nw, nd)

        def solve_fn(fac, rhs):
            return qd_block_tridiag_solve(fac, rhs, nw, nd)

    if nsch:
        # ---- scheduled equality Jacobian coefficients (constant: the rows
        # are linear in z with per-(leg, coord) diagonal structure, so the
        # scaled Jacobians are precomputed coefficient arrays, no autodiff).
        # ground: esc * cs_k,leg * c_z[leg];  no-slip: esc * w_k,leg,d *
        # (c_{k+1} - c_k)[leg, d]  (problems/landing.py eq(), scheduled arm)
        cs = theta.cs  # (B, n-1, 4)
        w_ns = problem.noslip_weights(cs)  # (B, n-1, 4, 3)
        zs_c = zs_b[:, :, nx : nx + 12].reshape(B, nb, 4, 3)  # c-column scales per block
        Jg_coef = esc_ground * cs * zs_c[:, : n - 1, :, 2]  # dG/d(scaled cz col)
        esc_ns3 = esc_noslip.reshape(B, n - 1, 4, 3)
        Jns_own = (-esc_ns3 * w_ns * zs_c[:, : n - 1]).reshape(B, n - 1, 12)
        Jns_next = (esc_ns3 * w_ns * zs_c[:, 1:]).reshape(B, n - 1, 12)
        # dense per-knot row blocks over w_k (for A assembly)
        legs4 = torch.arange(4, device=dev)
        r12 = torch.arange(12, device=dev)
        Jg_w = torch.zeros((B, n - 1, 4, nw), dtype=dtype, device=dev)
        Jg_w[:, :, legs4, nx + 2 + 3 * legs4] = Jg_coef
        Jns_w = torch.zeros((B, n - 1, 12, nw), dtype=dtype, device=dev)
        Jns_w[:, :, r12, nx + r12] = Jns_own

    def knot_JM(v, vs, gs, kpr, sg):
        J = jacfwd(lambda vv: stage_ineq_s(vv, vs, gs, kpr))(v)
        return J.T @ (sg[:, None] * J)

    def knot_hess(v, vs, gs, kpr, lm, yk, esc, fs):
        def lag(vv):
            total = (yk * stage_defect_s(vv[:nw], vs[:nw], esc, kpr)).sum() - (
                lm * stage_ineq_s(vv, vs, gs, kpr)
            ).sum()
            if pcfg.running_cost:
                total = total + stage_cost_s(vv[:nw], vs[:nw], fs, kpr)
            return total

        return hessian(lag)(v)

    def knot_cost_hess(v, vs, kpr, fs):
        return hessian(lambda vv: stage_cost_s(vv[:nw], vs[:nw], fs, kpr))(v)

    def newton_step(z, y, lam, sigma, mu, use_exact, r_d, r_g, rhs_z, rhs_y, delta_last):
        with span("newton.derivatives"):
            wb = z_to_blocks(z)
            c_next = torch.cat([wb[:, 1 : n - 1, nx : nx + 12], wb[:, n - 1 :, nx : nx + 12]], 1)
            vk = torch.cat([wb[:, : n - 1], c_next], -1).reshape(R, -1)
            sig_k = sigma[:, : (n - 1) * mgk].reshape(R, mgk)
            lam_k = lam[:, : (n - 1) * mgk].reshape(R, mgk)
            y_dyn = y[:, nh : nh + 12 * (n - 1)].reshape(R, 12)

            # inequality Jacobians + sigma-weighted blocks
            M = vmap(knot_JM)(vk, vs_f, gs_f, kp, sig_k)

            # Lagrangian stage Hessians.  "hybrid" scales (y, lam), never the
            # cost, by the per-lane use_exact flag: uf=0 gives the GN Hessian
            # (the running cost's, zero without one), uf=1 the exact one, from
            # one sweep.
            if cfg.hessian_mode == "gn":
                HM = M + vmap(knot_cost_hess)(vk, vs_f, kp, fs_f) if pcfg.running_cost else M
            else:
                if cfg.hessian_mode == "hybrid":
                    uf = use_exact.to(dtype)[:, None].expand(B, n - 1).reshape(R, 1)
                    lam_h, y_h = uf * lam_k, uf * y_dyn
                else:
                    lam_h, y_h = lam_k, y_dyn
                HM = vmap(knot_hess)(vk, vs_f, gs_f, kp, lam_h, y_h, es_f, fs_f) + M
            HM = HM.reshape(B, n - 1, nw + 12, nw + 12)

            # defect Jacobians wrt w (scaled)
            Dk = vmap(jacfwd(stage_defect_s))(
                wb[:, : n - 1].reshape(R, nw), zs_b[:, : n - 1].reshape(R, nw), es_f, kp
            ).reshape(B, n - 1, 12, nw)

            Jh = vmap(jacfwd(head_eq_s))(wb[:, 0], zs_b[:, 0], esc_head, head_ref)  # (B, nh, nw)

            xl_t = wb[:, n - 1, :nx]
            zl = zs_b[:, n - 1, :nx]
            Ht = vmap(hessian(term_cost_s))(xl_t, zl, f_scale, theta.qn, theta.x_ref[:, -1])
            if mg_term:
                Jt = vmap(jacfwd(term_ineq_s))(xl_t, zl, gsc_t, bounds)  # (B, 24, 12)
                sig_t = sigma[:, (n - 1) * mgk :]
                Ht = Ht + Jt.transpose(1, 2) @ (sig_t[..., None] * Jt)

        with span("newton.assembly"):
            # x_{k+1} coefficient of the scaled defect rows: diag(esc * zscale)
            xnext_coef = esc_dyn * zs_b[:, 1:, :nx]  # (B, n-1, 12)

            # ---- assemble block-tridiagonal A, C -----------------------------
            A = z.new_zeros((B, nb, bs, bs))
            C = z.new_zeros((B, nb - 1, bs, bs))
            A[:, : n - 1, :nw, :nw] += HM[:, :, :nw, :nw]
            A[:, 1:n, nx : nx + 12, nx : nx + 12] += HM[:, :, nw:, nw:]
            C[:, : n - 1, nx : nx + 12, :nw] += HM[:, :, nw:, :nw]
            A[:, : n - 1, :nw, nw : nw + 12] += Dk.transpose(-1, -2)
            A[:, : n - 1, nw : nw + 12, :nw] += Dk
            C[:, : n - 1, :12, nw : nw + 12] += torch.diag_embed(xnext_coef)
            if nsch:
                # scheduled ground/no-slip multiplier slots (block k) and the
                # no-slip c_{k+1} coupling (diagonal into block k+1's c columns)
                A[:, : n - 1, :nw, nw + 12 : nw + 16] += Jg_w.transpose(-1, -2)
                A[:, : n - 1, nw + 12 : nw + 16, :nw] += Jg_w
                A[:, : n - 1, :nw, nw + 16 : nw + 28] += Jns_w.transpose(-1, -2)
                A[:, : n - 1, nw + 16 : nw + 28, :nw] += Jns_w
                C[:, :, nx + r12, nw + 16 + r12] += Jns_next
            A[:, 0, :nw, off_hd : off_hd + nh] += Jh.transpose(-1, -2)
            A[:, 0, off_hd : off_hd + nh, :nw] += Jh
            A[:, n - 1, :nx, :nx] += Ht
            A[:, n - 1, nx:nw, nx:nw] += torch.eye(nw - nx, dtype=dtype, device=dev)
            delta_c = torch.clamp(1e-6 * delta_last, min=cfg.delta_c)
            A[:, :, nw:, nw:] -= delta_c[:, None, None, None] * eye_nd

            # ---- regularization ladder + Jacobi equilibration ----------------
            dw = torch.diagonal(A[:, :, :nw, :nw], dim1=-2, dim2=-1)  # (B, nb, nw)
            base = 1e-2 * (dw * valid_f).mean((1, 2)) + 1e-12
            shift = dw.abs() + base[:, None, None]
            scale_w = 1.0 / torch.sqrt(shift)
            # multiplier-row equilibration (incl. the x_{k+1} coupling in C)
            dyn_norm2 = (Dk * Dk).sum(-1) + xnext_coef * xnext_coef
            nu_scale = z.new_ones((B, nb, nd))
            nu_scale[:, : n - 1, :12] = 1.0 / torch.sqrt(dyn_norm2 + 1e-6)
            if nsch:
                # scheduled rows have 1 (ground) / 2 (no-slip) diagonal nonzeros
                nu_scale[:, : n - 1, 12:16] = 1.0 / torch.sqrt(Jg_coef * Jg_coef + 1e-6)
                nu_scale[:, : n - 1, 16:28] = 1.0 / torch.sqrt(
                    Jns_own * Jns_own + Jns_next * Jns_next + 1e-6)
            head_norm2 = (Jh * Jh).sum(-1)
            nu_scale[:, 0, 12 + nsch : 12 + nsch + nh] = 1.0 / torch.sqrt(head_norm2 + 1e-6)
            d_block = torch.cat([scale_w, nu_scale], -1)  # (B, nb, bs)

            deltas = torch.stack(
                [torch.full_like(delta_last, cfg.delta_w) if s == 0.0 else s * delta_last
                 for s in ladder], 1
            )  # (B, L)
            As = A[:, None].repeat(1, len(ladder), 1, 1, 1)
            As[..., ar, ar] += deltas[:, :, None, None] * shift[:, None]
            As = As * d_block[:, None, :, :, None] * d_block[:, None, :, None, :]
            Cs = C * d_block[:, 1:, :, None] * d_block[:, :-1, None, :]
        with span("newton.factor"):
            facs = factor_fn(As, Cs[:, None].expand(-1, len(ladder), -1, -1, -1))
            oks = facs.ok  # (B, L)
            pick = torch.where(oks.any(1), torch.argmax(oks.to(torch.int32), 1),
                               torch.full_like(oks[:, 0], len(ladder) - 1, dtype=torch.int64))
            lanes = torch.arange(B, device=dev)
            fac = facs.select(lambda t: t[lanes, pick])
            delta_used = deltas[lanes, pick]
            As_u = As[lanes, pick]

        def K_mul(xb):
            out = (As_u @ xb[..., None])[..., 0]
            out[:, 1:] += (Cs @ xb[:, :-1, :, None])[..., 0]
            out[:, :-1] += (Cs.transpose(-1, -2) @ xb[:, 1:, :, None])[..., 0]
            return out

        # rhs in block layout; resolve() reuses the factorization for the
        # corrector re-solves
        def resolve(rhs_z_v, rhs_y_v):
            with span("newton.solve"):
                b = z.new_zeros((B, nb, bs))
                b[:, :, :nw] = z_to_blocks(rhs_z_v)
                b[:, : n - 1, nw : nw + 12] = rhs_y_v[:, nh : nh + 12 * (n - 1)].reshape(B, n - 1, 12)
                if nsch:
                    b[:, : n - 1, nw + 12 : nw + 16] = rhs_y_v[
                        :, off_gd : off_gd + 4 * (n - 1)].reshape(B, n - 1, 4)
                    b[:, : n - 1, nw + 16 : nw + 28] = rhs_y_v[
                        :, off_gd + 4 * (n - 1) :].reshape(B, n - 1, 12)
                b[:, 0, off_hd : off_hd + nh] = rhs_y_v[:, :nh]
                b_s = b * d_block
                x_s = solve_fn(fac, b_s)
                for _ in range(cfg.refine_steps):
                    # blockwise iterative refinement
                    x_s = x_s + solve_fn(fac, b_s - K_mul(x_s))
                x = x_s * d_block
                dz = blocks_to_z(x[..., :nw])
                dy_parts = [x[:, 0, off_hd : off_hd + nh], x[:, : n - 1, nw : nw + 12].reshape(B, -1)]
                if nsch:
                    dy_parts.append(x[:, : n - 1, nw + 12 : nw + 16].reshape(B, -1))
                    dy_parts.append(x[:, : n - 1, nw + 16 : nw + 28].reshape(B, -1))
                return dz, torch.cat(dy_parts, -1)

        dz, dy = resolve(rhs_z, rhs_y)
        return dz, dy, delta_used, resolve

    return newton_step
