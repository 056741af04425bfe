"""Stage-structured Newton step for the srbm_lcp NLP (batch-first).

Replaces a dense KKT factorization with per-knot blocks and the
inverse-based block cyclic reduction of :mod:`..ops.cr_inverse`:

- inequality rows of knot k touch only v_k = [x_k, u_k, c_{k+1}];
- dynamics defects touch (x_k, u_k) and x_{k+1} diagonally;
- the Lagrangian Hessian is block-tridiagonal in knot bundles.

Per-knot Jacobians and Hessians come from ``torch.func`` (``jacfwd`` /
``hessian``) vmapped over the B x (N-1) knot rows of all lanes at once.  The
step runs in the solver's scaled space: stage functions compose the
per-variable and per-row scales of the :class:`ScaledNLP`.  The inertia
ladder is an extra axis L, so every cyclic-reduction level makes one kernel
launch over B * L * n_odd blocks.
"""

from __future__ import annotations

import types

import numpy as np
import torch
from torch.func import hessian, jacfwd, vmap

from ..ops.cr_inverse import cri_factor, cri_solve
from ..ops.pallas_blocks import make_qd_inverse
from ..problems.landing import knot_params


def _layout(problem):
    """Static index layout for the flat z vector <-> knot blocks (srbm_lcp:
    no joint variables, 12 head equality rows)."""
    n = problem.config.n_knots
    nx, nu = 12, 24
    nw = nx + nu
    nh = 12  # head eq rows (x_0 = x_init)
    nd = 12 + nh  # dynamics + (padded) head slots per block
    bs = nw + nd
    nb = n  # blocks: N-1 knots + tail

    idx = np.full((nb, nw), -1, dtype=np.int64)
    off_u = 12 * n
    for k in range(n - 1):
        idx[k, :nx] = 12 * k + np.arange(12)
        idx[k, nx:] = off_u + 24 * k + np.arange(24)
    idx[n - 1, :nx] = 12 * (n - 1) + np.arange(12)
    return dict(n=n, nx=nx, nu=nu, nw=nw, nh=nh, nd=nd, bs=bs, nb=nb, idx=idx)


def make_structured_newton_step(problem, theta, cfg, snlp):
    """Build a newton_step_fn for :func:`..solver.ip.solve` (scaled space).

    ``theta``: the lanes' LandingParams; ``snlp``: the ScaledNLP whose
    closures the outer loop uses (provides the z and row scales)."""
    if cfg.kkt_backend != "cri":
        raise NotImplementedError(
            f"kkt_backend={cfg.kkt_backend!r}: the PyTorch port has the 'cri' backend only"
        )
    L = _layout(problem)
    n, nx, nu, nw, nh, nd, bs, nb = (
        L["n"], L["nx"], L["nu"], L["nw"], L["nh"], L["nd"], L["bs"], L["nb"],
    )
    zs = snlp.z_scale
    dtype, dev = zs.dtype, zs.device
    B = snlp.batch
    R = B * (n - 1)
    n_vars = problem.n_vars
    idx = torch.as_tensor(L["idx"], device=dev)
    valid = idx >= 0
    idx_safe = torch.where(valid, idx, torch.zeros_like(idx))
    valid_f = valid.to(dtype)
    flat_pos = torch.nonzero(valid.reshape(-1)).reshape(-1)
    flat_idx = idx.reshape(-1)[flat_pos]

    mg_term = 24
    mgk = (problem.n_ineq - mg_term) // (n - 1)

    # scales in block layout
    zs_b = torch.where(valid, zs[:, idx_safe], torch.ones((), dtype=dtype, device=dev))
    gsc = snlp.ineq_scale[:, : (n - 1) * mgk].reshape(B, n - 1, mgk)
    gsc_t = snlp.ineq_scale[:, (n - 1) * mgk :]
    esc_head = snlp.eq_scale[:, :nh]
    esc_dyn = snlp.eq_scale[:, nh : nh + 12 * (n - 1)].reshape(B, n - 1, 12)
    f_scale = snlp.f_scale

    def z_to_blocks(z):
        return z[:, idx_safe] * valid_f

    def blocks_to_z(wb):
        flat = wb.new_zeros((wb.shape[0], n_vars))
        flat[:, flat_idx] = wb.reshape(wb.shape[0], -1)[:, flat_pos]
        return flat

    # ---- scaled stage functions (one knot; vmapped over B*(N-1) rows) ----
    def stage_ineq_s(v_t, vscale, gscale, kp):
        v = v_t * vscale
        x, u, cn = v[:nx], v[nx : nx + nu], v[nw:]
        return gscale * problem._knot_ineq_srbm(x, u, cn, kp["ns_mask"], kp)

    def stage_defect_s(w_t, wscale, escale, kp):
        """Scaled defect minus its x_{k+1} term (handled diagonally)."""
        w = w_t * wscale
        x, u = w[:nx], w[nx : nx + nu]
        xdot = problem._xdot(x, u, kp["mass"], kp["ib"], kp["ib_inv"])
        return escale * (-x - xdot * kp["dt"])

    def head_eq_s(w0_t, zscale0, escale, x_init):
        return escale * ((w0_t * zscale0)[:nx] - x_init)

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
    x_init = torch.cat([theta.q_init, theta.qd_init], -1)
    bounds = {k: getattr(theta, k) for k in ("q_term_min", "q_term_max", "qd_term_min", "qd_term_max")}
    eye_nd = torch.eye(nd, dtype=dtype, device=dev)
    ar = torch.arange(nw, device=dev)
    ladder = cfg.ladder_scales
    qdi = make_qd_inverse(nw, nd)

    def knot_JM(v, vs, gs, kpr, sg):
        J = jacfwd(lambda vv: stage_ineq_s(vv, vs, gs, kpr))(v)
        return J.T @ (sg[:, None] * J)

    def knot_hess(v, vs, gs, kpr, lm, yk, esc):
        def lag(vv):
            return (yk * stage_defect_s(vv[:nw], vs[:nw], esc, kpr)).sum() - (
                lm * stage_ineq_s(vv, vs, gs, kpr)
            ).sum()

        return hessian(lag)(v)

    def newton_step(z, y, lam, sigma, mu, use_exact, r_d, r_g, rhs_z, rhs_y, delta_last):
        wb = z_to_blocks(z)
        c_next = torch.cat([wb[:, 1 : n - 1, nx : nx + 12], wb[:, n - 1 :, nx : nx + 12]], 1)
        vk = torch.cat([wb[:, : n - 1], c_next], -1).reshape(R, -1)
        sig_k = sigma[:, : (n - 1) * mgk].reshape(R, mgk)
        lam_k = lam[:, : (n - 1) * mgk].reshape(R, mgk)
        y_dyn = y[:, nh : nh + 12 * (n - 1)].reshape(R, 12)

        # inequality Jacobians + sigma-weighted blocks
        M = vmap(knot_JM)(vk, vs_f, gs_f, kp, sig_k)

        # Lagrangian stage Hessians.  "hybrid" scales (y, lam) by the
        # per-lane use_exact flag: uf=0 gives the GN Hessian (zero here: no
        # running cost), uf=1 the exact one, from one sweep.
        if cfg.hessian_mode == "gn":
            HM = M
        else:
            if cfg.hessian_mode == "hybrid":
                uf = use_exact.to(dtype)[:, None].expand(B, n - 1).reshape(R, 1)
                lam_h, y_h = uf * lam_k, uf * y_dyn
            else:
                lam_h, y_h = lam_k, y_dyn
            HM = vmap(knot_hess)(vk, vs_f, gs_f, kp, lam_h, y_h, es_f) + M
        HM = HM.reshape(B, n - 1, nw + 12, nw + 12)

        # defect Jacobians wrt w (scaled)
        Dk = vmap(jacfwd(stage_defect_s))(
            wb[:, : n - 1].reshape(R, nw), zs_b[:, : n - 1].reshape(R, nw), es_f, kp
        ).reshape(B, n - 1, 12, nw)

        Jh = vmap(jacfwd(head_eq_s))(wb[:, 0], zs_b[:, 0], esc_head, x_init)  # (B, nh, nw)

        xl_t = wb[:, n - 1, :nx]
        zl = zs_b[:, n - 1, :nx]
        Ht = vmap(hessian(term_cost_s))(xl_t, zl, f_scale, theta.qn, theta.x_ref[:, -1])
        Jt = vmap(jacfwd(term_ineq_s))(xl_t, zl, gsc_t, bounds)  # (B, 24, 12)
        sig_t = sigma[:, (n - 1) * mgk :]
        Ht = Ht + Jt.transpose(1, 2) @ (sig_t[..., None] * Jt)

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
        A[:, 0, :nw, nw + 12 : nw + 12 + nh] += Jh.transpose(-1, -2)
        A[:, 0, nw + 12 : nw + 12 + nh, :nw] += Jh
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
        head_norm2 = (Jh * Jh).sum(-1)
        nu_scale[:, 0, 12 : 12 + nh] = 1.0 / torch.sqrt(head_norm2 + 1e-6)
        d_block = torch.cat([scale_w, nu_scale], -1)  # (B, nb, bs)

        deltas = torch.stack(
            [torch.full_like(delta_last, cfg.delta_w) if s == 0.0 else s * delta_last
             for s in ladder], 1
        )  # (B, L)
        As = A[:, None].repeat(1, len(ladder), 1, 1, 1)
        As[..., ar, ar] += deltas[:, :, None, None] * shift[:, None]
        As = As * d_block[:, None, :, :, None] * d_block[:, None, :, None, :]
        Cs = C * d_block[:, 1:, :, None] * d_block[:, :-1, None, :]
        facs = cri_factor(As, Cs[:, None].expand(-1, len(ladder), -1, -1, -1), qdi)
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
            b = z.new_zeros((B, nb, bs))
            b[:, :, :nw] = z_to_blocks(rhs_z_v)
            b[:, : n - 1, nw : nw + 12] = rhs_y_v[:, nh : nh + 12 * (n - 1)].reshape(B, n - 1, 12)
            b[:, 0, nw + 12 : nw + 12 + nh] = rhs_y_v[:, :nh]
            b_s = b * d_block
            x_s = cri_solve(fac, b_s)
            for _ in range(cfg.refine_steps):
                # blockwise iterative refinement
                x_s = x_s + cri_solve(fac, b_s - K_mul(x_s))
            x = x_s * d_block
            dz = blocks_to_z(x[..., :nw])
            dy = torch.cat(
                [x[:, 0, nw + 12 : nw + 12 + nh], x[:, : n - 1, nw : nw + 12].reshape(B, -1)], -1
            )
            return dz, dy

        dz, dy = resolve(rhs_z, rhs_y)
        return dz, dy, delta_used, resolve

    return newton_step
