"""Batched quasi-definite block inverse: the Hopper kernel and its plain version.

``qd_inverse(S, np_, nd)`` inverts a batch of KKT blocks
S = [[P, B'], [B, -D]] (P, D positive definite) by the two-Cholesky Schur
scheme (Vanderbei 1995)::

    Sinv = [[Pinv - E W E', E W], [W E', -W]],  E = Pinv B',  W = (D + B E)^-1

and returns a per-instance inertia flag ``ok``.  It replaces the Pallas TPU
kernel ``_qd_inverse_kernel`` (landing_controller_tpu/ops/pallas_blocks.py:111).

- On a CUDA tensor it launches the hand-written kernel in
  ``csrc/qd_inverse.cu`` (f32 only), or raises.  Its ``ok`` follows the TPU
  kernel: ok = min(pivots) > 0, a non-finite pivot fails, and every output
  is computed past bad pivots.  On a block that is singular in f32 (a
  positive pivot below the 1e-30 clamp) the outputs may overflow while ok
  holds, as the TPU kernel's would.
- On a CPU tensor it runs the plain version :func:`qd_inverse_ref`, which
  follows the JAX ``qd_inverse_ref``: a failed Cholesky yields NaN inverses
  and ok = False.

``qd_inverse.launches`` counts kernel launches (CPU calls do not count).
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load_library

__all__ = ["qd_inverse", "qd_inverse_ref", "make_qd_inverse"]


def qd_inverse_ref(S, np_: int, nd: int):
    """Plain PyTorch qd_inverse: (m, BS, BS) -> (Sinv (m, BS, BS), ok (m,))."""
    P = S[:, :np_, :np_]
    Bm = S[:, np_:, :np_]
    D = -S[:, np_:, np_:]
    nan = torch.tensor(float("nan"), dtype=S.dtype, device=S.device)

    def chol(A):
        L, info = torch.linalg.cholesky_ex(A)
        good = info == 0
        return torch.where(good[:, None, None], L, nan), good

    lp, ok_p = chol(P)
    E = torch.cholesky_solve(Bm.transpose(1, 2), lp)
    Dt = D + Bm @ E
    ld, ok_d = chol(Dt)
    eye_d = torch.eye(nd, dtype=S.dtype, device=S.device).expand_as(Dt)
    W = torch.cholesky_solve(eye_d, ld)
    W = 0.5 * (W + W.transpose(1, 2))
    eye_p = torch.eye(np_, dtype=S.dtype, device=S.device).expand_as(P)
    Pinv = torch.cholesky_solve(eye_p, lp)
    EW = E @ W
    TL = Pinv - EW @ E.transpose(1, 2)
    Sinv = torch.cat(
        [torch.cat([TL, EW], 2), torch.cat([EW.transpose(1, 2), -W], 2)], 1
    )
    return Sinv, ok_p & ok_d


def _qd_inverse_cuda(S, np_: int, nd: int):
    if S.dtype != torch.float32:
        raise TypeError(f"qd_inverse kernel takes float32, got {S.dtype}")
    if S.dim() != 3 or S.shape[1] != np_ + nd or S.shape[2] != np_ + nd:
        raise ValueError(f"qd_inverse expects (m, {np_ + nd}, {np_ + nd}), got {tuple(S.shape)}")
    if np_ + nd > 84:
        raise ValueError(f"qd_inverse kernel takes blocks up to 84 wide, got {np_ + nd}")
    S = S.contiguous()
    m = S.shape[0]
    out = torch.empty_like(S)
    ok = torch.empty(m, dtype=torch.bool, device=S.device)
    lib = load_library("qd_inverse")
    fn = lib.qd_inverse_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(S.device).cuda_stream
    rc = fn(S.data_ptr(), out.data_ptr(), ok.data_ptr(), m, np_, nd, stream)
    if rc != 0:
        raise RuntimeError(f"qd_inverse kernel launch failed: cudaError {rc}")
    qd_inverse.launches += 1
    return out, ok


def qd_inverse(S, np_: int, nd: int):
    """Batched quasi-definite block inverse (m, BS, BS) -> (Sinv, ok (m,) bool)."""
    if S.device.type == "cuda":
        return _qd_inverse_cuda(S, np_, nd)
    if S.device.type == "cpu":
        return qd_inverse_ref(S, np_, nd)
    raise ValueError(f"qd_inverse runs on cuda or cpu tensors, got {S.device}")


qd_inverse.launches = 0


def make_qd_inverse(np_: int, nd: int):
    """Block-inverse function over (..., k, BS, BS) whose leading dimensions
    fold into the kernel's batch: one launch per call."""

    def fn(S):
        lead = S.shape[:-2]
        Sinv, ok = qd_inverse(S.reshape((-1,) + S.shape[-2:]), np_, nd)
        return Sinv.reshape(S.shape), ok.reshape(lead)

    return fn
