"""Batched block inverses: the Hopper kernels and their plain versions.

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

``chol_inverse(A)`` inverts a batch of symmetric positive definite blocks
(m, n, n) by a Cholesky factorization and returns ``(Ainv, ok)``.  It
replaces the Pallas TPU kernel ``_chol_inverse_kernel``
(landing_controller_tpu/ops/pallas_blocks.py:137), with the same split: a
CUDA tensor goes to the kernel in ``csrc/chol_inverse.cu`` (f32, n up to 84)
or raises, and follows the TPU kernel's pivot rule; a CPU tensor goes to the
plain version :func:`chol_inverse_ref` (NaN where the factorization fails).

``qd_inverse.launches`` and ``chol_inverse.launches`` count kernel launches
(CPU calls do not count).
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load_library

__all__ = ["qd_inverse", "qd_inverse_ref", "make_qd_inverse", "chol_inverse", "chol_inverse_ref"]

# the widest block either kernel's shared-memory layout is sized for
MAX_BLOCK = 84


def qd_inverse_ref(S, np_: int, nd: int):
    """Plain PyTorch qd_inverse: (m, BS, BS) -> (Sinv (m, BS, BS), ok (m,))."""
    P = S[:, :np_, :np_]
    Bm = S[:, np_:, :np_]
    D = -S[:, np_:, np_:]
    nan = torch.tensor(float("nan"), dtype=S.dtype, device=S.device)

    def chol(A):
        # a non-finite input can pass LAPACK's own test (info 0) with a
        # non-finite factor: it fails here, as in the JAX qd_inverse_ref
        L, info = torch.linalg.cholesky_ex(A)
        good = (info == 0) & torch.isfinite(L).flatten(1).all(1)
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
    if np_ + nd > MAX_BLOCK:
        raise ValueError(f"qd_inverse kernel takes blocks up to {MAX_BLOCK} wide, got {np_ + nd}")
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


def chol_inverse_ref(A):
    """Plain PyTorch chol_inverse: (m, n, n) -> (Ainv (m, n, n), ok (m,)).
    A failed factorization yields NaN inverses and ok = False."""
    L, info = torch.linalg.cholesky_ex(A)
    ok = (info == 0) & torch.isfinite(L).flatten(1).all(1)  # a NaN input can give info 0
    nan = torch.tensor(float("nan"), dtype=A.dtype, device=A.device)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand_as(A)
    Ainv = torch.cholesky_solve(eye, torch.where(ok[:, None, None], L, nan))
    return 0.5 * (Ainv + Ainv.transpose(1, 2)), ok


def _chol_inverse_cuda(A):
    if A.dtype != torch.float32:
        raise TypeError(f"chol_inverse kernel takes float32, got {A.dtype}")
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"chol_inverse expects (m, n, n), got {tuple(A.shape)}")
    if A.shape[1] > MAX_BLOCK:
        raise ValueError(f"chol_inverse kernel takes blocks up to {MAX_BLOCK} wide, got {A.shape[1]}")
    A = A.contiguous()
    m, n = A.shape[0], A.shape[1]
    out = torch.empty_like(A)
    ok = torch.empty(m, dtype=torch.bool, device=A.device)
    lib = load_library("chol_inverse")
    fn = lib.chol_inverse_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(A.device).cuda_stream
    rc = fn(A.data_ptr(), out.data_ptr(), ok.data_ptr(), m, n, stream)
    if rc != 0:
        raise RuntimeError(f"chol_inverse kernel launch failed: cudaError {rc}")
    chol_inverse.launches += 1
    return out, ok


def chol_inverse(A):
    """Batched SPD inverse (m, n, n) -> (Ainv, ok (m,) bool)."""
    if A.device.type == "cuda":
        return _chol_inverse_cuda(A)
    if A.device.type == "cpu":
        return chol_inverse_ref(A)
    raise ValueError(f"chol_inverse runs on cuda or cpu tensors, got {A.device}")


chol_inverse.launches = 0
