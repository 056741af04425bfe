"""Batched block inverses: the Hopper kernels and their plain versions.

``qd_inverse(S, np_, nd)`` inverts a batch of KKT blocks
S = [[P, B'], [B, -D]] (P, D positive definite) by the two-Cholesky Schur
scheme (Vanderbei 1995)::

    Sinv = [[Pinv - E W E', E W], [W E', -W]],  E = Pinv B',  W = (D + B E)^-1

and returns a per-instance inertia flag ``ok``.  It replaces the Pallas TPU
kernel ``_qd_inverse_kernel`` (landing_controller_tpu/ops/pallas_blocks.py:111).

- On a CUDA tensor it launches the hand-written kernel in
  ``csrc/qd_inverse.cu`` (f32 or f64), or raises.  The kernel runs the same
  scheme as one signed Cholesky S = L J L' by panels (``csrc/block_chol.cuh``)
  and returns a result that is symmetric bit for bit.  Its ``ok`` follows the
  TPU kernel: ok = min(pivots) > 0, a non-finite pivot fails, and every output
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
CUDA tensor goes to the kernel in ``csrc/chol_inverse.cu`` (f32 or f64, n up
to 84) or raises, and follows the TPU kernel's pivot rule; a CPU tensor goes to the
plain version :func:`chol_inverse_ref` (NaN where the factorization fails).

The counters ``qd_inverse.launches`` and ``chol_inverse.launches`` of
:mod:`..tracing` count kernel launches (CPU calls do not count).
``qd_inverse_smem_bytes`` / ``chol_inverse_smem_bytes`` mirror the kernels'
shared-memory layout, ``library_smem_bytes`` reads the same figure from the
built library, and ``blocks_per_sm`` asks the card how many blocks of a
kernel instance one SM holds; each takes the dtype (f32 by default, f64:
twice the bytes).  Every kernel instance exists for f32 and
f64: a float64 tensor on the card goes through the kernel too, never to the
plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .._device import constant
from ..tracing import count
from ._build import load_library

__all__ = ["qd_inverse", "qd_inverse_ref", "make_qd_inverse", "chol_inverse", "chol_inverse_ref"]

# the widest block either kernel takes
MAX_BLOCK = 84
# the kernels' panel width (csrc/block_chol.cuh: kPanel)
PANEL = 8


def padded_size(bs: int) -> int:
    """Rows of a block in the kernels' shared memory: bs rounded up to the
    4-wide register tile (identity padding)."""
    return (bs + 3) // 4 * 4


def row_stride(bs: int) -> int:
    """Floats between two rows in shared memory: a multiple of 4 that leaves
    4 modulo 8, so that float4 accesses to consecutive rows fall into
    distinct banks."""
    n = padded_size(bs)
    return n + 4 if n % 8 == 0 else n


def block_smem_bytes(bs: int, dtype=torch.float32) -> int:
    """Dynamic shared memory of one kernel block for a bs-wide matrix (the
    mirror of ``block_chol::smem_bytes<T>``): the matrix, a PANEL x n scratch
    (values of ``dtype``) and a table of lower-triangle positions (two bytes
    for each 4x4 tile, and at least for each element of a diagonal tile's
    lower triangle)."""
    n = padded_size(bs)
    entries = max((n // 4) * (n // 4 + 1) // 2, PANEL * (PANEL + 1) // 2)
    return dtype.itemsize * (n * row_stride(bs) + PANEL * n) + (2 * entries + 15) // 16 * 16


def qd_inverse_smem_bytes(np_: int, nd: int, dtype=torch.float32) -> int:
    return block_smem_bytes(np_ + nd, dtype)


def chol_inverse_smem_bytes(n: int, dtype=torch.float32) -> int:
    return block_smem_bytes(n, dtype)


def qd_inverse_ref(S, np_: int, nd: int):
    """Plain PyTorch qd_inverse: (m, BS, BS) -> (Sinv (m, BS, BS), ok (m,))."""
    P = S[:, :np_, :np_]
    Bm = S[:, np_:, :np_]
    D = -S[:, np_:, np_:]
    nan = constant(float("nan"), S.dtype, S.device)

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


# the dtypes the kernels take, and the suffix of their C entry points
_SUFFIX = {torch.float32: "", torch.float64: "_f64"}


def _aligned(x):
    """x contiguous and 16-byte aligned (the kernels' float4 accesses)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


_functions: dict = {}


def _function(name: str, symbol: str, n_sizes: int, launch: bool, restype=ctypes.c_int):
    """The C function ``symbol`` of ``csrc/<name>.cu`` with its ctypes
    signature set, looked up once."""
    fn = _functions.get(symbol)
    if fn is None:
        fn = getattr(load_library(name), symbol)
        sizes = [ctypes.c_int] * n_sizes
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + sizes + [ctypes.c_void_p] \
            if launch else sizes
        fn.restype = restype
        _functions[symbol] = fn
    return fn


def _launch(name: str, x, *sizes):
    """Launch ``<name>_launch`` of ``csrc/<name>.cu`` on the blocks x (m, k, k)
    with the integer arguments ``sizes``, on the current stream; returns
    (inverse, ok)."""
    m = x.shape[0]
    out = torch.empty_like(x)
    ok = torch.empty(m, dtype=torch.bool, device=x.device)
    fn = _function(name, f"{name}_launch{_SUFFIX[x.dtype]}", len(sizes), launch=True)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), out.data_ptr(), ok.data_ptr(), m, *sizes, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    return out, ok


def blocks_per_sm(name: str, *sizes, dtype=torch.float32) -> int:
    """Thread blocks of the kernel instance for ``sizes`` ((np, nd) for
    "qd_inverse", (n,) for "chol_inverse") and ``dtype`` that one SM holds at
    a time."""
    symbol = f"{name}_blocks_per_sm{_SUFFIX[dtype]}"
    blocks = _function(name, symbol, len(sizes), launch=False)(*sizes)
    if blocks < 0:
        raise RuntimeError(f"{name} occupancy query failed: cudaError {-blocks}")
    return blocks


def library_smem_bytes(name: str, *sizes, dtype=torch.float32) -> int:
    """Dynamic shared memory that the built library gives one block of the
    kernel instance for ``sizes`` and ``dtype``: the figure that sizes its
    launches, which :func:`block_smem_bytes` mirrors."""
    fn = _function(name, f"{name}_smem_bytes{_SUFFIX[dtype]}", len(sizes), launch=False,
                   restype=ctypes.c_size_t)
    return int(fn(*sizes))


def _qd_inverse_cuda(S, np_: int, nd: int):
    if S.dtype not in _SUFFIX:
        raise TypeError(f"qd_inverse kernel takes float32 or float64, got {S.dtype}")
    if S.dim() != 3 or S.shape[1] != np_ + nd or S.shape[2] != np_ + nd:
        raise ValueError(f"qd_inverse expects (m, {np_ + nd}, {np_ + nd}), got {tuple(S.shape)}")
    if np_ < 1 or nd < 0 or np_ + nd > MAX_BLOCK:
        raise ValueError(f"qd_inverse kernel takes blocks up to {MAX_BLOCK} wide with np >= 1, "
                         f"got ({np_}, {nd})")
    out = _launch("qd_inverse", _aligned(S), np_, nd)
    count("qd_inverse.launches")
    return out


def _check_device(x, name: str):
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {x.device}")


def _empty_outputs(x):
    """The fake implementation of both ops: the shapes of (inverse, ok)."""
    return (torch.empty_like(x, memory_format=torch.contiguous_format),
            x.new_empty(x.shape[:1], dtype=torch.bool))


# qd_inverse and chol_inverse are registered custom ops, so that a traced or
# saved program holds one node that names the kernel: on a CUDA tensor it
# launches the kernel (or raises), on a CPU tensor it runs the plain version
_qd_inverse_op = torch.library.custom_op(
    "landing_controller_tpu_torch::qd_inverse", mutates_args=(), device_types="cuda",
    schema="(Tensor S, int np_, int nd) -> (Tensor, Tensor)")(_qd_inverse_cuda)
_qd_inverse_op.register_kernel("cpu")(qd_inverse_ref)
_qd_inverse_op.register_fake(lambda S, np_, nd: _empty_outputs(S))


def qd_inverse(S, np_: int, nd: int):
    """Batched quasi-definite block inverse (m, BS, BS) -> (Sinv, ok (m,) bool)."""
    _check_device(S, "qd_inverse")
    return _qd_inverse_op(S, np_, nd)


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
    nan = constant(float("nan"), A.dtype, A.device)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand_as(A)
    Ainv = torch.cholesky_solve(eye, torch.where(ok[:, None, None], L, nan))
    # contiguous, as the kernel's output (the custom op's fake implementation)
    return (0.5 * (Ainv + Ainv.transpose(1, 2))).contiguous(), ok


def _chol_inverse_cuda(A):
    if A.dtype not in _SUFFIX:
        raise TypeError(f"chol_inverse kernel takes float32 or float64, got {A.dtype}")
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"chol_inverse expects (m, n, n), got {tuple(A.shape)}")
    if not 1 <= A.shape[1] <= MAX_BLOCK:
        raise ValueError(f"chol_inverse kernel takes blocks up to {MAX_BLOCK} wide, got {A.shape[1]}")
    out = _launch("chol_inverse", _aligned(A), A.shape[1])
    count("chol_inverse.launches")
    return out


_chol_inverse_op = torch.library.custom_op(
    "landing_controller_tpu_torch::chol_inverse", mutates_args=(), device_types="cuda",
    schema="(Tensor A) -> (Tensor, Tensor)")(_chol_inverse_cuda)
_chol_inverse_op.register_kernel("cpu")(chol_inverse_ref)
_chol_inverse_op.register_fake(_empty_outputs)


def chol_inverse(A):
    """Batched SPD inverse (m, n, n) -> (Ainv, ok (m,) bool)."""
    _check_device(A, "chol_inverse")
    return _chol_inverse_op(A)
