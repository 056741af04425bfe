"""ctypes bindings for the native runtime (scenario pool + result log).

The shared library is built from ``scenario_pool.cpp`` at first use with the
system C++ compiler (plain C ABI, no pybind11) into the repository's
``build/native/`` directory; its file name carries a hash of the source, so
an edited source is rebuilt and a stale library is never loaded.  Where no
compiler is found, numpy fallbacks keep everything working: the native path
is an optimization of the host side, never a correctness dependency.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import tempfile
import threading
import zlib

import numpy as np
import torch

from .._tree import to_numpy

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenario_pool.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "native",
)
_lib = None
_lock = threading.Lock()


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libscenario_pool-{digest}.so")


def _build(path: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    for cc in ("g++", "c++", "clang++"):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(
                [cc, "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", _SRC, "-o", tmp],
                check=True, capture_output=True, timeout=120,
            )
        except (FileNotFoundError, subprocess.CalledProcessError, subprocess.TimeoutExpired):
            os.unlink(tmp)
            continue
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
        return True
    return False


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            _lib = False
            return _lib
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _lib = False
            return _lib
        lib.lctpu_pool_create.restype = ctypes.c_void_p
        lib.lctpu_pool_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64]
        lib.lctpu_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.lctpu_pool_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.lctpu_pool_next.restype = ctypes.c_int
        lib.lctpu_sample.argtypes = [ctypes.c_uint64, ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p]
        lib.lctpu_log_open.restype = ctypes.c_void_p
        lib.lctpu_log_open.argtypes = [ctypes.c_char_p]
        lib.lctpu_log_close.argtypes = [ctypes.c_void_p]
        lib.lctpu_log_append.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
        lib.lctpu_log_append.restype = ctypes.c_int
        lib.lctpu_crc32.restype = ctypes.c_uint32
        lib.lctpu_crc32.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        _lib = lib
        return _lib


def native_available() -> bool:
    return bool(_load())


def _sample_numpy(seed: int, n: int):
    """The fallback sampler: numpy draws, the height from the port's XYZ
    rotation (``warmstart.reference.drop_scenario_from_draws``)."""
    from ..warmstart.reference import drop_scenario_from_draws

    rng = np.random.default_rng(seed)
    q = np.zeros((n, 6), np.float32)
    qd = np.empty((n, 6), np.float32)
    q[:, 3] = rng.uniform(-0.25, 0.25, n)
    q[:, 4] = rng.uniform(-np.pi / 3, np.pi / 3, n)
    q[:, 5] = rng.uniform(-0.25, 0.25, n)
    qd[:, 0:3] = rng.uniform(-0.5, 0.5, (n, 3))
    qd[:, 3:5] = rng.uniform(-1, 1, (n, 2))
    qd[:, 5] = -(0.5 + 4.5 * rng.uniform(0, 1, n))
    q_t, _ = drop_scenario_from_draws(torch.as_tensor(q[:, 3:6]), torch.as_tensor(qd[:, 0:3]),
                                      torch.as_tensor(qd[:, 3:6]))
    q[:, 2] = q_t[:, 2].numpy()
    return q, qd


def sample_scenarios_native(seed: int, n: int):
    """Sample n drop scenarios with the native sampler -> (q (n,6), qd (n,6)).

    Same sampling rule as warmstart.reference.sample_drop_scenario
    (generate_training_data_automated.m:44-60), different RNG stream.
    """
    lib = _load()
    if not lib:
        return _sample_numpy(seed, n)
    q = np.empty((n, 6), np.float32)
    qd = np.empty((n, 6), np.float32)
    lib.lctpu_sample(
        ctypes.c_uint64(seed), ctypes.c_int(n),
        q.ctypes.data_as(ctypes.c_void_p), qd.ctypes.data_as(ctypes.c_void_p),
    )
    return q, qd


class NativeScenarioPool:
    """Multi-threaded background scenario generator (double-buffered).

    Keeps `depth` ready batches ahead of the consumer so device solves never
    wait on host-side sampling.  Which worker thread fills which batch is not
    fixed, so the order of the batches is not reproducible; each batch is a
    valid sample.  Falls back to synchronous numpy sampling if the native
    library is unavailable.
    """

    def __init__(self, batch: int, depth: int = 4, threads: int = 2, seed: int = 0):
        self.batch = batch
        self._seed = seed
        self._n = 0
        lib = _load()
        self._lib = lib if lib else None
        self._pool = (
            lib.lctpu_pool_create(batch, depth, threads, ctypes.c_uint64(seed))
            if lib
            else None
        )

    def next(self):
        """-> (q (B,6) float32, qd (B,6) float32)."""
        if self._pool is None:
            self._n += 1
            return sample_scenarios_native(self._seed + self._n, self.batch)
        q = np.empty((self.batch, 6), np.float32)
        qd = np.empty((self.batch, 6), np.float32)
        self._lib.lctpu_pool_next(
            self._pool, q.ctypes.data_as(ctypes.c_void_p), qd.ctypes.data_as(ctypes.c_void_p)
        )
        return q, qd

    def close(self):
        if self._pool is not None:
            self._lib.lctpu_pool_destroy(self._pool)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


_MAGIC = 0x4C43544B


class ResultLog:
    """Append-only CRC-framed binary result log (durable solve artifacts).

    Record = [u32 magic][u32 len][payload][u32 crc32].  The native writer is
    thread-safe and flushes every record; the Python fallback writes the same
    format.  Tensors are accepted wherever arrays are (moved to the host).
    """

    def __init__(self, path: str):
        self.path = path
        lib = _load()
        self._lib = lib if lib else None
        self._h = lib.lctpu_log_open(path.encode()) if lib else None
        self._f = None if lib else open(path, "ab")

    def append(self, payload: bytes) -> bool:
        if self._h is not None:
            return bool(self._lib.lctpu_log_append(self._h, payload, len(payload)))
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        self._f.write(struct.pack("<II", _MAGIC, len(payload)) + payload + struct.pack("<I", crc))
        self._f.flush()
        return True

    def append_solution(self, q_init, qd_init, z, converged: bool, lam=None, y=None):
        """Append one solve record; optional inequality/equality multipliers
        are persisted after the primal so warm restarts can reload the full
        (z, lam, y) state (the reference saves lam_g_star alongside the
        primals in prevSoln.mat, landing_optimization.m:395)."""
        f32 = lambda a: to_numpy(a).astype(np.float32)  # noqa: E731
        z = f32(z)
        meta = struct.pack("<I?3x", len(z), bool(converged))
        lam = np.zeros(0, np.float32) if lam is None else f32(lam)
        y = np.zeros(0, np.float32) if y is None else f32(y)
        payload = (
            meta
            + f32(q_init).tobytes()
            + f32(qd_init).tobytes()
            + z.tobytes()
            + struct.pack("<II", lam.size, y.size)
            + lam.tobytes()
            + y.tobytes()
        )
        return self.append(payload)

    def close(self):
        if self._h is not None:
            self._lib.lctpu_log_close(self._h)
            self._h = None
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_result_log(path: str):
    """Parse a result log -> list of dicts; CRC-checked, truncation-safe."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off + 12 <= len(data):
        magic, ln = struct.unpack_from("<II", data, off)
        if magic != _MAGIC or off + 8 + ln + 4 > len(data):
            break
        payload = data[off + 8 : off + 8 + ln]
        (crc,) = struct.unpack_from("<I", data, off + 8 + ln)
        if zlib.crc32(payload) & 0xFFFFFFFF == crc:
            nz, conv = struct.unpack_from("<I?", payload, 0)
            arr = np.frombuffer(payload, np.float32, offset=8)
            rec = {
                "q_init": arr[:6].copy(),
                "qd_init": arr[6:12].copy(),
                "z": arr[12 : 12 + nz].copy(),
                "converged": bool(conv),
            }
            # optional trailing duals: [u32 n_lam][u32 n_y][lam][y]
            dual_off = 8 + 4 * (12 + nz)
            if len(payload) >= dual_off + 8:
                n_lam, n_y = struct.unpack_from("<II", payload, dual_off)
                duals = np.frombuffer(payload, np.float32, offset=dual_off + 8)
                if duals.size >= n_lam + n_y:
                    rec["lam"] = duals[:n_lam].copy()
                    rec["y"] = duals[n_lam : n_lam + n_y].copy()
            out.append(rec)
        off += 8 + ln + 4
    return out
