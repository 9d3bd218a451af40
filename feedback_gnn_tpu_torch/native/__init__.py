"""The port's host GF(2) core: bit-packed C++ elimination, loaded with ctypes.

``gf2_native.cpp`` beside this file holds ``gf2_row_echelon`` and
``gf2_matmul`` over uint64 words; ``codes/gf2.py`` hands it every matrix of
64 x 64 entries or more.  The shared library is built at first use with
``g++ -O3 -shared -fPIC`` (about a second) into ``_build/`` of the package
(listed in .gitignore), named by a hash of the source and the flags, so a
library of another source is never picked up.  Each process compiles to a
temporary name of its own and moves it into place with ``os.replace``, so
processes that build at once never see a half-written library; one that
is already there counts as built.  Without the compiler, or when it fails,
the first call raises ``RuntimeError`` with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

__all__ = ["available", "row_echelon_native", "gf2_matmul_native", "build", "load"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "gf2_native.cpp")
_OUT_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()


def library_path(out_dir: str = _OUT_DIR) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0")
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(out_dir, f"libgf2-{h.hexdigest()[:16]}.so")


def build(out_dir: str = _OUT_DIR) -> str:
    """The library's path in ``out_dir``, compiled first if it is not there."""
    lib = library_path(out_dir)
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, _SRC, "-o", tmp], capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"cannot run {CXX} to build the GF(2) core: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        if os.path.exists(lib):  # another process built it meanwhile
            return lib
        raise RuntimeError(f"{CXX} failed to build the GF(2) core (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load(out_dir: str = _OUT_DIR) -> ctypes.CDLL:
    """The library of ``out_dir`` (built first if need be), its functions typed."""
    lib = ctypes.CDLL(build(out_dir))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.gf2_row_echelon.restype = ctypes.c_int
    lib.gf2_row_echelon.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int32)]
    lib.gf2_matmul.restype = None
    lib.gf2_matmul.argtypes = [u8p] * 3 + [ctypes.c_int] * 3
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = load()
    return _lib


def available() -> bool:
    """Whether the core builds and loads here."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _u8ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def row_echelon_native(mat: np.ndarray, reduced: bool = False, lib: ctypes.CDLL | None = None):
    """``codes.gf2.row_echelon`` on the core: the same contract and pivot
    choices, ``[row_ech_form, rank, transform, pivot_cols]``.  ``lib``: a
    library from ``load`` (default: this package's)."""
    lib = lib or _load()
    m, n = mat.shape
    work = np.ascontiguousarray(mat.astype(np.uint8) & 1)
    transform = np.zeros((m, m), np.uint8)
    pivots = np.zeros(max(n, 1), np.int32)
    rank = lib.gf2_row_echelon(_u8ptr(work), m, n, _u8ptr(transform), int(reduced),
                               pivots.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return [work.astype(int), int(rank), transform.astype(int), pivots[:rank].tolist()]


def gf2_matmul_native(h: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(h @ v) % 2 on the host, bit-packed, as an int array."""
    lib = _load()
    m, n = h.shape
    if v.shape[0] != n:
        raise ValueError(f"shapes {h.shape} and {v.shape} do not multiply")
    b = v.shape[1]
    hh = np.ascontiguousarray(h.astype(np.uint8) & 1)
    vv = np.ascontiguousarray(v.astype(np.uint8) & 1)
    out = np.zeros((m, b), np.uint8)
    lib.gf2_matmul(_u8ptr(hh), _u8ptr(vv), _u8ptr(out), m, n, b)
    return out.astype(int)
