"""ctypes binding for the native ``%.18e`` CSV formatter
(``csrc/fmt_csv.cpp``): the port's copy of ``timed_design_tpu/io/fast_fmt.py``.

``td-predict`` writes a rotamer head's ``{model}_rot.csv`` at full
precision, and ``np.savetxt`` formats one Python float per cell. glibc's
printf and CPython's float formatting are both correctly rounded, so the
native formatter writes the same bytes, on several threads. The library is
compiled with g++ at first use into the package's git-ignored ``_build/``,
under a name keyed on a hash of the source, and refused unless it formats a
probe row exactly as Python does. Rows it cannot take (negative, non-finite
or outside [1e-98, 1e99]: not 24 characters a cell) and a missing toolchain
leave the caller to ``np.savetxt``, which writes the same bytes.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from ..utils.native import PKG, build_host_library

_SRC = PKG / "csrc" / "fmt_csv.cpp"
_lock = threading.Lock()
_lib = None
_tried = False
_N_THREADS = min(16, os.cpu_count() or 1)


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build_host_library(_SRC)))
            lib.fmt_e18_rows.restype = ctypes.c_int
            lib.fmt_e18_rows.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_size_t,
                ctypes.c_size_t,
                ctypes.c_char_p,
                ctypes.c_int,
            ]
            # parity probe: refuse the library outright if its printf does
            # not reproduce Python's formatting on a spread of exact values
            probe = np.array(
                [[0.0, 1.0, 1 / 3, 0.1, 6e-8, 65504.0, 5.96e-8,
                  float(np.float32(0.7)), 1e-38, 3.4e38]], np.float64
            )
            got = _format(lib, probe)
            want = "".join(
                "%.18e%s" % (v, "," if j + 1 < probe.shape[1] else "\n")
                for j, v in enumerate(probe[0])
            ).encode()
            _lib = lib if got == want else None
        except (OSError, subprocess.CalledProcessError):
            _lib = None
        return _lib


def _format(lib, a: np.ndarray) -> bytes | None:
    n, c = a.shape
    out = ctypes.create_string_buffer(n * c * 25)
    ok = lib.fmt_e18_rows(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n, c, out, _N_THREADS,
    )
    return out.raw if ok else None


def native_available() -> bool:
    return _load() is not None


def write_e18_csv(f, data: np.ndarray) -> bool:
    """Write ``data`` as full-precision CSV rows to the BINARY file ``f``,
    byte-equal to ``np.savetxt(f, data, delimiter=',')`` (fmt ``%.18e``),
    and add one to ``write_e18_csv.calls``. Returns False, having written
    nothing, when the native formatter is unavailable or a cell falls
    outside its fixed-width path: the caller then uses ``np.savetxt``.
    """
    lib = _load()
    if lib is None:
        return False
    a = np.ascontiguousarray(np.asarray(data), np.float64)
    if a.ndim != 2 or a.size == 0:
        return False
    # refuse before writing anything: every cell must be non-negative,
    # finite and format with a two-digit exponent (24 characters), which
    # [1e-98, 1e99] guarantees whichever side of the power of ten the double
    # lies on; smaller values (float64 subnormals) take the savetxt path
    with np.errstate(invalid="ignore"):
        fits = (a == 0.0) | ((a >= 1e-98) & (a <= 1e99))
        if not bool(fits.all()) or bool(np.signbit(a).any()):
            return False
    # ~32 MB of text per chunk
    rows_per_chunk = max(1, (32 << 20) // (a.shape[1] * 25))
    for start in range(0, a.shape[0], rows_per_chunk):
        piece = _format(lib, a[start : start + rows_per_chunk])
        if piece is None:  # unreachable given the pre-check
            raise RuntimeError("native %.18e formatter rejected pre-validated rows")
        f.write(piece)
    write_e18_csv.calls += 1
    return True


write_e18_csv.calls = 0
