"""zlib streams inflated from several host threads, straight into the
caller's buffers: the port's copy of ``timed_design_tpu/io/fast_inflate.py``.

The tree-layout loader (``io/h5frames.py``) reads a batch's raw gzip chunks
itself and inflates them here, in the C++ thread pool of
``csrc/inflate_pool.cpp`` (``uncompress`` of the process's libz.so.1). A
thread pool over Python's ``zlib`` came first: it inflates more slowly
(``zlib.decompress`` allocates every output anew, copied in under the
interpreter lock), and a training loop fed from a tree file then keeps the
card busy for less of its time (the HDF5 record of ``PERF.md`` section 6,
measured on the card). The library is compiled with g++ at first use into the package's git-ignored ``_build/``; a build or load
failure raises, with no quiet fallback. ``deflate_many``, the writer's side,
stays a pool of Python threads over ``zlib.compress`` (its outputs are
small).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import typing as t
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..utils.native import PKG, build_host_library

MAX_THREADS = 32
_SRC = PKG / "csrc" / "inflate_pool.cpp"
_lock = threading.Lock()
_native: tuple[ctypes.CDLL, int] | None = None


def _threads(n_items: int) -> int:
    return max(1, min(MAX_THREADS, os.cpu_count() or 1, n_items))


def _pool() -> tuple[ctypes.CDLL, int]:
    """The library and its pool of ``min(32, cpu_count)`` threads, built and
    started at the first call. Raises RuntimeError when either fails."""
    global _native
    with _lock:
        if _native is None:
            try:
                lib = ctypes.CDLL(str(build_host_library(_SRC)))
            except (OSError, subprocess.CalledProcessError) as e:
                detail = getattr(e, "stderr", b"") or b""
                raise RuntimeError(f"the inflate pool ({_SRC.name}) did not build or load: "
                                   f"{e} {detail.decode(errors='replace')}") from e
            lib.inflate_pool_create.restype = ctypes.c_void_p
            lib.inflate_pool_create.argtypes = [ctypes.c_int]
            lib.inflate_pool_run.restype = ctypes.c_int
            lib.inflate_pool_run.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_size_t),
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_int,
            ]
            pool = lib.inflate_pool_create(_threads(MAX_THREADS))
            if not pool:
                raise RuntimeError("the inflate pool found no libz.so.1 to load")
            _native = (lib, pool)
        return _native


def inflate_many(srcs: t.Sequence[bytes], dsts: t.Sequence[np.ndarray]) -> None:
    """Inflate zlib stream ``srcs[i]`` into the C-contiguous ``dsts[i]``, in
    parallel. Raises ValueError on a corrupt stream or a size other than the
    destination's."""
    if len(srcs) != len(dsts):
        raise ValueError(f"{len(srcs)} streams for {len(dsts)} destinations")
    for d in dsts:
        if not d.flags["C_CONTIGUOUS"] or not d.flags["WRITEABLE"]:
            raise ValueError("destinations must be C-contiguous and writable")
    n = len(srcs)
    if not n:
        return
    lib, pool = _pool()
    src_arr = (ctypes.c_char_p * n)(*srcs)  # the bytes objects stay alive in srcs
    src_lens = (ctypes.c_size_t * n)(*(len(s) for s in srcs))
    dst_arr = (ctypes.c_void_p * n)(*(d.ctypes.data for d in dsts))
    dst_lens = (ctypes.c_size_t * n)(*(d.nbytes for d in dsts))
    rc = lib.inflate_pool_run(pool, src_arr, src_lens, dst_arr, dst_lens, n)
    if rc:
        raise ValueError(f"inflate failed for chunk {rc - 1}: a corrupt stream, or not "
                         f"{dsts[rc - 1].nbytes} bytes")


def deflate_many(srcs: t.Sequence[bytes], level: int) -> list[bytes]:
    """zlib streams of ``srcs`` at ``level`` (HDF5's deflate filter), from a
    pool of threads (``zlib.compress`` releases the interpreter lock)."""
    out: list[bytes] = [b""] * len(srcs)
    k = _threads(len(srcs))

    def worker(start: int) -> None:
        for i in range(start, len(srcs), k):
            out[i] = zlib.compress(srcs[i], level)

    with ThreadPoolExecutor(k) as pool:
        for fut in [pool.submit(worker, s) for s in range(k)]:
            fut.result()
    return out
