"""ctypes binding for the native PDB scanner (``csrc/pdbscan.cpp``).

The port's copy of ``timed_design_tpu/structure/_native.py``. The shared
library is compiled with g++ at first use into the package's git-ignored
``_build/``, under a name keyed on a hash of the source, and loaded once.
Without a C++ toolchain ``scan_pdb_native`` returns None and the parser
uses its Python scanner, which gives the same arrays.
"""
from __future__ import annotations

import ctypes
import subprocess
import threading

import numpy as np

from ..utils.native import BUILD_DIR as _BUILD_DIR
from ..utils.native import PKG as _PKG
from ..utils.native import build_host_library

_SRC = _PKG / "csrc" / "pdbscan.cpp"
_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build_host_library(_SRC)))
            lib.pdb_scan.restype = ctypes.c_long
            lib.pdb_scan.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _lib = None
        return _lib


def native_available() -> bool:
    return _load() is not None


def scan_pdb_native(text: str) -> dict[str, np.ndarray] | None:
    """Scan PDB text into parallel field arrays via the C++ scanner.

    Returns None when the native library is unavailable. Keys: coords (A,3)
    f32, bfactors (A,) f32, res_seq (A,) i32, model_idx (A,) i32, atom_name /
    res_name / element (A,) unicode, chain_id / icode / altloc (A,) unicode,
    is_het (A,) bool.
    """
    lib = _load()
    if lib is None:
        return None
    raw = text.encode()
    # generous capacity: every line could be an atom record
    cap = max(raw.count(b"\n") + 1, 1)
    coords = np.empty((cap, 3), np.float32)
    bfactors = np.empty(cap, np.float32)
    res_seq = np.empty(cap, np.int32)
    model_idx = np.empty(cap, np.int32)
    atom_name = np.zeros((cap, 4), dtype="S1")
    res_name = np.zeros((cap, 3), dtype="S1")
    element = np.zeros((cap, 2), dtype="S1")
    chain_id = np.zeros(cap, dtype="S1")
    icode = np.zeros(cap, dtype="S1")
    altloc = np.zeros(cap, dtype="S1")
    is_het = np.zeros(cap, np.uint8)

    n = lib.pdb_scan(
        raw, len(raw), cap,
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        bfactors.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        res_seq.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        model_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        atom_name.ctypes.data_as(ctypes.c_char_p),
        res_name.ctypes.data_as(ctypes.c_char_p),
        element.ctypes.data_as(ctypes.c_char_p),
        chain_id.ctypes.data_as(ctypes.c_char_p),
        icode.ctypes.data_as(ctypes.c_char_p),
        altloc.ctypes.data_as(ctypes.c_char_p),
        is_het.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if n < 0:
        return None

    def _str(arr2d):
        return arr2d[:n].view(f"S{arr2d.shape[1]}")[:, 0].astype("U")

    return {
        "coords": coords[:n],
        "bfactors": bfactors[:n],
        "res_seq": res_seq[:n],
        "model_idx": model_idx[:n],
        "atom_name": _str(atom_name),
        "res_name": _str(res_name),
        "element": _str(element),
        "chain_id": chain_id[:n].astype("U1"),
        "icode": icode[:n].astype("U1"),
        "altloc": altloc[:n].astype("U1"),
        "is_het": is_het[:n].astype(bool),
    }
