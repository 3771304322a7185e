"""Build the package's CUDA sources into shared libraries, load and launch
them.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled with
``nvcc`` for Hopper (``sm_90a``) at first use, into ``_build/`` beside this
package, under a file name keyed on a hash of the source and the flags, and
loaded with ``ctypes``. Nothing is built when the module is imported, and a
failed build raises: there is no fallback for a kernel that did not build.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    Returns the library's path and the compiler's report (registers, shared
    memory and spills from ``-Xptxas -v``; empty when nothing was built).
    """
    lib = library_path(name)
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"cannot build {name}: {cmd[0]} not found") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    return lib, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<name>.cu`` once."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)[0]))
            _libs[name] = lib
        return lib


@functools.cache
def num_sms(device: int) -> int:
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(device: int | None, what: str, call) -> None:
    """``call(num_sms, stream)`` with CUDA ``device`` (None: the current
    one) current, on its current stream; raises on the CUDA error ``call``
    returns."""
    import torch

    index = torch.cuda.current_device() if device is None else device
    if index == torch.cuda.current_device():
        err = call(num_sms(index), torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(index):
            err = call(num_sms(index), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")
