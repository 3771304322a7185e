"""Build the package's host C++ sources (``csrc/*.cpp``) into shared
libraries: g++ at first use, into the git-ignored ``_build/`` beside the
package, under a name keyed on a hash of the source."""
from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "_build"


def build_host_library(src: Path) -> Path:
    """The library of ``src``, compiled unless it is already built. Raises
    ``subprocess.CalledProcessError`` (or ``FileNotFoundError`` without
    g++) when it cannot be built."""
    lib = BUILD_DIR / f"lib{src.stem}-{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(src)],
                       check=True, capture_output=True)
        os.replace(tmp, lib)  # atomic: a process building it at once sees all or nothing
    return lib
