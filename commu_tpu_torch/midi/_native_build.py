"""Build the native MIDI parser at first use.

``native/smf_native.cpp`` (a byte-for-byte copy of the JAX package's
parser source) compiles with ``g++`` (or ``$CXX``) into
``commu_tpu_torch/_build/libcommu_smf_<hash>.so``, the hash taken over the
source and the flags: a changed source builds anew, an unchanged one loads
the file an earlier process left.  The library is written under a temporary
name and moved into place with ``os.replace``, so processes that build at
once (test workers, the preprocess pool's spawned workers) each see a whole
file or none.  A failed build raises, naming the compiler's log; nothing
falls back to the Python parser here (``COMMU_TPU_NO_NATIVE=1`` selects it,
``smf._load_native``).

Imports no torch: the preprocess CLI runs without it.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "native" / "smf_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]


def library_path() -> Path:
    """Where the library of this source and these flags lies."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libcommu_smf_{digest.hexdigest()[:16]}.so"


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("the native MIDI parser needs a C++ compiler (g++ or "
                           "$CXX); set COMMU_TPU_NO_NATIVE=1 for the Python parser")
    return cxx


def build() -> Path:
    """The library's path, compiled first if no process has built it."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    log = target.with_suffix(f".{os.getpid()}.log")
    cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native MIDI parser failed "
                           f"({proc.returncode}); the compiler's log: {log}")
    os.replace(tmp, target)  # atomic: a concurrent process sees all or nothing
    log.unlink()
    return target
