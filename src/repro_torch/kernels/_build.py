"""Build the port's CUDA sources with ``nvcc`` at first use, and load them.

Each source set compiles into one shared library with a plain C interface
(loaded with ``ctypes``), for Hopper only:
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC``.  Libraries go to ``build/torch_kernels/`` at the root
of the checkout, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads at once.  A missing ``nvcc`` or
a failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else the CUDA toolkit's default."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin/nvcc); "
        "the CUDA kernels of repro_torch need the CUDA toolkit to build"
    )


def library_path(name: str, sources: Sequence[Path]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str, sources: Sequence[Path]) -> Path:
    """Compile ``sources`` into ``build/torch_kernels/<name>-<hash>.so``
    unless that library exists; returns its path.  The compiler's output
    (with ``ptxas``'s register and spill report) is kept beside it as
    ``.log``."""
    out = library_path(name, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed building {name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """Build if needed, then load the library."""
    return ctypes.CDLL(str(build(name, sources)))
