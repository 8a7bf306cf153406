"""Build the port's CUDA sources into shared libraries with a plain C
interface, at first use, with ``nvcc`` for ``sm_90a``.

A library is named by a digest of its sources and flags, so an edited source
never loads a stale build; the build writes to a temporary name and renames,
so concurrent processes never load a half-written file. The build directory
is ``src/repro_torch/kernels/_build`` (listed in ``.gitignore``).
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class Built(NamedTuple):
    path: Path
    seconds: float  # nvcc wall time; 0.0 when an existing build was reused
    log: str  # nvcc/ptxas output (registers, shared memory, spills)


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def build(name: str, sources) -> Built:
    sources = [Path(s) for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        return Built(out, 0.0, log_path.read_text() if log_path.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {name}:\n{proc.stdout}\n{proc.stderr}")
    log = proc.stdout + proc.stderr
    log_path.write_text(log)
    os.replace(tmp, out)
    return Built(out, seconds, log)
