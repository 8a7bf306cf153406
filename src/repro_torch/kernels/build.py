"""Build the port's CUDA sources into shared libraries with a plain C
interface, at first use, with ``nvcc`` for ``sm_90a``.

A library is named by a digest of its sources, the headers they include and
the flags, so an edited source never loads a stale build; the build writes to
a temporary name and renames, so concurrent processes never load a
half-written file. ``build_all`` starts one ``nvcc`` per library at once and
waits for all of them. The build directory is
``src/repro_torch/kernels/_build`` (listed in ``.gitignore``).
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"
HEADERS = tuple(KERNELS_DIR / h for h in ("deposit.cuh", "counter.cuh", "finalize.cuh"))  # shared by the kernels
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


def _target(name: str, sources) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in (*sources, *HEADERS):
        h.update(Path(s).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(libs: dict) -> dict:
    """``{name: [source, ...]}`` -> ``{name: Built}``: every library not
    built yet is compiled by its own ``nvcc``, all started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, {}
    for name, sources in libs.items():
        target = _target(name, sources)
        log_path = target.with_suffix(".log")
        if target.exists():
            out[name] = Built(target, 0.0, log_path.read_text() if log_path.exists() else "")
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running[name] = (proc, target, tmp, time.perf_counter())
    failed = []
    for name, (proc, target, tmp, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed building {name}:\n{log}")
            continue
        target.with_suffix(".log").write_text(log)
        os.replace(tmp, target)
        out[name] = Built(target, seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str, sources) -> Built:
    return build_all({name: list(sources)})[name]
