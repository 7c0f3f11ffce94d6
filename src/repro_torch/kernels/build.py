"""Builds a kernel's CUDA C++ source with nvcc and loads it with ctypes.

Every hand-written kernel of the port is one `csrc/*.cu` file with a
plain C interface.  `build_library` compiles it for sm_90a at first use
into `build/repro_torch/` at the repository root (gitignored), in a
shared library named by a hash of the source and the nvcc flags, and
loads it; a later call with the same source and flags reuses the file.
Each kernel passes its own extra flags (the sweep kernel turns
multiply-add contraction off).
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class KernelBuild:
    """A built and loaded kernel library."""
    lib: ctypes.CDLL
    path: Path
    seconds: float       # nvcc wall time; 0.0 when the library was cached
    log: str             # nvcc's output (the -Xptxas -v register lines)


def nvcc() -> str:
    """Path of nvcc (PATH, then $CUDA_HOME/bin, then /usr/local/cuda)."""
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the port's "
                       "CUDA kernels cannot be built")


def build_library(name: str, extra_flags: tuple[str, ...] = ()
                  ) -> KernelBuild:
    """Compile `csrc/<name>.cu` (once per source and flag hash) and load
    it.  Concurrent builders of the same library agree: each writes a
    private temporary file and renames it into place."""
    source = CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + tuple(extra_flags)
    tag = hashlib.sha256(source.read_bytes()
                         + " ".join(flags).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"{name}_{tag}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"({proc.returncode}):\n{log}")
        os.replace(tmp, path)
    return KernelBuild(lib=ctypes.CDLL(str(path)), path=path,
                       seconds=seconds, log=log)
