"""Builds a kernel's CUDA C++ source with nvcc and loads it with ctypes.

Every hand-written kernel of the port is one `csrc/*.cu` file with a
plain C interface.  `build_library` compiles it for sm_90a at first use
into `build/repro_torch/` at the repository root (gitignored), in a
shared library named by a hash of the source and the nvcc flags, and
loads it; a later call with the same source and flags reuses the file.
The hash covers every header under `csrc/` that the source includes
(`#include "..."`, followed recursively), so an edited header rebuilds
each library that uses it.  Each kernel passes its own extra flags (the
sweep kernel turns multiply-add contraction off) and its C launchers'
argument types; every launcher returns an int (0, or a CUDA error).
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
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


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def included_files(source: Path) -> list[Path]:
    """`source` and every file it includes with `#include "..."`,
    recursively, resolved beside the including file; each once, the
    source first, then in the order they are first reached."""
    seen, order, todo = set(), [], [source.resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        order.append(path)
        for name in _INCLUDE.findall(path.read_text()):
            todo.append((path.parent / name).resolve())
    return order


def source_tag(source: Path, flags: tuple[str, ...]) -> str:
    """The library's name tag: a hash of the source, the files it
    includes (each with its name) and the nvcc flags."""
    h = hashlib.sha256()
    for path in included_files(source):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build_library(name: str, extra_flags: tuple[str, ...] = (),
                  **launchers: list) -> KernelBuild:
    """Compile `csrc/<name>.cu` (once per source and flag hash) and load
    it, each of `launchers` (C name -> argtypes) bound to return an int.
    Concurrent processes building the same library agree: each writes a
    private temporary file and renames it into place."""
    source = CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + tuple(extra_flags)
    tag = source_tag(source, flags)
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
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in launchers.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return KernelBuild(lib=lib, path=path, seconds=seconds, log=log)
