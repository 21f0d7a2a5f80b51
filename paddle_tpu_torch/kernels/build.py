"""Build the port's CUDA sources at first use and load them with ctypes.

Each `csrc/*.cu` file has a plain C interface and is compiled on its own
by `nvcc` into a shared library under `build/paddle_tpu_torch/` at the
repository root, named by a hash of the source text, the `csrc/` headers
it includes and the flags, so a changed source or header rebuilds and an
unchanged one loads at once. `build()` starts one `nvcc` per missing
library, all at the same time, and waits for every one; processes that
build at the same time take turns (a file lock in the build directory),
so the later ones load what the first built. Nothing is compiled when a
module is imported.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "library_path", "build",
           "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "paddle_tpu_torch build on a machine with the CUDA "
                       "toolkit")


def library_path(source: str) -> Path:
    """Where `csrc/<source>` builds to: keyed by its text, the text of the
    `csrc/` headers it includes (`#include "..."`) and the flags."""
    text = (CSRC / source).read_bytes()
    for header in re.findall(rb'^#include "([^"]+)"', text, re.M):
        text += (CSRC / header.decode()).read_bytes()
    key = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{key[:16]}.so"


def build(sources: Iterable[str]) -> Dict[str, float]:
    """Compile every source whose library is missing, one `nvcc` each,
    all started together. Returns {source: build seconds} (0.0 for a
    library already built). The compiler's report (registers, spills)
    is kept beside each library as `<library>.log`. Raises RuntimeError
    with the compiler output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = list(sources)
    secs: Dict[str, float] = {src: 0.0 for src in sources
                              if library_path(src).exists()}
    if len(secs) == len(sources):
        return secs
    # one builder at a time across processes (worker processes starting
    # together): the others wait here, then find the libraries built
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        _build_missing([s for s in sources if s not in secs], secs)
    return secs


def _build_missing(sources, secs: Dict[str, float]) -> None:
    running = []
    try:
        for src in sources:
            so = library_path(src)
            if so.exists():
                secs[src] = 0.0
                continue
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running.append((src, proc, tmp, so, time.perf_counter()))
        while running:
            src, proc, tmp, so, t0 = running.pop(0)
            log, _ = proc.communicate()
            secs[src] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src} "
                                   f"(exit {proc.returncode}):\n{log}")
            so.with_name(so.name + ".log").write_text(log)
            os.replace(tmp, so)
    finally:
        for _, proc, tmp, _, _ in running:
            proc.kill()
            proc.wait()
            tmp.unlink(missing_ok=True)


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<source>`, building it if needed."""
    lib = _LIBS.get(source)
    if lib is None:
        build([source])
        lib = ctypes.CDLL(str(library_path(source)))
        _LIBS[source] = lib
    return lib
