"""One build of every hand-written kernel: each `csrc/*.cu` is compiled by
its own nvcc for sm_90a, all started together, and one link joins them into
a shared library with plain C entry points, loaded with ctypes. The library
goes under the gitignored `kernels/build/`, at the first launch of any
kernel; importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, Optional

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
_entries: Dict[str, Any] = {}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    library: Path
    seconds: float       # 0.0 when the library was already built
    ptxas: str           # nvcc's -Xptxas -v report (registers, smem, spills)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is not None:
            nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
            "kernels cannot be built")
    return nvcc


def build() -> BuildInfo:
    """Compile the kernel library if these sources and flags have not been
    built yet; returns where it is and what the compiler reported. The
    library name carries a hash of every file under `csrc/` and of the
    flags, so a stale build is never loaded."""
    files = sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
    sources = [p for p in files if p.suffix == ".cu"]
    digest = hashlib.sha256(
        b"".join(p.name.encode() + p.read_bytes() for p in files)
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libkernels_{digest}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return BuildInfo(lib, 0.0, log.read_text() if log.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        reports = [proc.communicate()[0] for proc in procs]
        for src, proc, report in zip(sources, procs, reports):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {src}:\n{report}")
        so = os.path.join(tmp, lib.name)
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", so, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed linking {lib.name}:\n"
                               f"{link.stderr}")
        report = "".join(reports)
        log.write_text(report)
        os.replace(so, lib)  # atomic: no process loads a half-written file
    return BuildInfo(lib, time.perf_counter() - t0, report)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use. Each kernel module
    declares its own entry points' argument types."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build().library))
    return _lib


def entry(name: str, argtypes: list) -> Any:
    """The library's C function `name`, its argument types set and its
    result an int (the launch's cudaError_t)."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn
