"""Block-ELL × dense SpMM: the hand-written CUDA kernel and its plain version.

X[rb*bm:(rb+1)*bm, :] = Σ_{s < n_tiles[rb], col_tile[rb, s] >= 0}
                        blocks[rb, s] @ H[col_tile[rb, s]*bk : +bk, :]

accumulated in float32. The CUDA kernel (`csrc/bcsr_spmm.cu`, which says
what bounds it and how its design answers) replaces the TPU kernel
`repro.kernels.bcsr_spmm.bcsr_spmm_pallas`. It is compiled with nvcc for
sm_90a into a shared library with a plain C entry point at first use, from
the source in this package, and loaded with ctypes.

`bcsr_spmm_blocks` dispatches on where its tensors lie: CPU tensors take the
plain PyTorch version, CUDA tensors launch the kernel or raise.
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
from typing import Optional

import torch

SOURCE = Path(__file__).with_name("csrc") / "bcsr_spmm.cu"
BUILD_DIR = Path(__file__).with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches made by `bcsr_spmm_cuda` in this process. Callers that
# need to show a path ran through the kernel reset it and read it back.
LAUNCHES = 0

_BRICK_DTYPES = (torch.float32, torch.float16)
_MAX_THREADS = 1024
_MAX_SMEM = 227 * 1024
_ROWS_PER_THREAD = 8   # must match ROWS_PER_THREAD in the CUDA source

_lib: Optional[ctypes.CDLL] = None


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
            "nvcc not found (neither on PATH nor under CUDA_HOME): the "
            "bcsr_spmm CUDA kernel cannot be built")
    return nvcc


def build() -> BuildInfo:
    """Compile the kernel library if this source and these flags have not
    been built yet; returns where it is and what the compiler reported.
    The library name carries a hash of both, so a stale build is never
    loaded."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libbcsr_spmm_{digest}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return BuildInfo(lib, 0.0, log.read_text() if log.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed building {SOURCE}:\n{proc.stderr}")
    report = proc.stdout + proc.stderr
    log.write_text(report)
    os.replace(tmp, lib)  # atomic: no process loads a half-written file
    return BuildInfo(lib, seconds, report)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().library))
        fn = lib.bcsr_spmm_launch
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 4 + [ctypes.c_int64]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(blocks, col_tile, n_tiles, h, bm, bk) -> None:
    if blocks.dim() != 4 or tuple(blocks.shape[2:]) != (bm, bk):
        raise ValueError(f"blocks must be (n_rb, ell_w, {bm}, {bk}), "
                         f"got {tuple(blocks.shape)}")
    n_rb, ell_w = blocks.shape[:2]
    if tuple(col_tile.shape) != (n_rb, ell_w):
        raise ValueError(f"col_tile must be {(n_rb, ell_w)}, "
                         f"got {tuple(col_tile.shape)}")
    if tuple(n_tiles.shape) != (n_rb,):
        raise ValueError(f"n_tiles must be ({n_rb},), "
                         f"got {tuple(n_tiles.shape)}")
    if h.dim() != 2:
        raise ValueError(f"h must be 2-D, got {tuple(h.shape)}")
    if blocks.dtype not in _BRICK_DTYPES or h.dtype not in _BRICK_DTYPES:
        raise TypeError(f"blocks and h must be float32 or float16, got "
                        f"{blocks.dtype} and {h.dtype}")
    if col_tile.dtype != torch.int32 or n_tiles.dtype != torch.int32:
        raise TypeError("col_tile and n_tiles must be int32")
    devices = {t.device for t in (blocks, col_tile, n_tiles, h)}
    if len(devices) != 1:
        raise ValueError(f"all operands must lie on one device, got {devices}")


def bcsr_spmm_plain(blocks: torch.Tensor, col_tile: torch.Tensor,
                    n_tiles: torch.Tensor, h: torch.Tensor, *,
                    bm: int, bk: int) -> torch.Tensor:
    """The plain PyTorch version of the kernel: for each slot s, gather the
    referenced H tile of every row block and add its batched product.

    Tiles past the end of H, invalid slots and negative ids read a zero
    tile appended to H, so the result matches the kernel's bound checks.
    Returns (n_rb*bm, F) float32.
    """
    _check(blocks, col_tile, n_tiles, h, bm, bk)
    n_rb, ell_w = blocks.shape[:2]
    k, f = h.shape
    n_ct = -(-k // bk)
    h_tiles = torch.zeros(((n_ct + 1) * bk, f), dtype=torch.float32,
                          device=h.device)
    h_tiles[:k] = h
    h_tiles = h_tiles.view(n_ct + 1, bk, f)
    out = torch.zeros((n_rb, bm, f), dtype=torch.float32, device=h.device)
    valid = ((torch.arange(ell_w, device=h.device)[None, :]
              < n_tiles[:, None].long())
             & (col_tile >= 0) & (col_tile < n_ct))
    tile = torch.where(valid, col_tile.long(), n_ct)
    for s in range(ell_w):
        out += torch.bmm(blocks[:, s].to(torch.float32), h_tiles[tile[:, s]])
    return out.view(n_rb * bm, f)


def _feature_tile(f: int, bm: int) -> int:
    """Columns per thread block: 128, or fewer for narrow H or tall bricks
    (one thread per column, ceil(bm / 8) threads per column)."""
    row_groups = -(-bm // _ROWS_PER_THREAD)
    bn = 128 if f >= 128 else max(32, -(-f // 32) * 32)
    while bn > 32 and bn * row_groups > _MAX_THREADS:
        bn //= 2
    if bn * row_groups > _MAX_THREADS:
        raise ValueError(f"bm={bm} needs more than {_MAX_THREADS} threads "
                         "per block")
    return bn


def bcsr_spmm_cuda(blocks: torch.Tensor, col_tile: torch.Tensor,
                   n_tiles: torch.Tensor, h: torch.Tensor, *,
                   bm: int, bk: int) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (no synchronise).
    Returns (n_rb*bm, F) float32; raises on any operand the kernel does not
    take."""
    global LAUNCHES
    _check(blocks, col_tile, n_tiles, h, bm, bk)
    if h.device.type != "cuda":
        raise ValueError(f"bcsr_spmm_cuda needs CUDA tensors, got {h.device}")
    for name, t in (("blocks", blocks), ("col_tile", col_tile),
                    ("n_tiles", n_tiles), ("h", h)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bm * bk * 4 > _MAX_SMEM:
        raise ValueError(f"a {bm}x{bk} brick exceeds the shared memory a "
                         "block can use")
    n_rb, ell_w = blocks.shape[:2]
    k, f = h.shape
    out = torch.empty((n_rb * bm, f), dtype=torch.float32, device=h.device)
    if out.numel() == 0:
        return out
    bn = _feature_tile(f, bm)
    fn = _library().bcsr_spmm_launch
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(blocks.data_ptr(), col_tile.data_ptr(), n_tiles.data_ptr(),
                 h.data_ptr(), out.data_ptr(), n_rb, ell_w, bm, bk, k, f, bn,
                 int(blocks.dtype == torch.float16),
                 int(h.dtype == torch.float16), stream)
    if err != 0:
        raise RuntimeError(f"bcsr_spmm kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def bcsr_spmm_blocks(blocks: torch.Tensor, col_tile: torch.Tensor,
                     n_tiles: torch.Tensor, h: torch.Tensor, *,
                     bm: int, bk: int) -> torch.Tensor:
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if h.device.type == "cpu":
        return bcsr_spmm_plain(blocks, col_tile, n_tiles, h, bm=bm, bk=bk)
    return bcsr_spmm_cuda(blocks, col_tile, n_tiles, h, bm=bm, bk=bk)
