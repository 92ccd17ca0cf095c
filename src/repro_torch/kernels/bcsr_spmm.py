"""The Block-ELL kernels: each hand-written CUDA kernel beside its plain
PyTorch version.

SpMM (`csrc/bcsr_spmm.cu`, replaces the TPU kernel
`repro.kernels.bcsr_spmm.bcsr_spmm_pallas`):

    X[rb*bm:(rb+1)*bm, :] = Σ_{s < n_tiles[rb], col_tile[rb, s] >= 0}
                            blocks[rb, s] @ H[col_tile[rb, s]*bk : +bk, :]

accumulated in float32. Fused GCN layer (`csrc/fused_gcn_layer.cu`,
replaces `repro.kernels.bcsr_spmm.fused_gcn_layer_pallas`):

    Y[rb*bm:(rb+1)*bm, :] = relu(X[rb*bm:(rb+1)*bm, :] @ W + b)

in float32, with X kept on chip. Each source says what bounds its kernel
and how its design answers. `kernels.build` compiles them into the one
library every kernel module shares, at first use.

Each kernel has two routes (`SPMM_ROUTES`, `FUSED_ROUTES`), which its C
entry point chooses per launch from the operands and reports back for the
counters. Bricks of up to 8 rows of 8 columns (the plans' 8 x 8 among them)
take the route that skips each brick's all-zero columns: the SpMM's
"zero_skip" and the fused layer's "grouped", which runs the same loop for 8
row blocks at once and reads W once per group. Other shapes take the first
version's loops, "brick_loop" and "row_block".

`bcsr_spmm_blocks` and `fused_gcn_layer_blocks` dispatch on where their
tensors lie: CPU tensors take the plain PyTorch version, CUDA tensors
launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

# `build` is re-exported: callers build the library through this module.
from repro_torch.kernels.build import build, entry  # noqa: F401

# Kernel launches made by `bcsr_spmm_cuda` and `fused_gcn_layer_cuda` in
# this process, in all and by route. Callers that need to show a path ran
# through a kernel reset the counters and read them back.
LAUNCHES = 0
FUSED_LAUNCHES = 0
SPMM_ROUTES = ("zero_skip", "brick_loop")
FUSED_ROUTES = ("grouped", "row_block")
SPMM_ROUTE_LAUNCHES = dict.fromkeys(SPMM_ROUTES, 0)
FUSED_ROUTE_LAUNCHES = dict.fromkeys(FUSED_ROUTES, 0)

# Type codes of the C entry points.
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_MAX_THREADS = 1024
_MAX_SMEM = 227 * 1024
_ROWS_PER_THREAD = 8   # must match ROWS_PER_THREAD in csrc/block_ell.cuh


def _spmm_fn():
    return entry("bcsr_spmm_launch",
                 [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                 + [ctypes.c_int64] + [ctypes.c_int] * 4 + [ctypes.c_void_p,
                                                            ctypes.c_void_p])


def _fused_fn():
    return entry("fused_gcn_layer_launch",
                 [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                 + [ctypes.c_int64] + [ctypes.c_int] * 3 + [ctypes.c_void_p,
                                                            ctypes.c_void_p])


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
    if blocks.dtype not in _DTYPE_CODES or h.dtype not in _DTYPE_CODES:
        raise TypeError(f"blocks and h must be float32, float16 or bfloat16, "
                        f"got {blocks.dtype} and {h.dtype}")
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
    """Columns per thread block of the "brick_loop" route: 128, or fewer for
    narrow H or tall bricks (one thread per column, ceil(bm / 8) threads per
    column)."""
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
    # Scratch of the zero-skipping route: the list of row blocks longer than
    # its first kernel takes, a count, then the row blocks.
    tail = torch.empty((1 + n_rb,), dtype=torch.int32, device=h.device)
    route = ctypes.c_int(-1)
    fn = _spmm_fn()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(blocks.data_ptr(), col_tile.data_ptr(), n_tiles.data_ptr(),
                 h.data_ptr(), out.data_ptr(), tail.data_ptr(), n_rb, ell_w,
                 bm, bk, k, f, _feature_tile(f, bm),
                 _DTYPE_CODES[blocks.dtype], _DTYPE_CODES[h.dtype], stream,
                 ctypes.addressof(route))
    if err != 0:
        raise RuntimeError(f"bcsr_spmm kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    SPMM_ROUTE_LAUNCHES[SPMM_ROUTES[route.value]] += 1
    return out


def bcsr_spmm_blocks(blocks: torch.Tensor, col_tile: torch.Tensor,
                     n_tiles: torch.Tensor, h: torch.Tensor, *,
                     bm: int, bk: int) -> torch.Tensor:
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if h.device.type == "cpu":
        return bcsr_spmm_plain(blocks, col_tile, n_tiles, h, bm=bm, bk=bk)
    return bcsr_spmm_cuda(blocks, col_tile, n_tiles, h, bm=bm, bk=bk)


def _check_fused(blocks, col_tile, n_tiles, h, w, b, bm, bk) -> None:
    _check(blocks, col_tile, n_tiles, h, bm, bk)
    if w.dim() != 2 or w.shape[0] != h.shape[1]:
        raise ValueError(f"w must be ({h.shape[1]}, F_out), "
                         f"got {tuple(w.shape)}")
    if tuple(b.shape) != (w.shape[1],):
        raise ValueError(f"b must be ({w.shape[1]},), got {tuple(b.shape)}")
    for name, t in (("blocks", blocks), ("h", h), ("w", w), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"the fused layer takes float32 only; {name} is "
                            f"{t.dtype}")
    devices = {h.device, w.device, b.device}
    if len(devices) != 1:
        raise ValueError(f"all operands must lie on one device, got {devices}")


def fused_gcn_layer_plain(blocks: torch.Tensor, col_tile: torch.Tensor,
                          n_tiles: torch.Tensor, h: torch.Tensor,
                          w: torch.Tensor, b: torch.Tensor, *,
                          bm: int, bk: int) -> torch.Tensor:
    """The plain PyTorch version of the fused kernel: the plain SpMM, then
    `addmm` and `relu`. Returns (n_rb*bm, F_out) float32."""
    _check_fused(blocks, col_tile, n_tiles, h, w, b, bm, bk)
    x = bcsr_spmm_plain(blocks, col_tile, n_tiles, h, bm=bm, bk=bk)
    return torch.relu(torch.addmm(b, x, w))


def _fused_tile(f: int, f_out: int, bm: int) -> int:
    """Threads per row of the "row_block" route's block (columns per pass):
    a multiple of 32 up to 256, fewer for narrow layers or tall bricks
    (ceil(bm / 8) rows of threads)."""
    row_groups = -(-bm // _ROWS_PER_THREAD)
    bn = min(256, -(-max(f, f_out) // 32) * 32,
             _MAX_THREADS // row_groups // 32 * 32)
    if bn < 32:
        raise ValueError(f"bm={bm} needs more than {_MAX_THREADS} threads "
                         "per block")
    return bn


def fused_gcn_layer_cuda(blocks: torch.Tensor, col_tile: torch.Tensor,
                         n_tiles: torch.Tensor, h: torch.Tensor,
                         w: torch.Tensor, b: torch.Tensor, *,
                         bm: int, bk: int) -> torch.Tensor:
    """Launch the fused CUDA kernel on PyTorch's current stream (no
    synchronise). Returns (n_rb*bm, F_out) float32; raises on any operand
    the kernel does not take."""
    global FUSED_LAUNCHES
    _check_fused(blocks, col_tile, n_tiles, h, w, b, bm, bk)
    if h.device.type != "cuda":
        raise ValueError(f"fused_gcn_layer_cuda needs CUDA tensors, got "
                         f"{h.device}")
    for name, t in (("blocks", blocks), ("col_tile", col_tile),
                    ("n_tiles", n_tiles), ("h", h), ("w", w), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_rb, ell_w = blocks.shape[:2]
    k, f = h.shape
    f_out = w.shape[1]
    # The "row_block" route's X; the "grouped" route, where the kernel
    # takes it, keeps 8 row blocks' X, so it fits only where this does.
    row_groups = -(-bm // _ROWS_PER_THREAD)
    smem = (row_groups * _ROWS_PER_THREAD * f + bm * bk) * 4
    if smem > _MAX_SMEM:
        raise ValueError(f"X ({bm}x{f}) and a {bm}x{bk} brick need {smem} B "
                         "of shared memory, more than a block can use")
    out = torch.empty((n_rb * bm, f_out), dtype=torch.float32,
                      device=h.device)
    if out.numel() == 0:
        return out
    route = ctypes.c_int(-1)
    fn = _fused_fn()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(blocks.data_ptr(), col_tile.data_ptr(), n_tiles.data_ptr(),
                 h.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                 n_rb, ell_w, bm, bk, k, f, f_out, _fused_tile(f, f_out, bm),
                 stream, ctypes.addressof(route))
    if err != 0:
        raise RuntimeError(f"fused_gcn_layer kernel launch failed: CUDA "
                           f"error {err}")
    FUSED_LAUNCHES += 1
    FUSED_ROUTE_LAUNCHES[FUSED_ROUTES[route.value]] += 1
    return out


def fused_gcn_layer_blocks(blocks: torch.Tensor, col_tile: torch.Tensor,
                           n_tiles: torch.Tensor, h: torch.Tensor,
                           w: torch.Tensor, b: torch.Tensor, *,
                           bm: int, bk: int) -> torch.Tensor:
    """The fused kernel for CUDA tensors, its plain version for CPU
    tensors."""
    if h.device.type == "cpu":
        return fused_gcn_layer_plain(blocks, col_tile, n_tiles, h, w, b,
                                     bm=bm, bk=bk)
    return fused_gcn_layer_cuda(blocks, col_tile, n_tiles, h, w, b,
                                bm=bm, bk=bk)
