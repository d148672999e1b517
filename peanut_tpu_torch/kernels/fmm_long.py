"""Long-line instantiations of the eikonal kernels (``csrc/fmm_long.cu``).

``fmm_sweep.block_sweep``, ``block_sweep2`` and ``fmm_fused.fused_eikonal``
launch these where their launch plan is ``long``: order-1 lines (a fused
solve's rows or columns) over ``fmm_sweep.MAX_W1`` cells and rows that no
cluster size holds in shared memory.  They compute the same functions as
the shared-memory kernels, bit for bit equal to the same plain versions
(``fmm_sweep.block_sweep_reference``, ``block_sweep2_reference``,
``fmm_fused.fused_eikonal_reference``), with the row block's buffers in
global memory (scratch allocated here).  Each wrapper counts its launches
in its own ``launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import check, library


def _lib():
    lib = library("fmm_long")
    if not getattr(lib, "_typed", False):
        p, i, z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        lib.long_max_clusters.argtypes = [i, p]
        lib.long_max_clusters.restype = i
        lib.block_sweep_long_floats.argtypes = [i, i]
        lib.block_sweep_long_floats.restype = z
        lib.block_sweep2_long_floats.argtypes = [i, i]
        lib.block_sweep2_long_floats.restype = z
        lib.fused_eikonal_long_floats.argtypes = [i] * 4
        lib.fused_eikonal_long_floats.restype = z
        lib.block_sweep_long_launch.argtypes = [p] * 4 + [i] * 8 + [p]
        lib.block_sweep_long_launch.restype = i
        lib.block_sweep2_long_launch.argtypes = [p] * 5 + [i] * 7 + [p]
        lib.block_sweep2_long_launch.restype = i
        lib.fused_eikonal_long_launch.argtypes = [p] * 5 + [i] * 9 + [p]
        lib.fused_eikonal_long_launch.restype = i
        lib._typed = True
    return lib


def _scratch(floats_a_grid: int, bsz: int, device) -> torch.Tensor:
    return torch.empty(bsz * floats_a_grid, dtype=torch.float32,
                       device=device)


def block_sweep_long(d: torch.Tensor, wall: torch.Tensor, reverse: bool,
                     block: int, inner: int, scan_chunk: int,
                     cluster: int) -> torch.Tensor:
    """``fmm_sweep.block_sweep`` on a long plan of ``cluster`` blocks a
    grid (the caller has checked the arguments)."""
    bsz, h, w = d.shape
    d_in = d.contiguous()
    wl = wall.to(torch.uint8).contiguous()
    out = torch.empty_like(d_in)
    if bsz and h:
        lib = _lib()
        scratch = _scratch(lib.block_sweep_long_floats(w, block), bsz,
                           d.device)
        with torch.cuda.device(d.device):
            stream = torch.cuda.current_stream().cuda_stream
            check(lib.block_sweep_long_launch(
                d_in.data_ptr(), wl.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), bsz, h, w, block, inner, scan_chunk,
                int(reverse), cluster, stream), "block_sweep_long launch")
        block_sweep_long.launches += 1
    return out


block_sweep_long.launches = 0


def block_sweep2_long(d: torch.Tensor, wall: torch.Tensor,
                      src: torch.Tensor, reverse: bool, block: int,
                      inner: int, cluster: int) -> torch.Tensor:
    """``fmm_sweep.block_sweep2`` on a long plan of ``cluster`` blocks a
    grid (the caller has checked the arguments)."""
    bsz, h, w = d.shape
    d_in = d.contiguous()
    wl = wall.to(torch.uint8).contiguous()
    sr = src.to(torch.uint8).contiguous()
    out = torch.empty_like(d_in)
    if bsz and h:
        lib = _lib()
        scratch = _scratch(lib.block_sweep2_long_floats(w, block), bsz,
                           d.device)
        with torch.cuda.device(d.device):
            stream = torch.cuda.current_stream().cuda_stream
            check(lib.block_sweep2_long_launch(
                d_in.data_ptr(), wl.data_ptr(), sr.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), bsz, h, w, block, inner,
                int(reverse), cluster, stream), "block_sweep2_long launch")
        block_sweep2_long.launches += 1
    return out


block_sweep2_long.launches = 0


def fused_eikonal_long(trav: torch.Tensor, src: torch.Tensor, rounds: int,
                       block: int, inner: int, scan_chunk: int, vscan: bool,
                       cluster: int) -> torch.Tensor:
    """``fmm_fused.fused_eikonal`` on a long plan of ``cluster`` blocks a
    grid: uint8 (B, H, W) traversible and sources -> float32 distances."""
    bsz, h, w = trav.shape
    out = torch.empty((bsz, h, w), dtype=torch.float32, device=trav.device)
    if bsz:
        lib = _lib()
        scratch = _scratch(lib.fused_eikonal_long_floats(h, w, block,
                                                         int(vscan)),
                           bsz, trav.device)
        walls = torch.empty_like(trav)
        with torch.cuda.device(trav.device):
            stream = torch.cuda.current_stream().cuda_stream
            check(lib.fused_eikonal_long_launch(
                trav.data_ptr(), src.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), walls.data_ptr(), bsz, h, w, rounds,
                block, inner, scan_chunk, int(vscan), cluster, stream),
                "fused_eikonal_long launch")
        fused_eikonal_long.launches += 1
    return out


fused_eikonal_long.launches = 0
