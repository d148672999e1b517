"""Whole first-order eikonal solve in one kernel launch (port of
``peanut_tpu.kernels.fmm_fused``).

``fused_eikonal`` launches the CUDA kernel ``csrc/fmm_fused.cu`` for a CUDA
tensor and runs ``fused_eikonal_reference``, its plain PyTorch version, for
a CPU tensor.  The schedule is the TPU kernel's: ``rounds`` times
{ optional column min-plus scans (``vscan``); a down pass and an up pass
over ``block``-row blocks }, each block relaxed by ``inner`` Jacobi Godunov
passes with both row scans every ``scan_chunk`` passes.  No transposed
sweeps: the row-sequential down/up passes give vertical coverage, and
``rounds`` compensates (fmm.py's round mapping).

On the card the kernel and the plain version agree bit for bit (the kernel
keeps the plain version's operation order and scan association; see the
note at the top of the source).  The kernel solves each grid with a
thread-block cluster; ``fmm_sweep.launch_plan`` picks its size.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._build import check, library
from .fmm import BIG, _seg_scan_1d, _v_sweep
from .fmm_sweep import launch_plan


def fused_eikonal_reference(traversible: torch.Tensor, sources: torch.Tensor,
                            rounds: int = 3, block: int = 8, inner: int = 24,
                            scan_chunk: int = 4,
                            vscan: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, H, W) traversible/sources ->
    float32 distances, +inf at walls and unreachable cells.

    A down pass is fmm._v_sweep forward (carried top row; the next block's
    first row as it stands, which no block has touched yet in this pass),
    an up pass fmm._v_sweep reverse on its result."""
    trav = traversible > 0
    src = sources > 0
    wall = ~trav & ~src
    d = torch.where(src, 0.0, BIG).float()
    for _ in range(rounds):
        if vscan:
            d = _seg_scan_1d(d, wall, reverse=False, dim=-2)
            d = _seg_scan_1d(d, wall, reverse=True, dim=-2)
        d = _v_sweep(d, wall, False, block, inner, scan_chunk)
        d = _v_sweep(d, wall, True, block, inner, scan_chunk)
    return torch.where(d >= 0.5 * BIG, torch.inf, d)


def _lib():
    lib = library("fmm_fused")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_eikonal_launch.argtypes = [p, p, p] + [i] * 11 + [p]
        lib.fused_eikonal_launch.restype = i
        lib.fused_eikonal_smem_bytes.argtypes = [i] * 5
        lib.fused_eikonal_smem_bytes.restype = ctypes.c_size_t
        lib.fused_eikonal_max_clusters.argtypes = [i] * 6 + [p]
        lib.fused_eikonal_max_clusters.restype = i
        lib._typed = True
    return lib


def fused_eikonal(traversible: torch.Tensor, sources: torch.Tensor,
                  rounds: int = 3, block: int = 8, inner: int = 24,
                  scan_chunk: int = 4, vscan: bool = True,
                  cluster: Optional[int] = None) -> torch.Tensor:
    """Whole FIRST-ORDER eikonal solve: (B, H, W) traversible/sources ->
    float32 distances, +inf at walls/unreachable.  A source on a
    non-traversible cell is still a source.

    CPU tensor: the plain version.  CUDA tensor: one launch of the kernel
    (``fused_eikonal.launches`` counts them) with ``launch_plan``'s cluster
    size unless ``cluster`` forces one; no fallback.  Rows too wide for
    scan_chunk ghost rows a side in a block's shared memory (over ~1600
    cells at block 8, scan_chunk 4) run with fewer (the plan's ``ghosts``);
    grids over 4096 cells wide or tall (a long plan) launch
    ``fmm_long.fused_eikonal_long`` instead."""
    if not traversible.is_cuda:
        return fused_eikonal_reference(traversible, sources, rounds=rounds,
                                       block=block, inner=inner,
                                       scan_chunk=scan_chunk, vscan=vscan)
    if traversible.ndim != 3 or sources.shape != traversible.shape:
        raise ValueError(f"fused_eikonal takes (B, H, W) grids, got "
                         f"{tuple(traversible.shape)} / "
                         f"{tuple(sources.shape)}")
    if not sources.is_cuda or sources.device != traversible.device:
        raise ValueError("traversible and sources must be on one device")
    if scan_chunk < 1 or block < 1 or inner < 0 or rounds < 0:
        raise ValueError("block, scan_chunk >= 1 and rounds, inner >= 0")
    bsz, h, w = traversible.shape
    plan = launch_plan(1, traversible, block, cluster, fused_chunk=scan_chunk)
    trav = (traversible > 0).to(torch.uint8).contiguous()
    src = (sources > 0).to(torch.uint8).contiguous()
    if plan.long:
        from .fmm_long import fused_eikonal_long
        return fused_eikonal_long(trav, src, rounds, block, inner,
                                  scan_chunk, vscan, plan.cluster)
    out = torch.empty((bsz, h, w), dtype=torch.float32,
                      device=traversible.device)
    if bsz:
        with torch.cuda.device(traversible.device):
            stream = torch.cuda.current_stream().cuda_stream
            check(_lib().fused_eikonal_launch(
                trav.data_ptr(), src.data_ptr(), out.data_ptr(), bsz, h, w,
                rounds, block, inner, scan_chunk, int(vscan), plan.cluster,
                plan.seg, plan.ghosts, stream), "fused_eikonal launch")
        fused_eikonal.launches += 1
    return out


fused_eikonal.launches = 0
