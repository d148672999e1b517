"""Directed block sweeps: the counterpart of ``peanut_tpu.kernels.fmm_pallas``.

First order: ``block_sweep`` launches the CUDA kernel ``csrc/fmm_sweep.cu``
(the port of ``pallas_block_sweep``); ``block_sweep_reference`` is its plain
PyTorch version; ``v_sweep`` has the contract of ``v_sweep_pallas`` and
picks one of the two by the tensor's device.  Second order, the same trio:
``block_sweep2`` (``csrc/fmm_sweep2.cu``, the port of
``pallas_block_sweep2``), ``block_sweep2_reference`` and ``v_sweep2``.  The
dispatchers are what ``fmm.eikonal_distance`` calls for every directed
sweep.  The kernels take any (B, H, W) grid in either direction: rows need
no padding to a multiple of the block and no flip for the reverse sweep.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import check, library
from .fmm import _v_sweep, _v_sweep2


def _check_grids(name: str, d: torch.Tensor, *masks: torch.Tensor) -> None:
    if not d.is_cuda:
        raise ValueError(f"{name} launches the CUDA kernel; CPU tensors go "
                         f"through {name}_reference")
    if d.ndim != 3 or any(m.shape != d.shape for m in masks):
        raise ValueError(f"{name} takes (B, H, W) grids, got "
                         f"{[tuple(t.shape) for t in (d,) + masks]}")
    if d.dtype != torch.float32:
        raise ValueError(f"{name} takes a float32 field, got {d.dtype}")
    if any(m.device != d.device for m in masks):
        raise ValueError("the field and its masks must be on one device")


def block_sweep_reference(d: torch.Tensor, wall: torch.Tensor,
                          reverse: bool = False, block: int = 16,
                          inner: int = 40,
                          scan_chunk: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the first-order kernel: fmm._v_sweep."""
    return _v_sweep(d, wall, reverse, block=block, inner=inner,
                    scan_chunk=scan_chunk)


def _lib1():
    lib = library("fmm_sweep")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.block_sweep_launch.argtypes = [p, p, p] + [i] * 7 + [p]
        lib.block_sweep_launch.restype = i
        lib.block_sweep_smem_bytes.argtypes = [i, i]
        lib.block_sweep_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def block_sweep(d: torch.Tensor, wall: torch.Tensor, reverse: bool = False,
                block: int = 16, inner: int = 40,
                scan_chunk: int = 1) -> torch.Tensor:
    """One directed first-order sweep of CUDA (B, H, W) grids, one kernel
    launch (``block_sweep.launches`` counts them).  d: float32; wall: bool
    or uint8.  Returns a new field."""
    _check_grids("block_sweep", d, wall)
    if block < 1 or inner < 0 or scan_chunk < 1 or inner % scan_chunk:
        raise ValueError(f"block >= 1, inner >= 0 and a scan_chunk >= 1 "
                         f"that divides inner, got block={block}, "
                         f"inner={inner}, scan_chunk={scan_chunk}")
    bsz, h, w = d.shape
    if w > 1024 or _lib1().block_sweep_smem_bytes(w, block) > 232448:
        raise ValueError(f"rows of {w} cells with block {block} exceed the "
                         f"kernel's row width (1024) or shared memory "
                         f"(227 KB)")
    d_in = d.contiguous()
    wl = wall.to(torch.uint8).contiguous()
    out = torch.empty_like(d_in)
    if bsz:
        with torch.cuda.device(d.device):
            stream = torch.cuda.current_stream().cuda_stream
            check(_lib1().block_sweep_launch(
                d_in.data_ptr(), wl.data_ptr(), out.data_ptr(), bsz, h, w,
                block, inner, scan_chunk, int(reverse), stream),
                "block_sweep launch")
        block_sweep.launches += 1
    return out


block_sweep.launches = 0


def v_sweep(d: torch.Tensor, wall: torch.Tensor, reverse: bool,
            block: int = 16, inner: int = 40,
            scan_chunk: int = 1) -> torch.Tensor:
    """Directed first-order sweep with the contract of ``v_sweep_pallas``:
    the kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if d.is_cuda:
        return block_sweep(d, wall, reverse, block=block, inner=inner,
                           scan_chunk=scan_chunk)
    return block_sweep_reference(d, wall, reverse, block=block, inner=inner,
                                 scan_chunk=scan_chunk)


def block_sweep2_reference(d: torch.Tensor, wall: torch.Tensor,
                           src: torch.Tensor, reverse: bool = False,
                           block: int = 16, inner: int = 40) -> torch.Tensor:
    """Plain PyTorch version of the kernel: fmm._v_sweep2.

    Its reverse sweep processes the row blocks (tiled from row 0) bottom-up
    with mirrored context, which gives the same numbers as the TPU wrapper's
    pad-then-flip (the direction choice of _pick_dir is mirror-invariant)."""
    return _v_sweep2(d, wall, src, reverse, block=block, inner=inner)


def _lib2():
    lib = library("fmm_sweep2")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.block_sweep2_launch.argtypes = [p, p, p, p] + [i] * 6 + [p]
        lib.block_sweep2_launch.restype = i
        lib.block_sweep2_smem_bytes.argtypes = [i, i]
        lib.block_sweep2_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def block_sweep2(d: torch.Tensor, wall: torch.Tensor, src: torch.Tensor,
                 reverse: bool = False, block: int = 16,
                 inner: int = 40) -> torch.Tensor:
    """One directed second-order sweep of CUDA (B, H, W) grids, one kernel
    launch (``block_sweep2.launches`` counts them).  d: float32; wall, src:
    bool or uint8.  Returns a new field."""
    _check_grids("block_sweep2", d, wall, src)
    if block < 2 or inner < 0:
        raise ValueError("block >= 2 and inner >= 0")
    bsz, h, w = d.shape
    if _lib2().block_sweep2_smem_bytes(w, block) > 232448:
        raise ValueError(f"rows of {w} cells with block {block} exceed the "
                         f"kernel's shared memory (227 KB)")
    d_in = d.contiguous()
    wl = wall.to(torch.uint8).contiguous()
    sr = src.to(torch.uint8).contiguous()
    out = torch.empty_like(d_in)
    if bsz:
        with torch.cuda.device(d.device):
            stream = torch.cuda.current_stream().cuda_stream
            check(_lib2().block_sweep2_launch(
                d_in.data_ptr(), wl.data_ptr(), sr.data_ptr(), out.data_ptr(),
                bsz, h, w, block, inner, int(reverse), stream),
                "block_sweep2 launch")
        block_sweep2.launches += 1
    return out


block_sweep2.launches = 0


def v_sweep2(d: torch.Tensor, wall: torch.Tensor, src: torch.Tensor,
             reverse: bool, block: int = 16, inner: int = 40) -> torch.Tensor:
    """Directed second-order sweep with the contract of
    ``v_sweep2_pallas``: the kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if d.is_cuda:
        return block_sweep2(d, wall, src, reverse, block=block, inner=inner)
    return block_sweep2_reference(d, wall, src, reverse, block=block,
                                  inner=inner)
