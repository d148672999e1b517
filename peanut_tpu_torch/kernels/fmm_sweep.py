"""Directed second-order block sweep: the counterpart of
``peanut_tpu.kernels.fmm_pallas``.

``block_sweep2`` launches the CUDA kernel ``csrc/fmm_sweep2.cu`` (the port of
``pallas_block_sweep2``); ``block_sweep2_reference`` is its plain PyTorch
version; ``v_sweep2`` has the contract of ``v_sweep2_pallas`` — any
(B, H, W) grid, either direction — and picks one of the two by the tensor's
device.  The first-order sweep ``pallas_block_sweep`` (ROADMAP B4) lands
here when it is ported.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import check, library
from .fmm import _v_sweep2


def block_sweep2_reference(d: torch.Tensor, wall: torch.Tensor,
                           src: torch.Tensor, reverse: bool = False,
                           block: int = 16, inner: int = 40) -> torch.Tensor:
    """Plain PyTorch version of the kernel: fmm._v_sweep2.

    Its reverse sweep processes the row blocks (tiled from row 0) bottom-up
    with mirrored context, which gives the same numbers as the TPU wrapper's
    pad-then-flip (the direction choice of _pick_dir is mirror-invariant)."""
    return _v_sweep2(d, wall, src, reverse, block=block, inner=inner)


def _lib():
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
    if not d.is_cuda:
        raise ValueError("block_sweep2 launches the CUDA kernel; CPU tensors "
                         "go through block_sweep2_reference")
    if d.ndim != 3 or wall.shape != d.shape or src.shape != d.shape:
        raise ValueError(f"block_sweep2 takes (B, H, W) grids, got "
                         f"{tuple(d.shape)}, {tuple(wall.shape)}, "
                         f"{tuple(src.shape)}")
    if d.dtype != torch.float32:
        raise ValueError(f"block_sweep2 takes a float32 field, got {d.dtype}")
    if wall.device != d.device or src.device != d.device:
        raise ValueError("d, wall and src must be on one device")
    if block < 2 or inner < 0:
        raise ValueError("block >= 2 and inner >= 0")
    bsz, h, w = d.shape
    if _lib().block_sweep2_smem_bytes(w, block) > 232448:
        raise ValueError(f"rows of {w} cells with block {block} exceed the "
                         f"kernel's shared memory (227 KB)")
    d_in = d.contiguous()
    wl = wall.to(torch.uint8).contiguous()
    sr = src.to(torch.uint8).contiguous()
    out = torch.empty_like(d_in)
    if bsz:
        with torch.cuda.device(d.device):
            stream = torch.cuda.current_stream().cuda_stream
            check(_lib().block_sweep2_launch(
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
