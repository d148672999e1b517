"""Per-ROI window pooling for ROIAlign (port of
``peanut_tpu.kernels.roi_window``).

``roi_window_pool`` launches the CUDA kernel ``csrc/roi_window.cu`` for a
CUDA tensor and runs ``roi_window_pool_reference``, its plain PyTorch
version, for a CPU tensor.  Per ROI it returns ``A_y @ W @ A_x^T`` over the
ROI's ``win_y x win_x`` window ``W`` of the stacked pyramid buffer, not
divided by the sample count (the caller divides).  ``A_y`` is rounded to the
feature dtype (bf16 when serving) before it meets ``W``; ``A_x`` and every
sum stay float32, as in the TPU kernel and the JAX gather path.

Unlike the TPU kernel, window cells outside the buffer read as zero, so the
buffer needs no padded copy and the origin no alignment.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ._build import check, library

MAX_SMEM = 232448   # shared memory one block may use on the H100
# detect chunks launch from the runtime's env-step threads: count under a lock
_count_lock = threading.Lock()


def roi_window_pool_reference(flat: torch.Tensor, ay: torch.Tensor,
                              ax: torch.Tensor, row0: torch.Tensor,
                              col0: torch.Tensor, win_y: int,
                              win_x: int) -> torch.Tensor:
    """Plain PyTorch version: gather each ROI's window (zero outside the
    buffer), then the two contractions.  The bf16 operands are exact in
    float32, so contracting in float32 is bf16 x bf16 with float32 sums."""
    hs, ws, c = flat.shape
    n, p, _ = ay.shape
    dev = flat.device
    out = torch.empty((n, p, p, c), dtype=torch.float32, device=dev)
    ay_r = ay.to(flat.dtype).float()
    ry = torch.arange(win_y, device=dev)
    rx = torch.arange(win_x, device=dev)
    step = max(1, (1 << 26) // max(win_y * win_x * c, 1))
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        rows = row0[lo:hi].long()[:, None] + ry
        cols = col0[lo:hi].long()[:, None] + rx
        inside = (((rows >= 0) & (rows < hs))[:, :, None]
                  & ((cols >= 0) & (cols < ws))[:, None, :])
        win = flat[rows.clamp(0, hs - 1)[:, :, None],
                   cols.clamp(0, ws - 1)[:, None, :]].float()
        win = torch.where(inside[..., None], win, 0.0)
        t = torch.einsum("npr,nrwc->npwc", ay_r[lo:hi], win)
        out[lo:hi] = torch.einsum("nqw,npwc->npqc", ax[lo:hi].float(), t)
    return out


def _lib():
    lib = library("roi_window")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.roi_window_pool_launch.argtypes = \
            [p, i, p, p, p, p, p] + [i] * 7 + [p]
        lib.roi_window_pool_launch.restype = i
        lib.roi_window_smem_bytes.argtypes = [i, i, i, i]
        lib.roi_window_smem_bytes.restype = ctypes.c_size_t
        lib.roi_window_supports_p.argtypes = [i]
        lib.roi_window_supports_p.restype = i
        lib._typed = True
    return lib


def roi_window_pool(flat: torch.Tensor, ay: torch.Tensor, ax: torch.Tensor,
                    row0: torch.Tensor, col0: torch.Tensor, win_y: int,
                    win_x: int) -> torch.Tensor:
    """Pooled (undivided) features for n ROIs.

    Args:
      flat: (Hs, Ws, C) stacked pyramid, float32 or bfloat16.
      ay: (n, p, win_y), ax: (n, p, win_x) float32 hat matrices
        (roi_align.py::hat_matrix), slot-masked, not divided by the count.
      row0, col0: (n,) window origins in ``flat`` (any integers: cells
        outside the buffer read as zero).

    Returns:
      (n, p, p, C) float32 ``A_y @ W @ A_x^T`` per ROI.

    CPU tensor: the plain version.  CUDA tensor: one launch of the kernel
    (``roi_window_pool.launches`` counts them); no fallback.
    """
    if not flat.is_cuda:
        return roi_window_pool_reference(flat, ay, ax, row0, col0, win_y,
                                         win_x)
    n, p, wy = ay.shape
    hs, ws, c = flat.shape
    if wy != win_y or tuple(ax.shape) != (n, p, win_x):
        raise ValueError(f"hat matrices {tuple(ay.shape)} / "
                         f"{tuple(ax.shape)} do not match the window "
                         f"{win_y}x{win_x}")
    if flat.dtype not in (torch.float32, torch.bfloat16) or c % 8:
        raise ValueError(f"flat must be float32 or bfloat16 with C a "
                         f"multiple of 8, got {flat.dtype}, C={c}")
    if not all(t.is_cuda and t.device == flat.device
               for t in (ay, ax, row0, col0)):
        raise ValueError("all inputs must be on the buffer's device")
    lib = _lib()
    is_bf16 = int(flat.dtype == torch.bfloat16)
    if not lib.roi_window_supports_p(p):
        raise ValueError(f"pooled size {p} is not built (7, 14)")
    if lib.roi_window_smem_bytes(is_bf16, p, win_y, win_x) > MAX_SMEM:
        raise ValueError(f"window {win_y}x{win_x} exceeds shared memory")
    flat = flat.contiguous()
    if flat.data_ptr() % 16:
        raise ValueError("flat must start on a 16-byte boundary (cp.async)")
    ay = ay.float().contiguous()
    ax = ax.float().contiguous()
    row0 = row0.to(torch.int32).contiguous()
    col0 = col0.to(torch.int32).contiguous()
    out = torch.empty((n, p, p, c), dtype=torch.float32, device=flat.device)
    if n:
        with torch.cuda.device(flat.device):
            stream = torch.cuda.current_stream().cuda_stream
            check(lib.roi_window_pool_launch(
                flat.data_ptr(), is_bf16, ay.data_ptr(), ax.data_ptr(),
                row0.data_ptr(), col0.data_ptr(), out.data_ptr(), n, p, hs,
                ws, c, win_y, win_x, stream), "roi_window_pool launch")
        with _count_lock:
            roi_window_pool.launches += 1
    return out


roi_window_pool.launches = 0
