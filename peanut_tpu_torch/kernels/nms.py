"""The keep set of greedy NMS from a suppression matrix.

``nms_keep`` launches the CUDA kernel ``csrc/nms_greedy.cu`` for a CUDA
tensor and runs ``nms_keep_reference``, its plain PyTorch version, for a
CPU tensor.  The plain version is the JAX package's solve
(``peanut_tpu.models.boxes.nms_fixed``): bounding rounds
``U' = valid & !(L @ S)``, ``L' = valid & !(U' @ S)`` until ``L == U``.
Run eagerly, each convergence check is a host sync; the kernel walks the
boxes in order on the device and never stops the host.  Both give the
unique greedy solution, so they agree bit for bit.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ._build import check, library

MAX_SMEM = 48 * 1024  # the kernel's shared memory without opting in
# a convergence check costs a host sync; the fixed point is stable once
# reached, so checking every few rounds changes nothing but the syncs
_CHECK_EVERY = 4
# detect chunks launch from the runtime's env-step threads: count under a lock
_count_lock = threading.Lock()


def nms_keep_reference(sup: torch.Tensor, valid: torch.Tensor
                       ) -> torch.Tensor:
    """Plain version: the bounding pair L (confirmed keeps) and U
    (possible keeps), iterated until they meet or n rounds."""
    n = sup.shape[-1]
    supf = sup.float()
    validf = valid.float()
    low = torch.zeros_like(validf)
    up = validf
    it = 0
    while it < n:
        for _ in range(min(_CHECK_EVERY, n - it)):
            up = validf * (1.0 - torch.sign(
                torch.matmul(low[..., None, :], supf)[..., 0, :]))
            low = validf * (1.0 - torch.sign(
                torch.matmul(up[..., None, :], supf)[..., 0, :]))
            it += 1
        if not bool((low != up).any()):
            break
    return up > 0


def _lib():
    lib = library("nms_greedy")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nms_greedy_launch.argtypes = [p, p, p, i, i, p]
        lib.nms_greedy_launch.restype = i
        lib.nms_greedy_smem_bytes.argtypes = [i]
        lib.nms_greedy_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def nms_keep(sup: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Greedy keep set of boxes in score order.

    Args:
      sup: (..., n, n) bool, ``sup[i, j]``: box i (scored higher, i < j)
        overlaps box j past the threshold; strictly upper triangular.
      valid: (..., n) bool, the boxes that take part.

    Returns:
      (..., n) bool, ``keep[j] = valid[j] & !any_i(keep[i] & sup[i, j])``.

    CPU tensor: the plain version.  CUDA tensor: one launch of the kernel
    (``nms_keep.launches`` counts them); no fallback.
    """
    if not sup.is_cuda:
        return nms_keep_reference(sup, valid)
    n = sup.shape[-1]
    lead = sup.shape[:-2]
    if sup.shape[-2] != n or tuple(valid.shape) != tuple(lead) + (n,):
        raise ValueError(f"sup {tuple(sup.shape)} and valid "
                         f"{tuple(valid.shape)} do not match")
    if sup.dtype != torch.bool or valid.dtype != torch.bool:
        raise ValueError("sup and valid must be bool")
    if not valid.is_cuda or valid.device != sup.device:
        raise ValueError("sup and valid must be on the same device")
    lib = _lib()
    if lib.nms_greedy_smem_bytes(n) > MAX_SMEM:
        raise ValueError(f"{n} boxes exceed the kernel's shared memory")
    sup = sup.contiguous()
    valid = valid.contiguous()
    keep = torch.empty(valid.shape, dtype=torch.bool, device=sup.device)
    problems = valid.numel() // n if n else 0
    if problems:
        with torch.cuda.device(sup.device):
            stream = torch.cuda.current_stream().cuda_stream
            check(lib.nms_greedy_launch(sup.data_ptr(), valid.data_ptr(),
                                        keep.data_ptr(), problems, n,
                                        stream), "nms_keep launch")
        with _count_lock:
            nms_keep.launches += 1
    return keep


nms_keep.launches = 0
