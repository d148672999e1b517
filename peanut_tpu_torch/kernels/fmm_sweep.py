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

Both kernels, and the fused first-order solve (``fmm_fused``), solve
each grid with a thread-block cluster of C blocks: the second-order kernel
gives each block a segment of the columns, the first-order ones (whose row
scans need whole rows) a segment of each row block's rows.  ``sweep_plan``
picks C and the segments from the shape and how many clusters the card
holds at once; the wrappers query that count (``resident_clusters``) and
hand the plan to the kernel.  A block holds its SM alone
(``csrc/fmm_common.cuh::reserved_smem``).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Mapping, Optional, Tuple

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


# 16 needs the non-portable opt-in; 6 because 16 clusters of 8 do not all
# fit on an H100 at once (15), and 16 of 6 do (17)
CLUSTER_SIZES = (16, 8, 6, 4, 2, 1)
MIN_SEG = 16          # the plan splits a row no finer than this
SMEM_LIMIT = 231424   # 227 KB a block, less 1 KB for static shared memory
MAX_W1 = 2048         # order 1 (and B1) scans lines of at most 64 chunks
VSCAN_COLS = 16       # columns the fused solve stages for its column scans
# past 1024 cells a pair of warps scans a fused solve's column: the 8 pairs'
# exchanges (1024 floats each) beside the staged columns
PAIR_EXCHANGE_BYTES = 8 * 1024 * 4


@dataclass(frozen=True)
class SweepPlan:
    """How a sweep kernel splits each grid over a cluster of ``cluster``
    blocks.  Order 2 splits the columns: block q owns the columns
    [q * seg, q * seg + widths[q]).  Order 1 splits each row block's rows:
    block q owns its rows [q * seg, q * seg + widths[q]) (of a full row
    block; a ragged last one leaves the later blocks fewer or none).
    ``smem_bytes`` of dynamic shared memory a block (a fused solve's plan
    is order 1's split with the layout of ``csrc/fmm_fused.cu``)."""
    order: int
    cluster: int
    seg: int
    widths: Tuple[int, ...]
    smem_bytes: int


def _scan_pitches(w: int) -> Tuple[int, int]:
    """The first-order kernel's scan layout: P (w rounded up to 32) and K2
    (the power of two >= P / 32)."""
    p = -(-w // 32) * 32
    k2 = 1
    while 32 * k2 < p:
        k2 *= 2
    return p, k2


def smem_bytes(order: int, w: int, block: int, seg: int,
               fused: Optional[Tuple[int, int]] = None) -> int:
    """A block's dynamic shared memory: the ``Layout`` of
    ``csrc/fmm_sweep.cu`` (order 1, ``seg`` rows), the buffers of
    ``csrc/fmm_sweep2.cu`` (order 2, ``seg`` columns), or with ``fused``
    (H, scan_chunk) the ``Layout`` of ``csrc/fmm_fused.cu``: ``seg`` rows,
    up to scan_chunk ghost rows a side and their receive buffers, or the
    column scans' staging, whichever is larger.  Order 1's wall bits take
    a word a 32-cell chunk, at least 32 words a row."""
    if order == 2:
        return 2 * (block + 4) * seg * 4 + 2 * block * seg
    if fused is not None:
        h, chunk = fused
        ghosts = min(chunk, block)            # a side
        g = min(block, seg + 2 * ghosts)
        rows = (2 * g * w + 4 * ghosts * w + 2 * w) * 4 + g * w
        cols = VSCAN_COLS * (h + 1) * 5
        if h > 1024:                          # the warp pairs' exchanges
            cols += PAIR_EXCHANGE_BYTES
        return max(rows, cols)
    p, k2 = _scan_pitches(w)
    return ((2 * seg * w + 2 * w + 4 * seg * k2 * 33) * 4
            + seg * max(32, k2) * 4 + 2 * seg * p * 2 + seg * w)


def _layout(order: int, w: int, block: int, cluster: int,
            fused: Optional[Tuple[int, int]] = None) -> Optional[SweepPlan]:
    """The plan for ``cluster`` blocks, or None where it cannot run: a
    block left without columns (rows, order 1), a segment narrower than
    order 2's two halo columns, or more shared memory than a block has
    (``sweep_plan`` turns away order-1 lines over MAX_W1 cells first)."""
    n = block if order == 1 else w        # what the blocks split
    seg = -(-n // cluster)
    if -(-n // seg) != cluster or (order == 2 and cluster > 1 and seg < 2):
        return None
    smem = smem_bytes(order, w, block, seg, fused)
    if smem > SMEM_LIMIT:
        return None
    widths = tuple(min(seg, n - q * seg) for q in range(cluster))
    return SweepPlan(order, cluster, seg, widths, smem)


def sweep_plan(order: int, b: int, w: int, block: int,
               resident: Mapping[int, int],
               cluster: Optional[int] = None,
               fused: Optional[Tuple[int, int]] = None) -> SweepPlan:
    """Cluster size and segments (``SweepPlan``) for ``b`` grids of rows
    ``w`` cells wide in ``block``-row blocks; with ``fused`` (H,
    scan_chunk), for the fused first-order solve of (b, H, w) grids
    (``csrc/fmm_fused.cu``: order 1's row split, its own layout).

    resident[C]: clusters of C blocks the card holds at once at that
    layout (``resident_clusters``).  The plan takes the largest C with
    ceil(w / C) >= MIN_SEG (so C = 1 for rows under 2 x MIN_SEG cells, too
    little work to spread) whose layout fits and whose ``b`` clusters are
    all resident; if none is, the smallest C that fits, since the grids
    then queue anyway.  ``cluster`` forces C.
    """
    if order not in (1, 2) or (fused is not None and order != 1):
        raise ValueError(f"order 1 or 2 (1 for a fused solve), got {order}")
    if w < 1 or block < order:
        raise ValueError(f"rows of >= 1 cells and blocks of >= {order} "
                         f"rows, got w={w}, block={block}")
    if fused is not None and (fused[0] < 1 or fused[1] < 1):
        raise ValueError(f"a fused solve of >= 1 rows and a scan_chunk "
                         f">= 1, got (H, scan_chunk) = {fused}")
    line = max(w, fused[0] if fused else 0)
    if order == 1 and line > MAX_W1:
        raise ValueError(f"order-1 kernels scan lines (rows, and a fused "
                         f"solve's columns) of at most {MAX_W1} cells, "
                         f"got {line}")
    if cluster is not None:
        plan = (_layout(order, w, block, cluster, fused)
                if cluster in CLUSTER_SIZES else None)
        if plan is None:
            raise ValueError(f"order {order} cannot split rows of {w} "
                             f"cells in {block}-row blocks over {cluster} "
                             f"blocks (a block without rows or columns, or "
                             f"past its shared memory)")
        return plan
    plans = [p for p in (_layout(order, w, block, c, fused)
                         for c in CLUSTER_SIZES
                         if c == 1 or -(-w // c) >= MIN_SEG) if p]
    if not plans:
        raise ValueError(f"rows of {w} cells in {block}-row blocks exceed "
                         f"the order-{order} kernel's shared memory "
                         f"({SMEM_LIMIT} bytes a block) at every cluster "
                         f"size")
    for p in plans:
        if b <= resident.get(p.cluster, 0):
            return p
    return plans[-1]


@functools.lru_cache(maxsize=None)
def _resident(order: int, w: int, block: int, cluster: int, device: int,
              fused: Optional[Tuple[int, int]] = None) -> int:
    plan = _layout(order, w, block, cluster, fused)
    if plan is None:
        return 0
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        if fused is not None:
            from .fmm_fused import _lib as lib_fused
            err = lib_fused().fused_eikonal_max_clusters(
                fused[0], w, block, plan.seg, fused[1], cluster,
                ctypes.byref(out))
        elif order == 1:
            err = _lib1().block_sweep_max_clusters(
                w, plan.seg, cluster, ctypes.byref(out))
        else:
            err = _lib2().block_sweep2_max_clusters(
                plan.seg, block, cluster, ctypes.byref(out))
    # a size the card does not take (16 without the opt-in) holds none
    return out.value if err == 0 else 0


def resident_clusters(order: int, w: int, block: int, device=None,
                      fused: Optional[Tuple[int, int]] = None) -> dict:
    """{C: clusters of C blocks the card holds at once}, queried with
    cudaOccupancyMaxActiveClusters on the kernel at each C's layout."""
    dev = torch.device(device if device is not None else "cuda")
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return {c: _resident(order, w, block, c, idx, fused)
            for c in CLUSTER_SIZES}


def launch_plan(order: int, d: torch.Tensor, block: int,
                cluster: Optional[int] = None,
                fused_chunk: Optional[int] = None) -> SweepPlan:
    """The plan the wrapper launches for CUDA grids ``d`` (B, H, W); with
    ``fused_chunk`` (its scan_chunk), for a fused solve of them."""
    bsz, h, w = d.shape
    fused = None if fused_chunk is None else (h, fused_chunk)
    return sweep_plan(order, bsz, w, block,
                      resident_clusters(order, w, block, d.device, fused),
                      cluster, fused)


def cluster_barrier_us(cluster: int, grids: int = 1, n: int = 20000,
                       device=None) -> float:
    """Microseconds of one cluster barrier on the card: a kernel of
    ``grids`` clusters of ``cluster`` sweep-sized blocks that runs nothing
    but ``n`` barriers, timed with CUDA events against one of ``n // 2``
    (the difference leaves the launch out).  What a sweep's chain of
    barriers costs at the least."""
    lib = _lib2()
    lib.cluster_barrier_loop.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    with torch.cuda.device(device if device is not None else "cuda"):
        stream = torch.cuda.current_stream().cuda_stream

        def ms(k: int) -> float:
            times = []
            for _ in range(2):      # the first call warms up
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                check(lib.cluster_barrier_loop(grids, cluster, k, stream),
                      "cluster_barrier_loop launch")
                b.record()
                torch.cuda.synchronize()
                times.append(a.elapsed_time(b))
            return times[-1]
        return (ms(n) - ms(n // 2)) / (n - n // 2) * 1e3


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
        lib.block_sweep_launch.argtypes = [p, p, p] + [i] * 9 + [p]
        lib.block_sweep_launch.restype = i
        lib.block_sweep_smem_bytes.argtypes = [i, i]
        lib.block_sweep_smem_bytes.restype = ctypes.c_size_t
        lib.block_sweep_max_clusters.argtypes = [i] * 3 + [p]
        lib.block_sweep_max_clusters.restype = i
        lib._typed = True
    return lib


def block_sweep(d: torch.Tensor, wall: torch.Tensor, reverse: bool = False,
                block: int = 16, inner: int = 40, scan_chunk: int = 1,
                cluster: Optional[int] = None) -> torch.Tensor:
    """One directed first-order sweep of CUDA (B, H, W) grids, one kernel
    launch (``block_sweep.launches`` counts them) with ``launch_plan``'s
    cluster size unless ``cluster`` forces one.  d: float32; wall: bool or
    uint8.  Returns a new field."""
    _check_grids("block_sweep", d, wall)
    if block < 1 or inner < 0 or scan_chunk < 1 or inner % scan_chunk:
        raise ValueError(f"block >= 1, inner >= 0 and a scan_chunk >= 1 "
                         f"that divides inner, got block={block}, "
                         f"inner={inner}, scan_chunk={scan_chunk}")
    bsz, h, w = d.shape
    plan = launch_plan(1, d, block, cluster)
    d_in = d.contiguous()
    wl = wall.to(torch.uint8).contiguous()
    out = torch.empty_like(d_in)
    if bsz and h:
        with torch.cuda.device(d.device):
            stream = torch.cuda.current_stream().cuda_stream
            check(_lib1().block_sweep_launch(
                d_in.data_ptr(), wl.data_ptr(), out.data_ptr(), bsz, h, w,
                block, inner, scan_chunk, int(reverse), plan.cluster,
                plan.seg, stream), "block_sweep launch")
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
        lib.block_sweep2_launch.argtypes = [p, p, p, p] + [i] * 8 + [p]
        lib.block_sweep2_launch.restype = i
        lib.block_sweep2_smem_bytes.argtypes = [i, i]
        lib.block_sweep2_smem_bytes.restype = ctypes.c_size_t
        lib.block_sweep2_max_clusters.argtypes = [i] * 3 + [p]
        lib.block_sweep2_max_clusters.restype = i
        lib._typed = True
    return lib


def block_sweep2(d: torch.Tensor, wall: torch.Tensor, src: torch.Tensor,
                 reverse: bool = False, block: int = 16, inner: int = 40,
                 cluster: Optional[int] = None) -> torch.Tensor:
    """One directed second-order sweep of CUDA (B, H, W) grids, one kernel
    launch (``block_sweep2.launches`` counts them) with ``launch_plan``'s
    cluster size unless ``cluster`` forces one.  d: float32; wall, src:
    bool or uint8.  Returns a new field."""
    _check_grids("block_sweep2", d, wall, src)
    if block < 2 or inner < 0:
        raise ValueError("block >= 2 and inner >= 0")
    bsz, h, w = d.shape
    plan = launch_plan(2, d, block, cluster)
    d_in = d.contiguous()
    wl = wall.to(torch.uint8).contiguous()
    sr = src.to(torch.uint8).contiguous()
    out = torch.empty_like(d_in)
    if bsz and h:
        with torch.cuda.device(d.device):
            stream = torch.cuda.current_stream().cuda_stream
            check(_lib2().block_sweep2_launch(
                d_in.data_ptr(), wl.data_ptr(), sr.data_ptr(), out.data_ptr(),
                bsz, h, w, block, inner, int(reverse), plan.cluster,
                plan.seg, stream), "block_sweep2 launch")
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
