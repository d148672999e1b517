"""Geodesic distance fields — fast-sweeping eikonal solver (torch port of
``peanut_tpu.kernels.fmm``).

Replaces PEANUT's ``skfmm.distance`` (nav/agent/agent_state.py:391,
nav/agent/utils/fmm_planner.py:64,72) with a blocked fast-sweeping method:

  * horizontal propagation: segmented min-plus scans along rows (walls act
    as (BIG, BIG) elements that block propagation);
  * vertical propagation: row blocks processed in sweep order, each relaxed
    by Jacobi Godunov passes against its boundary rows;
  * second order: directed block sweeps of the order-selecting Godunov
    update over 1- and 2-away neighbours, run from scratch and min-combined
    with the first-order field.

Two schedules, as in the JAX package (``_eikonal_impl(fused=...)``):

  * ``"composed"``: per-sweep first-order pipeline in four orientations —
    the JAX package's CPU path, and the port's on the CPU;
  * ``"fused"``: the whole first-order phase in one call of
    ``fmm_fused.fused_eikonal`` (down/up passes, no transposed sweeps) — the
    JAX package's TPU path, and the port's default for a 3-D CUDA tensor.

Both run the order-2 refinement through ``fmm_sweep.block_sweep2``.  On a
CUDA tensor every sweep is a hand-written kernel (``plain=True`` runs the
plain PyTorch versions there instead); the composed first-order sweep and
2-D inputs need the first-order sweep kernel, which is not ported yet
(ROADMAP B4), so on CUDA they raise.  On the CPU the plain versions run.

Semantics mirror skfmm on a masked array: walls (non-traversible, non-source
cells) and unreachable cells come back +inf; ``masked_fill_unreachable``
reproduces ``ma.filled(dd, max(dd) + 1)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device

BIG = 1.0e10
# float32 values of the divide-free constants of _axis_ab / _godunov2 (as
# Python floats, so torch.where keeps float32)
INV_15 = float(np.float32(2.0 / 3.0))
INV_A_BOTH15 = float(np.float32(1.0 / 4.5))
INV_A_ONE15 = float(np.float32(1.0 / 3.25))


def _wall_big(wall: torch.Tensor) -> torch.Tensor:
    """BIG at walls, 0 elsewhere: ``min(x + _wall_big(w), BIG)`` is
    ``where(w, BIG, x)`` for 0 <= x <= BIG, with plain float ops (cheaper
    than bool selects on the CPU) and the same numbers."""
    return wall.float() * BIG


class _RowScan:
    """Segmented min-plus scans along the last axis for one wall layout.

    Each cell is an affine-min map f(v) = min(b, v + a) — walls (BIG, BIG),
    others (1, d), cells beyond the ends (0, BIG); composition
    (a1,b1)∘(a2,b2) = (a1+a2, min(b2, b1+a2)) is associative, so
    x[i] = min(d[i], x[i-1] + 1) runs as a Hillis-Steele scan of log2(n)
    shift steps — the association of the TPU kernels
    (fmm_pallas.py::_seg_scan_lr), which the CUDA kernel repeats, so the two
    agree bit for bit.  The a-halves of the steps depend on the walls alone
    and are computed once: a block relaxation scans its rows
    inner/scan_chunk times.
    """

    def __init__(self, wall: torch.Tensor):
        self.wb = _wall_big(wall)
        n = wall.shape[-1]
        shifts = [1 << k for k in range(max(n - 1, 0).bit_length())]
        self.b = torch.empty_like(self.wb)
        self.steps = {}
        for reverse in (False, True):
            a = torch.clamp(self.wb + 1.0, max=BIG)
            steps = []
            for s in shifts:
                # (b cells updated, b cells read, a of the updated cells)
                if not reverse:
                    steps.append((self.b[..., s:], self.b[..., :-s],
                                  a[..., s:].clone()))
                    a[..., s:] = torch.clamp(a[..., :-s] + a[..., s:],
                                             max=BIG)
                else:
                    steps.append((self.b[..., :-s], self.b[..., s:],
                                  a[..., :-s].clone()))
                    a[..., :-s] = torch.clamp(a[..., s:] + a[..., :-s],
                                              max=BIG)
            self.steps[reverse] = steps

    def __call__(self, d: torch.Tensor, reverse: bool) -> torch.Tensor:
        torch.clamp(d + self.wb, max=BIG, out=self.b)
        for dst, src, a in self.steps[reverse]:
            # the sum is taken before dst is written: a Jacobi step
            torch.minimum(dst, src + a, out=dst)
        return torch.minimum(d, self.b)


def _seg_scan_1d(d: torch.Tensor, wall: torch.Tensor, reverse: bool,
                 dim: int = -1) -> torch.Tensor:
    """Segmented x[i] = min(d[i], x[i-1] + 1) along ``dim`` (x[i+1] for
    ``reverse``), walls blocking propagation (see _RowScan)."""
    scan = _RowScan(wall.movedim(dim, -1))
    return scan(d.movedim(dim, -1), reverse).movedim(-1, dim)


def _fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, computed in float64 (the product
    of two float32 is exact there).  XLA's CPU backend contracts the
    multiply-adds of the Godunov updates into FMAs; doing the same keeps the
    plain version bit-equal to the JAX package's CPU path, and the CUDA
    kernels repeat this arithmetic."""
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b.double() + c).float()


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (torch's vectorized float32
    sqrt on the CPU is not; XLA's and CUDA's sqrtf are)."""
    return torch.sqrt(x.double()).float()


def _godunov(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Upwind quadratic solve for |grad d| = 1 given axis minima a, b."""
    diff = a - b
    direct = torch.minimum(a, b) + 1.0
    disc = _sqrt(torch.clamp(_fma(-diff, diff, 2.0), min=0.0))
    both = 0.5 * (a + b + disc)
    return torch.where(torch.abs(diff) >= 1.0, direct, both)


def _padded(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """x inside a BIG frame of ``rows`` rows and ``cols`` columns a side."""
    out = torch.full(x.shape[:-2] + (x.shape[-2] + 2 * rows,
                                     x.shape[-1] + 2 * cols), BIG,
                     dtype=x.dtype, device=x.device)
    out[..., rows:out.shape[-2] - rows, cols:out.shape[-1] - cols] = x
    return out


class _Stencil:
    """Jacobi Godunov passes over the interior of a 1-framed buffer P (the
    frame holds the boundary rows, BIG at the side columns); the neighbour
    views are made once."""

    def __init__(self, P: torch.Tensor, wb: torch.Tensor):
        self.cur = P[..., 1:-1, 1:-1]
        self.up, self.down = P[..., :-2, 1:-1], P[..., 2:, 1:-1]
        self.left, self.right = P[..., 1:-1, :-2], P[..., 1:-1, 2:]
        self.wb = wb

    def __call__(self) -> torch.Tensor:
        cand = _godunov(torch.minimum(self.up, self.down),
                        torch.minimum(self.left, self.right))
        return torch.clamp(torch.minimum(self.cur, cand) + self.wb, max=BIG)


def _jacobi_pass(d: torch.Tensor, wall: torch.Tensor) -> torch.Tensor:
    """One elementwise Godunov relaxation over the full grid."""
    return _Stencil(_padded(d, 1, 1), _wall_big(wall))()


def _block_jacobi(blk, wall, top, bottom, inner: int, scan_chunk: int = 1):
    """Relax a row block to its local fixed point given boundary rows.

    blk: (..., R, W); top/bottom: (..., W) rows outside the block.  Each of
    ``inner // scan_chunk`` rounds runs both row scans, then ``scan_chunk``
    Jacobi stencil passes (every pass reads the previous pass's block).
    """
    P = _padded(blk, 1, 1)
    P[..., 0, 1:-1] = top
    P[..., -1, 1:-1] = bottom
    scan = _RowScan(wall)
    stencil = _Stencil(P, scan.wb)
    cur = stencil.cur
    for _ in range(inner // scan_chunk):
        cur.copy_(scan(scan(cur, False), True))
        for _ in range(scan_chunk):
            cur.copy_(stencil())
    return cur.clone()


def _pad_rows(x: torch.Tensor, pad_h: int, value) -> torch.Tensor:
    if not pad_h:
        return x
    fill = torch.full(x.shape[:-2] + (pad_h, x.shape[-1]), value,
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, fill], dim=-2)


def _v_sweep(d, wall, reverse: bool, block: int = 16, inner: int = 40,
             scan_chunk: int = 1):
    """Blocked sequential row sweep (the FSM core).

    Row blocks are processed in sweep order, each relaxed against the
    already-updated previous block (carried boundary row) and the stale
    first row of the next block; rows are padded with walls to a multiple
    of ``block`` (padding is inert).
    """
    h = d.shape[-2]
    pad_h = (-h) % block
    d = _pad_rows(d, pad_h, BIG)
    wall = _pad_rows(wall, pad_h, True)
    nb = d.shape[-2] // block
    big_row = torch.full(d.shape[:-2] + (d.shape[-1],), BIG, dtype=d.dtype,
                         device=d.device)
    out = [None] * nb
    carry = big_row
    order = range(nb - 1, -1, -1) if reverse else range(nb)
    for k in order:
        rows = slice(k * block, (k + 1) * block)
        if not reverse:
            far = d[..., (k + 1) * block, :] if k + 1 < nb else big_row
            top, bottom = carry, far
        else:
            far = d[..., k * block - 1, :] if k > 0 else big_row
            top, bottom = far, carry
        blk = _block_jacobi(d[..., rows, :], wall[..., rows, :], top, bottom,
                            inner, scan_chunk)
        out[k] = blk
        carry = blk[..., -1, :] if not reverse else blk[..., 0, :]
    return torch.cat(out, dim=-2)[..., :h, :]


def _axis_relax(d, wall):
    d = _seg_scan_1d(d, wall, reverse=False)
    d = _seg_scan_1d(d, wall, reverse=True)
    return _jacobi_pass(d, wall)


# ----------------------------------------------------------------------
# Second-order Godunov upwind (skfmm's default order at PEANUT's call
# sites nav/agent/agent_state.py:391, nav/agent/utils/fmm_planner.py:64,72)
# ----------------------------------------------------------------------

def _axis_ab(u1, u2):
    """Per-axis upwind coefficients for sum_i (alpha_i*u - beta_i)^2 = 1.

    First order: alpha=1, beta=u1.  Second order (2-away value known and
    causally smaller): alpha=3/2, beta=(4*u1 - u2)/2.  Axis excluded
    (alpha=0) when u1 is unknown.  1/alpha is a select between constants,
    so _godunov2 is divide-free.  Returns (alpha, beta, known, inv_alpha,
    order2) with order2 = 1.0 where the second-order stencil is used.
    The selects are float arithmetic that gives the same values (every
    product is by 0 or 1 and every sum exact), cheaper than bool selects.
    """
    known1 = u1 < 0.5 * BIG
    use2 = known1 & (u2 < 0.5 * BIG) & (u2 <= u1)
    k, t = known1.float(), use2.float()
    alpha = k + 0.5 * t
    beta = torch.where(use2, (4.0 * u1 - u2) * 0.5, u1) * k
    inv_alpha = 1.0 + t * (INV_15 - 1.0)
    return alpha, beta, known1, inv_alpha, t


def _godunov2(u1x, u2x, u1y, u2y):
    """Godunov update with per-axis order selection.  If the two-axis root
    violates upwindness on either axis (alpha*u < beta), falls back to the
    better single-axis solution."""
    ax, bx, kx, iax, tx = _axis_ab(u1x, u2x)
    ay, by, ky, iay, ty = _axis_ab(u1y, u2y)
    c1x = torch.where(kx, (1.0 + bx) * iax, BIG)
    c1y = torch.where(ky, (1.0 + by) * iay, BIG)
    one_d = torch.minimum(c1x, c1y)
    A = ax * ax + ay * ay
    B = _fma(ax, bx, ay * by)
    C = _fma(bx, bx, by * by) - 1.0
    disc = _fma(B, B, -(A * C))
    # 1/A by the number of second-order axes: 0 -> 1/2, 1 -> 1/3.25,
    # 2 -> 1/4.5 (only consumed when both axes are known)
    inv_a = torch.tensor([0.5, INV_A_ONE15, INV_A_BOTH15], device=tx.device)
    invA = inv_a[(tx + ty).long()]
    u2d = (B + _sqrt(torch.clamp(disc, min=0.0))) * invA
    ok = (disc >= 0.0) & kx & ky & (ax * u2d >= bx) & (ay * u2d >= by)
    return torch.clamp(torch.where(ok, u2d, one_d), max=BIG)


def _pick_dir(n1, n2, p1, p2):
    """Upwind direction per axis: the smaller 1-away value; on ties the
    direction whose 2-away value is causal and larger (mirror-invariant, so
    flipped sweeps make identical choices)."""
    eff_n = torch.where(n2 <= n1, n2, -BIG)
    eff_p = torch.where(p2 <= p1, p2, -BIG)
    use_n = (n1 < p1) | ((n1 == p1) & (eff_n >= eff_p))
    # the chosen 1-away value is min(n1, p1) either way
    return torch.minimum(n1, p1), torch.where(use_n, n2, p2)


def _order2_block(blk, wall, src, top2, bottom2, inner: int):
    """Relax a row block with second-order assignment updates (Jacobi).

    top2/bottom2: (..., 2, W) context rows outside the block (one side
    already updated this sweep, the other stale)."""
    P = _padded(blk, 2, 2)
    P[..., :2, 2:-2] = top2
    P[..., -2:, 2:-2] = bottom2
    cur = P[..., 2:-2, 2:-2]
    # (1-away, 2-away) views: up, down, left, right
    up = (P[..., 1:-3, 2:-2], P[..., :-4, 2:-2])
    dn = (P[..., 3:-1, 2:-2], P[..., 4:, 2:-2])
    lf = (P[..., 2:-2, 1:-3], P[..., 2:-2, :-4])
    rt = (P[..., 2:-2, 3:-1], P[..., 2:-2, 4:])
    wb = _wall_big(wall)
    keep = (~src).float()          # 0 pins a source to distance 0
    for _ in range(inner):
        u1y, u2y = _pick_dir(*up, *dn)
        u1x, u2x = _pick_dir(*lf, *rt)
        cand = _godunov2(u1x, u2x, u1y, u2y)
        cur.copy_(torch.clamp(torch.minimum(cur, cand) * keep + wb, max=BIG))
    return cur.clone()


def _v_sweep2(d, wall, src, reverse: bool, block: int = 16, inner: int = 40):
    """Blocked sequential row sweep with second-order updates.  Blocks tile
    the rows from row 0 (the ragged block is the last one); the reverse
    sweep processes them bottom-up.  This equals the TPU kernel's reverse
    sweep, which flips rows after padding the bottom."""
    h = d.shape[-2]
    pad_h = (-h) % block
    d = _pad_rows(d, pad_h, BIG)
    wall = _pad_rows(wall, pad_h, True)
    src = _pad_rows(src, pad_h, False)
    nb = d.shape[-2] // block
    big2 = torch.full(d.shape[:-2] + (2, d.shape[-1]), BIG, dtype=d.dtype,
                      device=d.device)
    out = [None] * nb
    carry = big2
    order = range(nb - 1, -1, -1) if reverse else range(nb)
    for k in order:
        rows = slice(k * block, (k + 1) * block)
        if not reverse:
            far = (d[..., (k + 1) * block:(k + 1) * block + 2, :]
                   if k + 1 < nb else big2)
            top2, bottom2 = carry, far
        else:
            far = d[..., k * block - 2:k * block, :] if k > 0 else big2
            top2, bottom2 = far, carry
        blk = _order2_block(d[..., rows, :], wall[..., rows, :],
                            src[..., rows, :], top2, bottom2, inner)
        out[k] = blk
        carry = blk[..., -2:, :] if not reverse else blk[..., 0:2, :]
    return torch.cat(out, dim=-2)[..., :h, :]


def _swap(x: torch.Tensor) -> torch.Tensor:
    """Transposed orientation (columns become rows), contiguous for the
    kernels."""
    return x.transpose(-1, -2).contiguous()


def eikonal_distance(traversible, sources, n_iters: int = 2, block: int = 16,
                     inner: int = 40, order: int = 2, n_iters2: int = 2,
                     scan_chunk: int = 1, schedule: str | None = None,
                     plain: bool = False, device=None) -> torch.Tensor:
    """Geodesic (unit-speed eikonal) distance to source cells.

    Args:
      traversible: (..., H, W) bool/float tensor or array — nonzero =
        passable.
      sources: (..., H, W) — nonzero = distance-0 cells.  A source on a
        non-traversible cell is still a source.
      n_iters, block, inner, order, n_iters2, scan_chunk: as in
        ``peanut_tpu.kernels.fmm.eikonal_distance``.
      schedule: ``"fused"`` or ``"composed"`` (module docstring).  Default:
        ``"fused"`` for a 3-D CUDA tensor, ``"composed"`` otherwise.
      plain: run the plain PyTorch versions of the kernels even on CUDA
        (the yardstick the kernels are held against on the card).
      device: where numpy inputs go (``resolve_device``: the card unless
        ``"cpu"``); tensors stay where they are.

    Returns:
      (..., H, W) float32 distances; +inf at walls and unreachable cells.
    """
    if not isinstance(traversible, torch.Tensor):
        dev = resolve_device(device)
        traversible = torch.as_tensor(np.asarray(traversible), device=dev)
        sources = torch.as_tensor(np.asarray(sources), device=dev)
    trav = traversible > 0
    src = sources > 0
    wall = ~trav & ~src
    cuda = trav.is_cuda
    if schedule is None:
        schedule = "fused" if cuda and trav.ndim == 3 else "composed"
    if schedule not in ("fused", "composed"):
        raise ValueError(f"unknown schedule {schedule!r}")
    kernels = cuda and not plain
    if kernels and (schedule == "composed" or trav.ndim != 3):
        raise NotImplementedError(
            "on CUDA the composed schedule and 2-D / >3-D grids need the "
            "first-order block-sweep kernel (ROADMAP B4, not ported yet); "
            "pass a (B, H, W) grid with schedule='fused'")

    if schedule == "fused":
        from .fmm_fused import fused_eikonal, fused_eikonal_reference

        # Round mapping of fmm.py:438-446: as the order-2 blanket, n_iters
        # rounds without column scans; as the final order-1 answer,
        # 2*n_iters rounds with them.  Amortized scans (chunk 4) unless the
        # caller set an explicit chunk.
        if order >= 2:
            f_rounds, f_vscan = max(n_iters, 2), False
        else:
            f_rounds, f_vscan = 2 * n_iters, True
        f_chunk = scan_chunk if scan_chunk > 1 else (4 if inner % 4 == 0
                                                     else 1)
        first_order = fused_eikonal if kernels else fused_eikonal_reference
        d = first_order(trav, src, rounds=f_rounds, block=block, inner=inner,
                        scan_chunk=f_chunk, vscan=f_vscan)
        d = torch.where(torch.isinf(d), BIG, d)
    else:
        d = torch.where(src, 0.0, BIG).float()
        for _ in range(n_iters):
            d = _axis_relax(d, wall)
            d = _v_sweep(d, wall, False, block, inner, scan_chunk)
            d = _v_sweep(d, wall, True, block, inner, scan_chunk)
            dt, wt = d.transpose(-1, -2), wall.transpose(-1, -2)
            dt = _axis_relax(dt, wt)
            dt = _v_sweep(dt, wt, False, block, inner, scan_chunk)
            dt = _v_sweep(dt, wt, True, block, inner, scan_chunk)
            d = dt.transpose(-1, -2)

    if order >= 2:
        # Refine FROM SCRATCH (sources only) and min-combine: the order-2
        # stencil must not see the first-order field's overestimated
        # 2-away neighbours (fmm.py:464-470).
        from .fmm_sweep import block_sweep2, block_sweep2_reference

        v_sweep2 = block_sweep2 if kernels else block_sweep2_reference

        wt, st = _swap(wall), _swap(src)
        d2 = torch.where(src, 0.0, BIG).float()
        for _ in range(n_iters2):
            d2 = v_sweep2(d2, wall, src, False, block=block, inner=inner)
            d2 = v_sweep2(d2, wall, src, True, block=block, inner=inner)
            dt = _swap(d2)
            dt = v_sweep2(dt, wt, st, False, block=block, inner=inner)
            dt = v_sweep2(dt, wt, st, True, block=block, inner=inner)
            d2 = _swap(dt)
        d = torch.minimum(d, d2)

    return torch.where(d >= 0.5 * BIG, torch.inf, d)


def masked_fill_unreachable(dist: torch.Tensor) -> torch.Tensor:
    """``ma.filled(dd, max(dd) + 1)`` on the solver output: finite cells
    keep their distance; walls/unreachable get the grid's max finite + 1."""
    finite = torch.isfinite(dist)
    max_finite = torch.amax(torch.where(finite, dist, -torch.inf),
                            dim=(-2, -1), keepdim=True)
    return torch.where(finite, dist, max_finite + 1.0)
