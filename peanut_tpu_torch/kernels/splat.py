"""Trilinear voxel splatting (scatter-add) and its band-collapsed fast twin.

Port of ``peanut_tpu.kernels.splat`` (PEANUT depth_utils.py:198-252).  The
exact path accumulates each of the 2^d corners with ``scatter_add_`` and
rounds the accumulator to integers after every corner pass, as PEANUT does.
On the CPU the scatter runs in point order, like XLA's; on CUDA it uses
atomics, so sums can differ in the last bit before each rounding.
"""

from __future__ import annotations

import itertools

import torch


def splat_projected_2d(feat: torch.Tensor, coords: torch.Tensor, vr: int,
                       nz: int, min_z: int, max_z: int, chunk: int = 1200):
    """Scatter-free voxel splat, pre-collapsed over height bands.

    out[c, y, x] = sum_p feat[c, p] * wz[p] * Wy[p, y] * Wx[p, x], with the
    z axis folded into per-point masses (agent-height band and all heights)
    and the bilinear hat weights against a cell iota, index 0 excluded as in
    the exact path.  No per-corner rounding.

    feat: (B, C, P); coords: (B, 3, P) normalized [-1, 1].
    Returns (band_proj, total_proj), each (B, C, vr, vr) indexed [y, x].
    """
    b, c, p = feat.shape
    pos_x = coords[:, 0, :] * (vr / 2.0) + vr / 2.0
    pos_y = coords[:, 1, :] * (vr / 2.0) + vr / 2.0
    pos_z = coords[:, 2, :] * (nz / 2.0) + nz / 2.0

    z0 = torch.floor(pos_z)
    w_band = torch.zeros_like(pos_z)
    w_total = torch.zeros_like(pos_z)
    for ix in (0.0, 1.0):
        zi = z0 + ix
        w = (1.0 - torch.abs(pos_z - zi)) * ((zi > 0) & (zi < nz))
        w_total = w_total + w
        w_band = w_band + w * ((zi >= min_z) & (zi < max_z))

    cells = torch.arange(vr, dtype=feat.dtype, device=feat.device)
    valid_cell = cells > 0

    def hat(pos):                                     # (B, K) -> (B, K, vr)
        w = 1.0 - torch.abs(pos[..., None] - cells)
        return torch.clamp(w, min=0.0) * valid_cell

    band = feat.new_zeros((b, c, vr, vr))
    total = feat.new_zeros((b, c, vr, vr))
    for k0 in range(0, p, chunk):
        sl = slice(k0, k0 + chunk)
        fk = feat[:, :, sl]                               # (B, C, K)
        wy = hat(pos_y[:, sl])                            # (B, K, vr)
        wx = hat(pos_x[:, sl])
        for acc, wz in ((band, w_band[:, sl]), (total, w_total[:, sl])):
            fz = fk * wz[:, None, :]                      # (B, C, K)
            zcx = fz[:, :, None, :] * wx.transpose(1, 2)[:, None]  # (B,C,x,K)
            acc += torch.matmul(zcx, wy[:, None])         # (B, C, x, y)
    # [dim0 cell, dim1 cell] -> the exact path's voxels.transpose(2, 3)
    return band.transpose(2, 3), total.transpose(2, 3)


def splat_feat_nd(init_grid: torch.Tensor, feat: torch.Tensor,
                  coords: torch.Tensor, exact: bool = True) -> torch.Tensor:
    """Splat features into an n-D grid.

    init_grid: (B, F, *grid_dims); feat: (B, F, nPt); coords: (B, nDims, nPt)
    normalized to [-1, 1].  ``exact`` rounds after every corner pass.
    Returns a new (B, F, *grid_dims) grid.
    """
    grid_dims = init_grid.shape[2:]
    b, f = init_grid.shape[0], init_grid.shape[1]
    n_dims = len(grid_dims)

    pos_dim, wts_dim = [], []
    for d in range(n_dims):
        pos = coords[:, d, :] * (grid_dims[d] / 2.0) + grid_dims[d] / 2.0
        pos_d, wts_d = [], []
        for ix in (0, 1):
            pos_ix = torch.floor(pos) + ix
            # PEANUT excludes index 0 (pos_ix > 0), not >= 0
            safe = ((pos_ix > 0) & (pos_ix < grid_dims[d])).to(pos.dtype)
            wts_d.append((1.0 - torch.abs(pos - pos_ix)) * safe)
            pos_d.append(pos_ix * safe)
        pos_dim.append(pos_d)
        wts_dim.append(wts_d)

    flat = init_grid.reshape(b, f, -1).clone()
    for ix_d in itertools.product(*([(0, 1)] * n_dims)):
        wts = torch.ones_like(wts_dim[0][0])
        index = torch.zeros_like(wts_dim[0][0])
        for d in range(n_dims):
            index = index * grid_dims[d] + pos_dim[d][ix_d[d]]
            wts = wts * wts_dim[d][ix_d[d]]
        idx = index.long()[:, None, :].expand(b, f, -1)
        flat.scatter_add_(2, idx, feat * wts[:, None, :])   # in place
        if exact:
            flat.round_()                                   # in place
    return flat.reshape(init_grid.shape)
