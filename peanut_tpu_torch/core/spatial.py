"""Row-sharded NCHW maps: the mesh's ``spatial`` axis, the map's height
over devices (the JAX package shards it with ``P(..., "spatial", ...)``
and GSPMD inserts every exchange between the shards; here each one is
written).

One process drives all its spatial shards.  A ``Rows`` holds a map's row
blocks, block i on ``devices[i]``, split by ``mesh.row_ranges`` (uneven
where the rows do not divide, empty where there are fewer rows than
shards).  Every exchange is a tensor copy: ``fetch_rows`` gathers global
rows from whichever blocks hold them, so a convolution's halo may reach
past the neighbouring shard, and autograd carries each copy's gradient
back, a halo row's to the shard that owns the row.  No collective is
needed, so the shards may share a card (``["cuda:0"] * k``) or the CPU.

The sharded ops, each built on ``fetch_rows``:

* ``conv2d``, ``conv2d_same``, ``max_pool2d`` and ``avg_pool2d``: each
  shard computes its output rows from the input rows they reach; the
  padding (zeros, -inf)
  applies only at the map's top and bottom, never at a shard's edge,
  though the op runs with the unsharded one's padding (``_rowwise``);
  flax's "SAME" padding is split from the whole map's height, and so
  are torch's "same" and the rows a reflect, replicate or circular
  padding takes from the whole map (``fetch_padded``);
* ``window``: a sliding window's rows and columns, split again over the
  map's devices;
* ``adaptive_avg_pool``: each shard's columns of the bin matrix times its
  rows, the contributions summed on one device (a global map);
* ``resize``: each shard's output rows of the bilinear matrix times the
  input rows those rows read, of a sharded or a global map;
* ``upsample_nearest2``: the FPN neck's nearest x2, each output row a
  copy of the input row it reads;
* ``dropout``: the global mask drawn from the generator, each shard
  keeping its rows;
* ``bce_mean``: the sum over the shards over the global count.

Parameters are read where they are: a shard on another device than the
parameter gets a differentiable copy (``to``), so the gradients of every
shard's use sum on the parameter itself.  The weight matrices are the
dense ops' (``models.ops``), float32, so a float64 map is resized in
float64 and a bfloat16 one in float32, as there.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import upload
from .mesh import canonical_device, row_ranges


def to(t: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    """``t`` on ``device``: itself where it lies there, else a copy whose
    gradient flows back to ``t``."""
    if t is None or t.device == device:
        return t
    return t.to(device)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class Rows:
    """A row-sharded (N, C, H, W) map: ``blocks[i]`` holds global rows
    ``ranges[i]`` = ``row_ranges(height, len(blocks))[i]`` on its own
    device."""

    def __init__(self, blocks: Sequence[torch.Tensor], height: int):
        self.blocks = list(blocks)
        self.height = int(height)
        self.ranges = row_ranges(self.height, len(self.blocks))
        for b, (s, e) in zip(self.blocks, self.ranges):
            if b.dim() != 4 or b.shape[2] != e - s:
                raise ValueError(f"block {tuple(b.shape)} for rows "
                                 f"[{s}, {e})")

    @property
    def devices(self) -> List[torch.device]:
        return [b.device for b in self.blocks]

    @property
    def shape(self):
        n, c, _, w = self.blocks[0].shape
        return (n, c, self.height, w)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    def map(self, fn) -> "Rows":
        """``fn`` on each block (an op that keeps the rows: elementwise, or
        over the channels)."""
        return Rows([fn(b) for b in self.blocks], self.height)

    def __add__(self, other: "Rows") -> "Rows":
        return Rows([a + b for a, b in zip(self.blocks, other.blocks)],
                    self.height)


def shard(x: torch.Tensor, devices: Sequence) -> Rows:
    """(N, C, H, W) ``x`` split into row blocks, block i copied to
    ``devices[i]`` (a view where it lies there already)."""
    devices = [canonical_device(d) for d in devices]
    h = x.shape[2]
    return Rows([to(x[:, :, s:e], d) for (s, e), d in
                 zip(row_ranges(h, len(devices)), devices)], h)


def gather(x: Rows, device=None) -> torch.Tensor:
    """The whole map on ``device`` (the first block's by default): for a
    result, never inside a model."""
    device = x.devices[0] if device is None else canonical_device(device)
    return torch.cat([to(b, device) for b in x.blocks], dim=2)


def cat(xs: Sequence[Rows], dim: int = 1) -> Rows:
    """Maps of one height concatenated along a dimension other than the
    rows, block by block."""
    return Rows([torch.cat(bs, dim=dim) for bs in
                 zip(*(x.blocks for x in xs))], xs[0].height)


def fetch_rows(x: Rows, a: int, b: int, device) -> torch.Tensor:
    """Global rows [a, b) of ``x`` (0 <= a <= b <= H) on ``device``,
    gathered from whichever blocks hold them: a view where one block on
    ``device`` holds them all."""
    if not 0 <= a <= b <= x.height:
        raise ValueError(f"rows [{a}, {b}) of {x.height}")
    pieces = [to(blk[:, :, max(a, s) - s:min(b, e) - s], device)
              for blk, (s, e) in zip(x.blocks, x.ranges)
              if max(a, s) < min(b, e)]
    if not pieces:
        n, c, _, w = x.shape
        return x.blocks[0].new_zeros((n, c, 0, w), device=device)
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=2)


def window(x: Rows, y1: int, y2: int, x1: int, x2: int) -> Rows:
    """Rows [y1, y2) and columns [x1, x2) of ``x``, split again over x's
    devices by ``row_ranges(y2 - y1, k)``: block j from whichever blocks
    hold its rows, each block's columns sliced before any copy (empty
    blocks where the window has fewer rows than shards).  The copies'
    gradients flow back to x's blocks."""
    if not (0 <= y1 <= y2 <= x.height and 0 <= x1 <= x2 <= x.shape[3]):
        raise ValueError(f"window rows [{y1}, {y2}), columns [{x1}, {x2}) "
                         f"of {x.height} x {x.shape[3]}")
    cols = Rows([b[:, :, :, x1:x2] for b in x.blocks], x.height)
    return Rows([fetch_rows(cols, y1 + s, y1 + e, dev) for (s, e), dev in
                 zip(row_ranges(y2 - y1, len(x.blocks)), x.devices)],
                y2 - y1)


def _beyond(x: Rows, a: int, b: int, device, mode: str):
    """Rows [a, b) of the whole map padded in ``mode``, all above row 0 or
    all below row H - 1, within the padding torch allows: None where
    a == b."""
    if a == b:
        return None
    h = x.height
    if mode == "replicate":
        edge = 0 if b <= 0 else h - 1
        return fetch_rows(x, edge, edge + 1, device).expand(
            -1, -1, b - a, -1)
    if mode == "circular":
        return fetch_rows(x, a % h, a % h + b - a, device)
    if mode != "reflect":
        raise ValueError(f"padding mode {mode!r}")
    # row r is row -r above the map and row 2 (H - 1) - r below it
    last = -(b - 1) if b <= 0 else 2 * (h - 1) - (b - 1)
    return fetch_rows(x, last, last + b - a, device).flip(2)


def fetch_padded(x: Rows, a: int, b: int, device, value: float = 0.0,
                 mode: str = "constant") -> torch.Tensor:
    """Global rows [a, b) of ``x`` on ``device``, the rows above row 0 and
    below row H - 1 those of the whole map padded as ``F.pad`` pads it in
    ``mode``: ``value`` ("constant"), the map mirrored about its first
    and last rows ("reflect": row -i is row i, row H - 1 + i is row
    H - 1 - i), its edge rows repeated ("replicate") or the map wrapped
    ("circular": row i mod H), from whichever shards hold those rows."""
    lo, hi = min(max(a, 0), x.height), max(min(b, x.height), 0)
    got = fetch_rows(x, lo, max(hi, lo), device)
    top = max(min(b, 0) - a, 0)
    bottom = max(b - max(a, x.height), 0)
    if not (top or bottom):
        return got
    if mode == "constant":
        return F.pad(got, (0, 0, top, bottom), value=value)
    pieces = [_beyond(x, a, a + top, device, mode), got,
              _beyond(x, b - bottom, b, device, mode)]
    return torch.cat([p for p in pieces if p is not None], dim=2)


def _rowwise(x: Rows, op, kernel: int, stride: int, padding, dilation: int,
             channels: int, w_out: int, fill: float,
             op_padding: Optional[int] = None,
             mode: str = "constant") -> Rows:
    """``op(window, device)``, a convolution or a pool that pads
    ``op_padding`` rows itself on each side (``padding``'s by default),
    over each shard's output rows.  ``padding``: the rows of ``fill`` the
    whole map has above and below, an int or a (top, bottom) pair, the top
    ones reached only from shard 0 and the bottom ones only from the last
    shard, or rows of the whole map padded in ``mode``
    (``fetch_padded``).  The window is the input rows the shard's outputs
    reach, from whichever shards hold them, begun ``lead`` output rows
    early so that the op's own padding falls only on rows it computes and
    drops: the op runs with the unsharded one's padding, as cuDNN chooses
    its algorithm by it (a 3x3 convolution of 64 channels at 122 x 240
    rows, float32, padded (0, 1), takes ~28x the time and 2 GiB of
    workspace that the same padded (1, 1) takes on the H100)."""
    top, bottom = _pair(padding)
    op_padding = top if op_padding is None else op_padding
    reach = dilation * (kernel - 1) + 1
    h_out = (x.height + top + bottom - reach) // stride + 1
    lead = -(-op_padding // stride)
    n = x.shape[0]
    blocks = []
    for (o0, o1), dev in zip(row_ranges(h_out, len(x.blocks)), x.devices):
        if o1 == o0:
            blocks.append(x.blocks[0].new_zeros((n, channels, 0, w_out),
                                                device=dev))
            continue
        a = (o0 - lead) * stride - top + op_padding
        b = (o1 - 1) * stride - top + reach
        y = op(fetch_padded(x, a, b, dev, fill, mode), dev)
        blocks.append(y[:, :, lead:lead + o1 - o0])
    return Rows(blocks, h_out)


def conv2d(x: Rows, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride=1, padding=0, dilation=1, groups: int = 1,
           padding_mode: str = "zeros") -> Rows:
    """``nn.Conv2d``'s convolution of a row-sharded map, ``padding`` an
    int, a pair, "same" or "valid" and ``padding_mode`` one of "zeros",
    "reflect", "replicate" or "circular": each shard's output rows from
    the input rows they reach, however many shards those span.  Zeros
    with an int or a pair: the op padded as the unsharded one
    (``_rowwise``)."""
    if isinstance(padding, str) or padding_mode != "zeros":
        return _conv2d_padded(x, weight, bias, stride, padding, dilation,
                              groups, padding_mode)
    (sh, sw), (ph, pw), (dh, dw) = (_pair(stride), _pair(padding),
                                    _pair(dilation))
    kh, kw = weight.shape[2:]
    w_out = (x.shape[3] + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    return _rowwise(
        x, lambda win, dev: F.conv2d(win, to(weight, dev), to(bias, dev),
                                     (sh, sw), (ph, pw), (dh, dw), groups),
        kh, sh, ph, dh, weight.shape[0], w_out, 0.0)


def _torch_pads(padding, kernel, dilation) -> tuple:
    """The (left, right, top, bottom) padding ``nn.Conv2d`` gives ``F.pad``
    (``_reversed_padding_repeated_twice``): "same" puts dilation (k - 1)
    // 2 before and the rest after, as ATen's "same" convolution does."""
    if padding == "valid":
        return (0, 0, 0, 0)
    if padding == "same":
        (th, tw) = (d * (k - 1) for k, d in zip(kernel, dilation))
        return (tw // 2, tw - tw // 2, th // 2, th - th // 2)
    ph, pw = _pair(padding)
    return (pw, pw, ph, ph)


def _conv2d_padded(x: Rows, weight: torch.Tensor,
                   bias: Optional[torch.Tensor], stride, padding, dilation,
                   groups: int, padding_mode: str) -> Rows:
    """``conv2d`` padded by a string or in a mode other than zeros, as
    ``nn.Conv2d`` runs a mode: the whole map padded (``F.pad``: the rows
    by ``fetch_padded``, the columns by each shard, which holds the whole
    width), then a convolution padded 0.  torch's checks run first on the
    whole map's shape (the meta device), so the sharded form raises what
    the unsharded one raises, and from the whole map's height."""
    kh, kw = weight.shape[2:]
    mode = "constant" if padding_mode == "zeros" else padding_mode
    left, right, top, bottom = _torch_pads(padding, (kh, kw),
                                           _pair(dilation))
    meta = torch.empty(x.shape, dtype=x.dtype, device="meta")
    meta_w = torch.empty(weight.shape, dtype=weight.dtype, device="meta")
    if isinstance(padding, str):
        F.conv2d(meta, meta_w, None, stride, padding, dilation, groups)
    meta = F.pad(meta, (left, right, top, bottom), mode=mode)
    w_out = F.conv2d(meta, meta_w, None, stride, 0, dilation,
                     groups).shape[3]

    def op(win, dev):
        if left or right:
            win = F.pad(win, (left, right, 0, 0), mode=mode)
        return F.conv2d(win, to(weight, dev), to(bias, dev), stride, 0,
                        dilation, groups)
    return _rowwise(x, op, kh, _pair(stride)[0], (top, bottom),
                    _pair(dilation)[0], weight.shape[0], w_out, 0.0,
                    op_padding=0, mode=mode)


def conv2d_same(x: Rows, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, stride=1, dilation=1,
                groups: int = 1) -> Rows:
    """``layers.SameConv2d`` (flax's "SAME" padding) of a row-sharded map:
    the rows' padding split from the whole map's height
    (``layers.same_pads``, the odd row at the bottom), zeros above shard
    0's rows and below the last shard's, the columns' padded by each
    shard as the unsharded module pads them."""
    from ..models.layers import same_pads
    (sh, sw), (dh, dw) = _pair(stride), _pair(dilation)
    kh, kw = weight.shape[2:]
    rows = same_pads(x.height, kh, sh)
    cols = same_pads(x.shape[3], kw, sw)
    w_out = (x.shape[3] + sum(cols) - dw * (kw - 1) - 1) // sw + 1
    return _rowwise(
        x, lambda win, dev: F.conv2d(F.pad(win, (*cols, 0, 0)),
                                     to(weight, dev), to(bias, dev),
                                     (sh, sw), 0, (dh, dw), groups),
        kh, sh, rows, dh, weight.shape[0], w_out, 0.0, op_padding=0)


def max_pool2d(x: Rows, kernel_size: int, stride: int,
               padding: int) -> Rows:
    """``F.max_pool2d`` of a row-sharded map: -inf padding at the map's top
    and bottom only."""
    w_out = (x.shape[3] + 2 * padding - kernel_size) // stride + 1
    return _rowwise(
        x, lambda win, dev: F.max_pool2d(win, kernel_size, stride, padding),
        kernel_size, stride, padding, 1, x.shape[1], w_out, float("-inf"))


def avg_pool2d(x: Rows, kernel_size: int, stride: int,
               padding: int = 0) -> Rows:
    """``F.avg_pool2d(..., count_include_pad=True)`` (flax's
    ``nn.avg_pool``) of a row-sharded map: zero rows above and below the
    whole map count in the mean, a shard's interior edge reads its
    neighbour's rows (a window may straddle two shards)."""
    w_out = (x.shape[3] + 2 * padding - kernel_size) // stride + 1
    return _rowwise(
        x, lambda win, dev: F.avg_pool2d(win, kernel_size, stride, padding,
                                         count_include_pad=True),
        kernel_size, stride, padding, 1, x.shape[1], w_out, 0.0)


def _host_matrix(kind: str, n_in: int, n_out: int,
                 align_corners: bool) -> np.ndarray:
    """The float32 (out, in) weights of ``models.ops``: "resize" (bilinear)
    or "pool" (adaptive average bins)."""
    from ..models import ops
    if kind == "resize":
        return ops._linear_resize_matrix(n_in, n_out, align_corners)
    return ops._adaptive_pool_matrix(n_in, n_out)


@functools.lru_cache(maxsize=512)
def _matrix(kind: str, n_in: int, n_out: int, align_corners: bool,
            rows: tuple, cols: tuple, device: torch.device,
            dtype: torch.dtype) -> torch.Tensor:
    """Rows ``rows`` and columns ``cols`` (slice bounds) of
    ``_host_matrix`` on ``device`` in ``dtype``."""
    m = _host_matrix(kind, n_in, n_out, align_corners)
    return upload(np.ascontiguousarray(m[slice(*rows), slice(*cols)]),
                  device).to(dtype)


def _wide(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def adaptive_avg_pool(x: Rows, output_size, device) -> torch.Tensor:
    """Adaptive average pooling (torch's bins, which overlap where the
    size does not divide) of a row-sharded map into a global (N, C, oh,
    ow) map on ``device``, in x's type: each shard's columns of the bin
    matrices times its rows, the contributions summed (in float32 or
    wider)."""
    oh, ow = _pair(output_size)
    device = canonical_device(device)
    dt = _wide(x.dtype)
    w = x.shape[3]
    total = None
    for blk, (s, e) in zip(x.blocks, x.ranges):
        if e == s:
            continue
        dev = blk.device
        mh = _matrix("pool", x.height, oh, False, (0, oh), (s, e), dev, dt)
        mw = _matrix("pool", w, ow, False, (0, ow), (0, w), dev, dt)
        part = torch.einsum("ow,...hw->...ho", mw, torch.einsum(
            "oh,...hw->...ow", mh, blk.to(dt)))
        part = to(part, device)
        total = part if total is None else total + part
    return total.to(x.dtype)


def resize(x, size, align_corners: bool = False,
           devices: Optional[Sequence] = None) -> Rows:
    """Bilinear resize (``models.ops.resize_nchw``) into a row-sharded
    (N, C, out_h, out_w) map, in the type x is promoted to with float32.
    ``x``: a row-sharded map, whose output rows each shard computes from
    the input rows they read; or a global map (a pooled branch), copied to
    each of ``devices``."""
    out_h, out_w = size
    if isinstance(x, Rows):
        devices, in_h = x.devices, x.height
        if (in_h, x.shape[3]) == (out_h, out_w):
            return x
    else:
        devices = [canonical_device(d) for d in devices]
        in_h = x.shape[2]
    in_w = x.shape[3]
    dt = _wide(x.dtype)
    full_h = _host_matrix("resize", in_h, out_h, align_corners)
    blocks = []
    for (r0, r1), dev in zip(row_ranges(out_h, len(devices)), devices):
        n, c = x.shape[:2]
        if r1 == r0:
            blocks.append(torch.zeros((n, c, 0, out_w), dtype=dt,
                                      device=dev))
            continue
        used = np.nonzero(full_h[r0:r1].any(axis=0))[0]
        a, b = int(used[0]), int(used[-1]) + 1
        src = fetch_rows(x, a, b, dev) if isinstance(x, Rows) else to(
            x[:, :, a:b], dev)
        mh = _matrix("resize", in_h, out_h, align_corners, (r0, r1), (a, b),
                     dev, dt)
        mw = _matrix("resize", in_w, out_w, align_corners, (0, out_w),
                     (0, in_w), dev, dt)
        y = torch.einsum("oh,...hw->...ow", mh, src.to(dt))
        blocks.append(torch.einsum("ow,...hw->...ho", mw, y))
    return Rows(blocks, out_h)


def upsample_nearest2(x: Rows, size) -> Rows:
    """``F.interpolate(x, scale_factor=2, mode="nearest")[..., :h, :w]``
    (the FPN neck's top-down path) into a row-sharded (N, C, h, w) map:
    output row r is input row r // 2, taken from whichever shard holds
    it."""
    h, w = size
    blocks = []
    for (r0, r1), dev in zip(row_ranges(h, len(x.blocks)), x.devices):
        a = r0 // 2
        src = fetch_rows(x, a, (r1 + 1) // 2 if r1 > r0 else a, dev)
        up = src.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        blocks.append(up[:, :, r0 - 2 * a:r1 - 2 * a, :w])
    return Rows(blocks, h)


def dropout(x: Rows, ratio: float, generator, device) -> Rows:
    """flax's dropout (keep with probability 1 - ratio, scaled by 1 / (1 -
    ratio)) with the global map's mask: drawn whole on ``device`` from
    ``generator`` (a ``torch.Generator`` or a ``layers.BatchRows``), each
    shard keeping its rows, so each drops what the unsharded map does."""
    from ..models.layers import dropout_draw
    keep = 1.0 - ratio
    mask = dropout_draw(x.shape, generator, canonical_device(device)) < keep
    return Rows([torch.where(to(mask[:, :, s:e], blk.device), blk / keep,
                             torch.zeros_like(blk))
                 for blk, (s, e) in zip(x.blocks, x.ranges)], x.height)


def bce_mean(logits: Rows, target: Rows, device) -> torch.Tensor:
    """The mean of ``models.losses.bce_with_logits`` over the whole map:
    each shard's sum, summed on ``device``, over the global count."""
    from ..models.losses import bce_with_logits
    device = canonical_device(device)
    total = sum(to(bce_with_logits(l, t).sum(), device)
                for l, t in zip(logits.blocks, target.blocks))
    return total / float(np.prod(logits.shape))
