"""The launch plan of the cluster sweep kernels (``fmm_sweep.sweep_plan``).

The plan is plain Python: given the grids' shape and how many clusters of
each size the card holds at once, it picks the cluster size C, the
segments (columns for order 2, the rows of a row block for order 1) and a
block's shared memory.  These tests need no card: the
resident counts are arguments (a card's, as ``resident_clusters`` would
read them for an H100 at these layouts).
"""

import pytest

from peanut_tpu_torch.kernels.fmm_sweep import (MAX_LONG_BLOCK, MAX_W1,
                                                MIN_SEG, SMEM_LIMIT,
                                                SweepPlan, needs_long,
                                                smem_bytes, sweep_plan)

# clusters of each size resident at once, as resident_clusters reads them
# on an H100 (a block holds its SM alone; 8-block clusters fit 15 at once,
# 6-block ones 17)
RESIDENT = {16: 7, 8: 15, 6: 17, 4: 30, 2: 66, 1: 132}

# (order, B, W) -> (cluster, seg, last segment, smem bytes) at
# block 16: the paths' shapes (single-explore 242^2, planning 482^2, goal
# weighting 960^2, the 16-env tick, B1's 8 x 480^2 window) and the CPU
# tests' narrow widths
EXPECTED = {
    (1, 1, 242): (16, 1, 1, 9490),
    (1, 1, 482): (16, 1, 1, 18818),
    (1, 1, 960): (16, 1, 1, 37184),
    (1, 16, 482): (6, 3, 1, 48742),
    (1, 8, 480): (8, 2, 2, 33472),
    (1, 2, 40): (2, 8, 8, 14720),
    (1, 1, 33): (2, 8, 8, 14160),
    (1, 3, 200): (8, 2, 2, 15696),
    (1, 2, 64): (4, 4, 4, 8576),
    (2, 1, 242): (16, 16, 2, 3072),
    (2, 1, 482): (16, 31, 17, 5952),
    (2, 1, 960): (16, 60, 60, 11520),
    (2, 16, 482): (6, 81, 77, 15552),
    (2, 8, 480): (8, 60, 60, 11520),
    (2, 2, 37): (2, 19, 18, 3648),
    (2, 3, 50): (2, 25, 25, 4800),
}


@pytest.mark.parametrize("key", sorted(EXPECTED))
def test_plan_at_the_paths_shapes(key):
    order, b, w = key
    p = sweep_plan(order, b, w, 16, RESIDENT)
    assert (p.cluster, p.seg, p.widths[-1], p.smem_bytes) == EXPECTED[key]
    assert p.order == order and len(p.widths) == p.cluster
    assert p.smem_bytes == smem_bytes(order, w, 16, p.seg)
    assert p.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("w", [1, 2, 31, 33, 37, 64, 65, 200, 242, 481, 482,
                               960, 1024, 2000])
@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 6, 8, 16])
def test_segments_cover_every_column_once(order, w, cluster):
    """Order 2's column segments cover the row, order 1's row segments the
    row block, each cell once."""
    n = 16 if order == 1 else w
    try:
        p = sweep_plan(order, 1, w, 16, RESIDENT, cluster=cluster)
    except ValueError:
        # only where a block would own nothing, order 2's halo would reach
        # past a neighbour, or shared memory runs out
        assert cluster is not None
        seg = -(-n // cluster)
        assert (-(-n // seg) != cluster or (order == 2 and seg < 2)
                or smem_bytes(order, w, 16, seg) > SMEM_LIMIT)
        return
    cells = [c for q, width in enumerate(p.widths)
             for c in range(q * p.seg, q * p.seg + width)]
    assert cells == list(range(n))
    assert all(width >= 1 for width in p.widths)
    assert all(width == p.seg for width in p.widths[:-1])
    if cluster is not None:
        assert p.cluster == cluster


def test_ragged_last_segment():
    p = sweep_plan(2, 1, 482, 16, RESIDENT)
    assert p.widths == (31,) * 15 + (17,)
    p = sweep_plan(2, 1, 37, 16, RESIDENT, cluster=8)
    assert p.widths == (5,) * 7 + (2,)
    # order 2 takes a last segment of one column: its halo is past the grid
    assert sweep_plan(2, 1, 10, 16, RESIDENT, cluster=4).widths == (3, 3, 3,
                                                                    1)
    # order 1 splits the rows: 10-row blocks over 4 blocks of 3 rows
    assert sweep_plan(1, 1, 482, 10, RESIDENT, cluster=4).widths == (3, 3, 3,
                                                                     1)


def test_order1_splits_rows_and_order2_columns():
    p1 = sweep_plan(1, 1, 960, 16, RESIDENT)
    p2 = sweep_plan(2, 1, 960, 16, RESIDENT)
    assert (p1.cluster, p1.seg, p1.widths) == (16, 1, (1,) * 16)
    assert (p2.cluster, p2.seg, p2.widths) == (16, 60, (60,) * 16)
    # no more blocks than rows in a row block
    assert sweep_plan(1, 1, 960, 8, RESIDENT).cluster == 8
    with pytest.raises(ValueError):
        sweep_plan(1, 1, 960, 8, RESIDENT, cluster=16)
    # one block per grid holds whole 16-row blocks only of shorter rows
    assert sweep_plan(1, 1, 200, 16, RESIDENT, cluster=1).smem_bytes == (
        smem_bytes(1, 200, 16, 16))
    with pytest.raises(ValueError):
        sweep_plan(1, 1, 482, 16, RESIDENT, cluster=1)


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("w", [1, 2, 17, 24, 30])
def test_narrow_rows_run_one_block(order, w):
    """Rows that would leave segments under MIN_SEG columns stay whole."""
    p = sweep_plan(order, 1, w, 16, RESIDENT)
    assert p.cluster == 1 and w < 2 * MIN_SEG
    assert p.widths == ((16,) if order == 1 else (w,))


def test_the_plan_keeps_the_batch_resident():
    # 16 clusters of 8 do not fit at once, of 6 they do: the tick takes 6;
    # where 16 of 8 fit it keeps 8, where 16 of 6 do not, 4
    assert sweep_plan(2, 16, 482, 16, RESIDENT).cluster == 6
    assert sweep_plan(2, 16, 482, 16, {**RESIDENT, 8: 16}).cluster == 8
    assert sweep_plan(2, 16, 482, 16, {**RESIDENT, 6: 15}).cluster == 4
    # one grid: the largest cluster
    assert sweep_plan(1, 1, 482, 16, RESIDENT).cluster == 16
    # 40 grids: clusters of 2 are the largest that all fit at once
    assert sweep_plan(1, 40, 482, 16, RESIDENT).cluster == 2
    # a card without clusters of 16 (resident 0) gets 8 at 960
    assert sweep_plan(1, 1, 960, 16, {**RESIDENT, 16: 0}).cluster == 8
    # more grids than any plan holds: the smallest cluster, the grids queue
    assert sweep_plan(2, 500, 960, 16, RESIDENT).cluster == 1


@pytest.mark.parametrize("args,kw", [
    ((1, 1, 0, 16), {}),                      # no columns
    ((1, 1, 482, 0), {}),                     # order 1 needs block >= 1
    ((2, 1, 482, 1), {}),                     # order 2 needs block >= 2
    ((3, 1, 482, 16), {}),                    # no such kernel
    ((1, 1, 482, 16), {"cluster": 3}),        # not a cluster size
    ((2, 1, 37, 16), {"cluster": 16}),        # blocks without columns
    ((1, 1, 482, 8), {"cluster": 16}),        # blocks without rows
    ((2, 1, 2, 16), {"cluster": 2}),          # halo past the neighbour
    ((2, 1, 1024, 400), {"cluster": 1}),      # shared memory
    ((1, 1, 960, 4000), {}),                  # too tall for any plan
    ((1, 1, 4097, MAX_LONG_BLOCK + 1), {}),   # past the long kernels' block
])
def test_shapes_the_kernels_do_not_take(args, kw):
    with pytest.raises(ValueError):
        sweep_plan(*args, RESIDENT, **kw)


@pytest.mark.parametrize("w", [1025, 1040, 1042, 1500, 2000, 2048, 2049,
                               3000, 4096])
@pytest.mark.parametrize("b", [1, 16])
def test_order1_plan_takes_rows_up_to_2048(b, w):
    """B4 scans rows of up to 64 chunks of 32 cells, and since the
    four-chunk second phase up to 128: the plan takes them at block 16,
    the row block split over a cluster, within shared memory."""
    p = sweep_plan(1, b, w, 16, RESIDENT)
    assert p.cluster > 1 and p.smem_bytes <= SMEM_LIMIT
    assert p.smem_bytes == smem_bytes(1, w, 16, p.seg)
    assert sum(p.widths) == 16


# B1, the fused solve: (B, H, W, block, scan_chunk) -> (cluster, seg,
# widths, smem bytes) at its path shapes (the 16-env tick's blanket, the
# column-scan solve, the exact profile's full-resolution width) and the CPU
# tests' narrow ones
FUSED = {
    (16, 482, 482, 16, 4): (6, 3, (3, 3, 3, 3, 3, 1), 82422),
    (8, 480, 480, 8, 4): (8, 1, (1,) * 8, 69120),
    (16, 962, 962, 16, 4): (6, 3, (3, 3, 3, 3, 3, 1), 164502),
    (1, 482, 482, 16, 4): (16, 1, (1,) * 16, 73746),
    (3, 50, 37, 16, 4): (2, 8, (8, 8), 7992),
    (2, 41, 64, 16, 40): (4, 4, (4,) * 4, 26112),
}


@pytest.mark.parametrize("key", sorted(FUSED))
def test_fused_plan_at_the_paths_shapes(key):
    b, h, w, block, chunk = key
    p = sweep_plan(1, b, w, block, RESIDENT, fused=(h, chunk))
    assert (p.cluster, p.seg, p.widths, p.smem_bytes) == FUSED[key]
    assert p.order == 1 and len(p.widths) == p.cluster
    assert p.smem_bytes == smem_bytes(1, w, block, p.seg, (h, chunk))
    assert p.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("w", [1, 31, 37, 64, 200, 481, 482, 960, 1024,
                               1040, 1500])
@pytest.mark.parametrize("block", [5, 8, 16])
@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 6, 8, 16])
def test_fused_segments_cover_every_row_once(w, block, cluster):
    """B1's row segments cover the row block once, the last one ragged,
    within the shared memory a block has, whatever C is chosen."""
    try:
        p = sweep_plan(1, 1, w, block, RESIDENT, cluster=cluster,
                       fused=(482, 4))
    except ValueError:
        # only where a block would own no rows or shared memory runs out
        assert cluster is not None
        seg = -(-block // cluster)
        assert (-(-block // seg) != cluster
                or smem_bytes(1, w, block, seg, (482, 4)) > SMEM_LIMIT)
        return
    rows = [r for q, width in enumerate(p.widths)
            for r in range(q * p.seg, q * p.seg + width)]
    assert rows == list(range(block))
    assert all(width == p.seg for width in p.widths[:-1])
    assert 1 <= p.widths[-1] <= p.seg
    assert p.smem_bytes <= SMEM_LIMIT


def test_fused_plan_ghost_rows_and_column_staging():
    # the ghost rows reach scan_chunk rows a side, as far as the row block
    base = smem_bytes(1, 482, 16, 3, (40, 1))
    assert smem_bytes(1, 482, 16, 3, (40, 4)) > base
    assert (smem_bytes(1, 482, 16, 3, (40, 16))
            == smem_bytes(1, 482, 16, 3, (40, 40)))
    # the 482-cell blanket at C = 6: 11 rows held twice, 2 x 8 rows
    # received, the two boundary rows, the walls of the 11 rows
    assert smem_bytes(1, 482, 16, 3, (482, 4)) == (
        (2 * 11 + 2 * 8 + 2) * 482 * 4 + 11 * 482)
    # the column scans' staging (16 columns of H + 1 floats and bytes) sets
    # the size where it is the larger
    assert smem_bytes(1, 64, 16, 8, (1024, 4)) == 16 * 1025 * 5
    # a cluster of one holds the whole row block; at scan_chunk 40 its
    # receive buffers leave no room for rows of 1024 cells (fewer ghost
    # rows are for rows over 1024 cells only)
    assert sweep_plan(1, 1, 64, 16, RESIDENT, cluster=1,
                      fused=(50, 4)).seg == 16
    with pytest.raises(ValueError):
        sweep_plan(1, 1, 1024, 16, RESIDENT, cluster=1, fused=(482, 40))
    # rows over 1024 cells plan with fewer
    p = sweep_plan(1, 1, 1040, 16, RESIDENT, cluster=1, fused=(482, 40))
    assert p.seg == 16 and 1 <= p.ghosts < 16
    assert p.smem_bytes == smem_bytes(1, 1040, 16, 16, (482, 40), p.ghosts)


@pytest.mark.parametrize("h", [1025, 1040, 2000, 2048])
def test_fused_column_staging_past_1024_holds_the_pair_exchanges(h):
    """Columns over 1024 cells are scanned by pairs of warps: the staging
    of 16 columns grows by the 8 pairs' exchanges (1024 floats each), and
    still fits a block at 2048."""
    assert smem_bytes(1, 48, 16, 8, (h, 4)) == (16 * (h + 1) * 5
                                                + 8 * 1024 * 4)
    assert smem_bytes(1, 48, 16, 8, (h, 4)) <= SMEM_LIMIT


@pytest.mark.parametrize("w", [1, 2, 17, 24, 30])
def test_fused_narrow_grids_run_one_block(w):
    p = sweep_plan(1, 4, w, 16, RESIDENT, fused=(50, 4))
    assert p.cluster == 1 and p.widths == (16,)


def test_fused_plan_keeps_the_batch_resident():
    assert sweep_plan(1, 16, 482, 16, RESIDENT, fused=(482, 4)).cluster == 6
    assert sweep_plan(1, 16, 482, 16, {**RESIDENT, 8: 16},
                      fused=(482, 4)).cluster == 8
    # block 8 leaves no rows for a 16th block
    assert sweep_plan(1, 8, 480, 8, RESIDENT, fused=(480, 4)).cluster == 8


@pytest.mark.parametrize("args,kw", [
    # lines over 4096 cells (long) in blocks past the long kernels' rows
    ((1, 1, 4097, MAX_LONG_BLOCK + 1), {"fused": (482, 4)}),
    ((1, 1, 482, MAX_LONG_BLOCK + 1), {"fused": (4097, 4)}),
    ((1, 1, 2000, 16), {"fused": (2000, 4), "cluster": 1}),  # shared memory
    ((2, 1, 482, 16), {"fused": (482, 4)}),    # the fused solve is order 1
    ((1, 1, 482, 16), {"fused": (0, 4)}),      # no rows
    ((1, 1, 482, 16), {"fused": (482, 0)}),    # no passes a round
    ((1, 1, 482, 8), {"fused": (482, 4), "cluster": 16}),
])
def test_fused_shapes_the_kernel_does_not_take(args, kw):
    with pytest.raises(ValueError):
        sweep_plan(*args, RESIDENT, **kw)


@pytest.mark.parametrize("b,h,w,block", [
    (1, 1042, 1042, 16), (16, 1042, 1042, 16), (1, 1042, 1042, 8),
    (2, 48, 1040, 16), (2, 1040, 48, 16), (1, 16, 1025, 16),
    (1, 1025, 16, 16), (2, 2000, 48, 16), (1, 1607, 1607, 8)])
def test_fused_plan_takes_lines_past_1024(b, h, w, block):
    """B1 takes every grid up to 2048 cells a line whose plan fits a
    block's shared memory: the exact profile's 1042^2 goal-weighting
    solve, rows of 1040 and columns of up to 2048 (column scans)."""
    p = sweep_plan(1, b, w, block, RESIDENT, fused=(h, 4))
    assert p.smem_bytes <= SMEM_LIMIT
    assert p.smem_bytes == smem_bytes(1, w, block, p.seg, (h, 4))
    assert sum(p.widths) == block


def test_fused_plan_past_shared_memory_says_so():
    """Rows too wide for scan_chunk ghost rows a side in a block's shared
    memory get fewer (1608^2 at block 8: 3; 16 x 1700^2 at block 16: 2);
    a forced cluster size that fits with none raises a ValueError that
    names shared memory, and lines over 4096 cells plan the long-line
    kernel."""
    p = sweep_plan(1, 1, 1608, 8, RESIDENT, fused=(1608, 4))
    assert (p.cluster, p.seg, p.ghosts) == (8, 1, 3)
    assert smem_bytes(1, 1608, 8, 1, (1608, 4)) > SMEM_LIMIT
    assert p.smem_bytes == smem_bytes(1, 1608, 8, 1, (1608, 4), 3)
    p = sweep_plan(1, 16, 1700, 16, RESIDENT, fused=(1700, 4))
    assert (p.cluster, p.seg, p.ghosts) == (6, 3, 2)
    assert p.smem_bytes <= SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        sweep_plan(1, 1, 2000, 16, RESIDENT, cluster=1, fused=(2000, 4))
    # lines over 4096 cells take the long-line kernel
    assert sweep_plan(1, 1, 482, 8, RESIDENT, fused=(4097, 4)).long
    assert sweep_plan(1, 1, 4097, 8, RESIDENT, fused=(48, 4)).long


@pytest.mark.parametrize("b,h,w,block,ghosts", [
    (1, 1608, 1608, 8, 3), (16, 1700, 1700, 16, 2), (1, 48, 4096, 8, 1),
    (1, 48, 4096, 16, 1), (2, 4096, 48, 8, 4), (1, 2049, 2049, 8, 2),
    (16, 482, 482, 16, 4), (8, 480, 480, 8, 4), (16, 962, 962, 16, 4)])
def test_fused_plan_ghost_rows_as_deep_as_fit(b, h, w, block, ghosts):
    """The plan keeps min(scan_chunk, block) ghost rows a side wherever
    they fit (the paths' shapes), else the most that fit, and the rows,
    ghost rows and column staging stay within a block's shared memory."""
    p = sweep_plan(1, b, w, block, RESIDENT, fused=(h, 4))
    assert p.ghosts == ghosts and p.smem_bytes <= SMEM_LIMIT
    assert p.smem_bytes == smem_bytes(1, w, block, p.seg, (h, 4), ghosts)
    if ghosts < min(4, block):
        assert smem_bytes(1, w, block, p.seg, (h, 4),
                          ghosts + 1) > SMEM_LIMIT
    assert sum(p.widths) == block


@pytest.mark.parametrize("h", [2049, 3000, 4096])
def test_fused_column_staging_past_2048_holds_the_group_exchanges(h):
    """Columns over 2048 cells are scanned by groups of four warps: four
    columns staged a step (16-byte aligned), beside the four groups'
    exchanges (three slots of 1024 floats each)."""
    staged = -(-4 * (h + 1) * 5 // 16) * 16
    assert smem_bytes(1, 48, 8, 4, (h, 4)) == staged + 4 * 3 * 1024 * 4
    assert smem_bytes(1, 48, 8, 4, (h, 4)) <= SMEM_LIMIT


def test_plan_is_a_value():
    p = sweep_plan(2, 1, 482, 16, RESIDENT)
    assert p == SweepPlan(2, 16, 31, (31,) * 15 + (17,), 5952)
    with pytest.raises(AttributeError):
        p.cluster = 1


# (order, B, H, W, block, fused scan_chunk) -> the long plan's cluster:
# the 4097-cell row and columns, B2's row past its shared memory at C = 16
# (19,281 cells at block 16), chip_smoke.py's wide_lines shapes and a
# longer column scan (2 x 8192 x 48)
LONG = {
    (1, 1, 16, 4097, 16, None): 16,
    (1, 1, 4097, 482, 8, 4): 16,
    (1, 1, 48, 4097, 8, 4): 16,
    (2, 1, 16, 19281, 16, None): 16,
    (1, 1, 48, 8192, 16, None): 16,
    (1, 1, 16, 40000, 16, None): 16,
    (1, 2, 8192, 48, 8, 4): 16,
    (1, 2, 4104, 48, 8, 4): 16,
    (1, 1, 16, 6000, 8, 4): 16,
    (2, 1, 16, 20000, 16, None): 16,
    (1, 16, 16, 5000, 8, None): 6,
    (2, 1, 16, 40000, 8, None): 16,
    (1, 1, 4, 4097, 1, None): 2,
}


@pytest.mark.parametrize("key", sorted(LONG, key=str))
def test_long_line_plans(key):
    """Past the shared-memory kernels' lines the plan is long: no segments,
    no shared memory, a block for every 2048 cells of the largest step up
    to 16, the largest size whose clusters are all resident."""
    order, b, h, w, block, chunk = key
    fused = None if chunk is None else (h, chunk)
    assert needs_long(order, w, block, fused)
    p = sweep_plan(order, b, w, block, RESIDENT, fused=fused)
    assert p.long and p.order == order
    assert (p.cluster, p.seg, p.widths, p.smem_bytes) == (LONG[key], 0, (),
                                                          0)
    # a forced cluster size is the shared-memory kernel's, which cannot
    with pytest.raises(ValueError):
        sweep_plan(order, b, w, block, RESIDENT, cluster=p.cluster,
                   fused=fused)


def test_order2_long_starts_where_shared_memory_ends():
    """B2's segment of 1205 columns at block 16 is its last that fits."""
    assert smem_bytes(2, 19280, 16, 1205) <= SMEM_LIMIT
    assert smem_bytes(2, 19281, 16, 1206) > SMEM_LIMIT
    assert not sweep_plan(2, 1, 19280, 16, RESIDENT).long
    assert sweep_plan(2, 1, 19281, 16, RESIDENT).long


@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("order,fused", [(1, False), (2, False), (1, True)])
def test_every_grid_has_a_plan_at_the_configs_blocks(block, order, fused):
    """At blocks 8 and 16 the plan raises for no grid size: the paths'
    shapes stay on the shared-memory kernels, longer lines go long."""
    for w in (1, 2, 31, 482, 1024, 2048, 4096, 4097, 6000, 19280, 19281,
              33056, 33057, 65536):
        for h in ((48, 4096, 4097, 8192) if fused else (None,)):
            f = (h, 4) if fused else None
            p = sweep_plan(order, 16, w, block, RESIDENT, fused=f)
            line = max(w, h or 0) if order == 1 else 0
            if line > MAX_W1:
                assert p.long
            if max(w, h or 0) <= 1024:
                assert not p.long
