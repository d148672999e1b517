"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test asks the ``cuda`` fixture for the card and skips
without one (the decision is made inside the test, never at import).  On
the H100 (where JAX is not installed, hence no conftest):

    python -m pytest tests/test_torch_cuda.py -m gpu -q --noconftest

Tolerance: bitwise for the eikonal kernels (B1, B2, B4), which keep their
plain versions' operation order, scan association and rounding (see the
notes in kernels/csrc/*.cu) at every cluster size, and for ``nms_keep``
(both give the unique greedy keep set).  ``roi_window_pool`` sums in
another association than its plain version (tensor-core accumulation
order in bfloat16, the x-contraction's order in both): rtol/atol 2e-5,
in bfloat16 too, since both sides contract the same bfloat16-rounded
operands in float32.  The bfloat16 bar of tests/test_roi_window.py (2e-2)
would pass a kernel that skips rounding A_y; 2e-5 does not
(``test_roi_window_pool_bar_sees_unrounded_ay``).
"""

import numpy as np
import pytest
import torch

from peanut_tpu_torch.kernels import fmm
from peanut_tpu_torch.kernels.fmm_fused import (fused_eikonal,
                                                fused_eikonal_reference)
from peanut_tpu_torch.kernels import fmm_long, fmm_sweep
from peanut_tpu_torch.kernels.fmm_sweep import (block_sweep,
                                                block_sweep2,
                                                block_sweep2_reference,
                                                block_sweep_reference)
from peanut_tpu_torch.kernels.nms import nms_keep, nms_keep_reference
from peanut_tpu_torch.kernels.roi_window import (roi_window_pool,
                                                 roi_window_pool_reference)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the H100 run "
                    "`python -m pytest tests/test_torch_cuda.py -m gpu "
                    "--noconftest`")
    return torch.device("cuda")


def _grids(seed, b, h, w, dev):
    rng = np.random.RandomState(seed)
    trav = rng.rand(b, h, w) > 0.25
    src = np.zeros((b, h, w), bool)
    for i in range(b):
        src[i, rng.randint(h), rng.randint(w)] = True
    return (torch.as_tensor(trav, device=dev),
            torch.as_tensor(src, device=dev))


@pytest.mark.parametrize("shape", [(3, 50, 37), (2, 33, 64), (1, 482, 482)])
@pytest.mark.parametrize("params", [
    dict(rounds=2, block=16, inner=40, scan_chunk=4, vscan=False),
    dict(rounds=4, block=8, inner=24, scan_chunk=4, vscan=True),
])
def test_fused_eikonal_kernel_equals_plain(cuda, shape, params):
    trav, src = _grids(0, *shape, cuda)
    before = fused_eikonal.launches
    got = fused_eikonal(trav, src, **params)
    assert fused_eikonal.launches == before + 1
    want = fused_eikonal_reference(trav, src, **params)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _fused_case(trav, src, cluster=None, **kw):
    """The kernel's solve (one launch) and the plain version's."""
    before = fused_eikonal.launches
    got = fused_eikonal(trav, src, cluster=cluster, **kw)
    assert fused_eikonal.launches == before + 1
    want = fused_eikonal_reference(trav, src, **kw)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("cluster", [1, 2, 4, 6, 8, 16])
@pytest.mark.parametrize("w", [37, 64, 481, 482, 960, 1024])
@pytest.mark.parametrize("vscan", [False, True])
def test_fused_eikonal_equals_plain_at_every_cluster(cuda, cluster, w,
                                                     vscan):
    """B1 at every forced cluster size, bit-equal, with walls and sources
    on the row segments' boundaries and on the edges of their ghost rows,
    and a ragged last row block (50 = 3 x 16 + 2 rows)."""
    try:
        plan = fmm_sweep.sweep_plan(1, 1, w, 16, {}, cluster=cluster,
                                    fused=(50, 4))
    except ValueError:
        # a split the kernel does not take (tests/test_torch_sweep_plan.py)
        return
    if fmm_sweep.resident_clusters(1, w, 16, cuda, (50, 4))[cluster] < 1:
        pytest.skip(f"this card holds no cluster of {cluster} blocks")
    trav, src = _boundary_grids(20 + cluster, 1, 50, w, plan.seg, cuda,
                                rows=True, ghost=4)
    got, want = _fused_case(trav, src, cluster=cluster, rounds=2, block=16,
                            inner=12, scan_chunk=4, vscan=vscan)
    assert torch.equal(got, want)


@pytest.mark.parametrize("w", [64, 482])
@pytest.mark.parametrize("kw", [
    dict(rounds=0), dict(rounds=1), dict(rounds=4, vscan=True),
    dict(inner=0), dict(inner=0, vscan=True), dict(scan_chunk=1),
    dict(scan_chunk=40, vscan=True), dict(inner=10, scan_chunk=4),
    dict(block=8, inner=12, scan_chunk=3),
    dict(block=5, inner=6, scan_chunk=2, vscan=True)])
def test_fused_eikonal_rounds_inner_and_scan_chunk(cuda, w, kw):
    params = dict(rounds=2, block=16, inner=40, scan_chunk=4, vscan=False)
    params.update(kw)
    seg = fmm_sweep.launch_plan(1, torch.empty(2, 41, w, device=cuda),
                                params["block"],
                                fused_chunk=params["scan_chunk"]).seg
    trav, src = _boundary_grids(21, 2, 41, w, seg, cuda, rows=True,
                                ghost=params["scan_chunk"])
    got, want = _fused_case(trav, src, **params)
    assert torch.equal(got, want)


def test_fused_eikonal_on_more_grids_than_resident_clusters(cuda):
    """40 planning grids: more clusters than the card holds at once at the
    width's own cluster size, so the plan shrinks them or they queue."""
    trav, src = _grids(22, 40, 482, 482, cuda)
    assert fmm_sweep.launch_plan(1, trav, 16, fused_chunk=4).cluster >= 1
    got, want = _fused_case(trav, src, rounds=1, block=16, inner=8,
                            scan_chunk=4, vscan=True)
    assert torch.equal(got, want)


def test_fused_eikonal_carry_isolated_between_grids(cuda):
    """Each grid of a batch solved by clusters of 8 equals the same grid
    solved alone: neither the carry nor a ghost row reaches another grid."""
    trav, src = _boundary_grids(23, 3, 40, 482, 2, cuda, rows=True, ghost=4)
    kw = dict(rounds=2, block=16, inner=8, scan_chunk=4, vscan=True,
              cluster=8)
    got = fused_eikonal(trav, src, **kw)
    for i in range(3):
        sl = slice(i, i + 1)
        assert torch.equal(got[sl], fused_eikonal(trav[sl], src[sl], **kw))


def test_fused_eikonal_takes_lines_past_1024(cuda):
    """Rows and columns of 1025 cells solve, bit-equal to the plain
    version, and so do rows too wide for scan_chunk ghost rows a side and
    lines over 2048 cells; lines over 4096 cells too, through the
    long-line kernel."""
    for shape in ((1, 16, 1025), (1, 1025, 16), (1, 16, 1700),
                  (1, 2049, 16), (1, 4097, 16)):
        trav, src = _grids(24, *shape, cuda)
        got = fused_eikonal(trav, src)
        assert torch.equal(got, fused_eikonal_reference(trav, src))
    with pytest.raises(ValueError):      # not a cluster size
        fused_eikonal(*_grids(24, 1, 16, 64, cuda), cluster=3)


@pytest.mark.parametrize("shape,vscan", [((2, 48, 1040), False),
                                         ((2, 48, 1040), True),
                                         ((2, 1040, 48), True),
                                         ((1, 2000, 48), True),
                                         ((1, 2048, 40), True)])
@pytest.mark.parametrize("cluster", [None, 1])
def test_fused_eikonal_past_1024_equals_plain(cuda, shape, vscan, cluster):
    """A pair of warps a line: rows of 1040 cells, columns of up to 2048
    (the column scans), bit-equal to the plain version."""
    trav, src = _grids(25, *shape, cuda)
    kw = dict(rounds=2, block=8, inner=24, scan_chunk=4, vscan=vscan)
    got = fused_eikonal(trav, src, cluster=cluster, **kw)
    want = fused_eikonal_reference(trav, src, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.isfinite(got).sum() > got.numel() // 2


@pytest.mark.parametrize("shape,vscan,block,cluster", [
    ((1, 24, 1600), False, 8, None), ((1, 40, 1060), False, 8, None),
    ((1, 40, 1060), False, 16, 1), ((2, 1300, 40), True, 8, None),
    ((2, 1300, 40), True, 16, 1), ((1, 2048, 24), True, 8, None),
    ((1, 24, 3100), False, 8, None), ((1, 24, 4096), False, 16, None),
    ((2, 4096, 24), True, 8, None), ((1, 3000, 40), True, 16, 1)])
def test_fused_eikonal_runs_across_the_pair_boundary(cuda, shape, vscan,
                                                      block, cluster):
    """Lines whose wall-free runs cross cells 1024, 2048 and 3072, where
    the warps of a line's group meet, and a line without walls; a cluster
    of one runs its 16 rows with all of its groups, in turns."""
    trav, src = _grids(27, *shape, cuda)
    if vscan:
        for c in (1024, 2048, 3072):
            trav[:, c - 24:c + 26, :] = True
        trav[:, :, 3] = True
    else:
        for c in (1024, 2048, 3072):
            trav[:, :, c - 24:c + 26] = True
        trav[:, 3, :] = True
    kw = dict(rounds=2, block=block, inner=8, scan_chunk=4, vscan=vscan)
    got = fused_eikonal(trav, src, cluster=cluster, **kw)
    want = fused_eikonal_reference(trav, src, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(3, 50, 37), (2, 49, 64), (1, 482, 482),
                                   (1, 960, 960)])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("scan_chunk", [1, 4])
def test_block_sweep_kernel_equals_plain(cuda, shape, reverse, scan_chunk):
    trav, src = _grids(4, *shape, cuda)
    wall = ~trav & ~src
    # from a field swept the other way, as the composed schedule's second
    # sweep of each orientation starts
    d = block_sweep_reference(torch.where(src, 0.0, fmm.BIG).float(), wall,
                              not reverse, scan_chunk=scan_chunk)
    before = block_sweep.launches
    got = block_sweep(d, wall, reverse, scan_chunk=scan_chunk)
    assert block_sweep.launches == before + 1
    want = block_sweep_reference(d, wall, reverse, scan_chunk=scan_chunk)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("w,cluster", [
    (w, c) for w in (1025, 1040, 1500, 2000, 2048) for c in (None, 6)] + [
    (w, c) for w in (2049, 3000, 4096) for c in (None, 16)])
@pytest.mark.parametrize("reverse", [False, True])
def test_block_sweep_rows_past_1024_equal_plain(cuda, w, reverse, cluster):
    """Rows of 33-128 chunks (two or four a lane in the scans' second
    phase), walls placed so that runs cross chunks 32, 64 and 96,
    bit-equal to the plain version."""
    trav, src = _grids(26, 2, 40, w, cuda)
    for c in (1024, 2048, 3072):
        trav[:, :, c - 4:c + 6] = True   # a run across chunk c / 32
    trav[:, 5, :] = True                 # a row without walls
    wall = ~trav & ~src
    d = block_sweep_reference(torch.where(src, 0.0, fmm.BIG).float(), wall,
                              not reverse)
    got = block_sweep(d, wall, reverse, cluster=cluster)
    want = block_sweep_reference(d, wall, reverse)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # past 4096 cells the long-line kernel
    trav, src = _grids(26, 1, 16, 4097, cuda)
    wall = ~trav & ~src
    d = fmm._axis_relax(torch.where(src, 0.0, fmm.BIG).float(), wall)
    assert torch.equal(block_sweep(d, wall, reverse),
                       block_sweep_reference(d, wall, reverse))


@pytest.mark.parametrize("kernel,shape,kw", [
    ("B4", (1, 48, 8192), {}), ("B4", (1, 16, 40000), {}),
    ("B4", (2, 37, 4100), dict(block=8, scan_chunk=4, reverse=True)),
    ("B4", (3, 5, 4500), dict(block=16, inner=8)),
    ("B1", (1, 4200, 24), dict(block=8, vscan=True)),
    ("B1", (1, 16, 6000), dict(block=8, vscan=True)),
    ("B1", (1, 300, 4100), dict(block=16, inner=40, rounds=2,
                                vscan=False)),
    ("B1", (3, 41, 4500), dict(block=8, inner=8, rounds=1, vscan=True)),
    ("B2", (1, 16, 20000), {}), ("B2", (1, 37, 19281), dict(reverse=True)),
    ("B2", (2, 20, 40000), dict(block=8, inner=8))])
def test_long_line_kernels_equal_plain(cuda, kernel, shape, kw):
    """Lines past the shared-memory kernels (order 1 over 4096 cells, B2
    rows past its shared memory at C = 16) run through the long-line
    kernels, one launch a call, bit-equal to the plain versions, ragged
    row blocks and both directions included."""
    trav, src = _grids(29, *shape, cuda)
    wall = ~trav & ~src
    kw = dict(kw)
    reverse = kw.pop("reverse", False)
    if kernel == "B1":
        run = lambda: fused_eikonal(trav, src, **kw)        # noqa: E731
        want = fused_eikonal_reference(trav, src, **kw)
        counter = fmm_long.fused_eikonal_long
    elif kernel == "B4":
        d = fmm._axis_relax(torch.where(src, 0.0, fmm.BIG).float(), wall)
        run = lambda: block_sweep(d, wall, reverse, **kw)   # noqa: E731
        want = block_sweep_reference(d, wall, reverse, **kw)
        counter = fmm_long.block_sweep_long
    else:
        d = torch.where(src, 0.0, fmm.BIG).float()
        run = lambda: block_sweep2(d, wall, src, reverse, **kw)  # noqa
        want = block_sweep2_reference(d, wall, src, reverse, **kw)
        counter = fmm_long.block_sweep2_long
    before = counter.launches
    got = run()
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert torch.equal(got, want)
    assert torch.isfinite(got).sum() > 0


@pytest.mark.parametrize("kernel,shape,kw", [
    ("B1", (1, 1608, 1608), dict(block=8, vscan=False)),
    ("B1", (1, 1608, 1608), dict(block=8, vscan=True)),
    ("B1", (16, 1700, 1700), dict(block=16, inner=40, rounds=2,
                                  vscan=False)),
    ("B1", (2, 4096, 48), dict(block=8, vscan=True)),
    ("B4", (1, 48, 2049), {}), ("B4", (1, 48, 4096), {})])
def test_order1_kernels_past_the_old_limits(cuda, kernel, shape, kw):
    """The grids that raised before the order-1 kernels took lines of up
    to 4096 cells and rows past B1's ghost rows' shared memory: bit-equal
    to the plain versions."""
    trav, src = _grids(28, *shape, cuda)
    if kernel == "B1":
        got = fused_eikonal(trav, src, **kw)
        want = fused_eikonal_reference(trav, src, **kw)
    else:
        wall = ~trav & ~src
        d = fmm._axis_relax(torch.where(src, 0.0, fmm.BIG).float(), wall)
        got = block_sweep(d, wall, False)
        want = block_sweep_reference(d, wall, False)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.isfinite(got).sum() > got.numel() // 2


def test_block_sweep_carry_isolated_between_grids(cuda):
    """A grid's sweep does not see its batch neighbours: each grid of a
    batch equals the same grid swept alone (the carry starts anew)."""
    trav, src = _grids(5, 3, 40, 36, cuda)
    wall = ~trav & ~src
    d = torch.where(src, 0.0, fmm.BIG).float()
    got = block_sweep(d, wall, False, block=16, inner=20)
    for i in range(3):
        alone = block_sweep(d[i:i + 1], wall[i:i + 1], False, block=16,
                            inner=20)
        assert torch.equal(got[i:i + 1], alone)


@pytest.mark.parametrize("shape", [(3, 50, 37), (2, 49, 64), (1, 482, 482),
                                   (1, 960, 960)])
@pytest.mark.parametrize("reverse", [False, True])
def test_block_sweep2_kernel_equals_plain(cuda, shape, reverse):
    trav, src = _grids(1, *shape, cuda)
    wall = ~trav & ~src
    d = block_sweep2_reference(torch.where(src, 0.0, fmm.BIG).float(), wall,
                               src, not reverse)
    before = block_sweep2.launches
    got = block_sweep2(d, wall, src, reverse)
    assert block_sweep2.launches == before + 1
    want = block_sweep2_reference(d, wall, src, reverse)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _boundary_grids(seed, b, h, w, seg, dev, rows=False, ghost=0):
    """Random grids with sources on both sides of every segment boundary
    and a wall along each boundary with a door in it, so that distances
    cross every boundary of a cluster's segments: columns every ``seg``
    cells, or (``rows``) rows every ``seg`` rows of each 16-row block, and
    with ``ghost`` also the edges of each segment's ``ghost`` rows beyond
    it on either side (the fused solve's ghost rows)."""
    trav, src = _grids(seed, b, h, w, dev)
    if rows:
        trav, src = trav.transpose(1, 2), src.transpose(1, 2)
        edges = {lo + d for lo in range(0, 16, seg)
                 for d in ((0, -ghost, seg + ghost) if ghost else (0,))}
        cuts = [r for r in range(1, h) if r % 16 % seg == 0
                or r % 16 in edges]
    else:
        cuts = range(seg, w, seg)
    n = trav.shape[1]
    for c in cuts:
        trav[:, :, c - 1] = False
        trav[:, n // 3:n // 3 + 3, c - 1] = True
        src[:, n // 2, c] = True
        src[:, n // 4, c - 1] = True
    if rows:
        trav, src = trav.transpose(1, 2), src.transpose(1, 2)
    return trav.contiguous(), src.contiguous()


def _sweep_case(order, trav, src, reverse, **kw):
    """The kernel's sweep and the plain version's, from a field swept the
    other way (as the schedules' second sweeps start)."""
    wall = ~trav & ~src
    d0 = torch.where(src, 0.0, fmm.BIG).float()
    plain_kw = {k: v for k, v in kw.items() if k != "cluster"}
    if order == 1:
        d = block_sweep_reference(d0, wall, not reverse, **plain_kw)
        got = block_sweep(d, wall, reverse, **kw)
        want = block_sweep_reference(d, wall, reverse, **plain_kw)
    else:
        d = block_sweep2_reference(d0, wall, src, not reverse, **plain_kw)
        got = block_sweep2(d, wall, src, reverse, **kw)
        want = block_sweep2_reference(d, wall, src, reverse, **plain_kw)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("cluster", [1, 2, 4, 6, 8, 16])
@pytest.mark.parametrize("w", [37, 64, 481, 482, 960, 1024])
@pytest.mark.parametrize("reverse", [False, True])
def test_sweep_kernels_equal_plain_at_every_cluster(cuda, order, cluster, w,
                                                    reverse):
    """Both sweeps at every forced cluster size, bit-equal, with walls and
    sources on the segment boundaries and a ragged last row block (50 =
    3 x 16 + 2 rows)."""
    try:
        plan = fmm_sweep.sweep_plan(order, 1, w, 16, {}, cluster=cluster)
    except ValueError:
        # a split the kernel does not take (tests/test_torch_sweep_plan.py)
        return
    if fmm_sweep.resident_clusters(order, w, 16, cuda)[cluster] < 1:
        pytest.skip(f"this card holds no cluster of {cluster} blocks")
    trav, src = _boundary_grids(10 + cluster, 1, 50, w, plan.seg, cuda,
                                rows=order == 1)
    got, want = _sweep_case(order, trav, src, reverse, cluster=cluster)
    assert torch.equal(got, want)


@pytest.mark.parametrize("w", [64, 482])
@pytest.mark.parametrize("kw", [dict(scan_chunk=4), dict(inner=0),
                                dict(inner=0, scan_chunk=4),
                                dict(block=8, inner=12, scan_chunk=3)])
def test_block_sweep_scan_chunk_and_inner(cuda, w, kw):
    trav, src = _boundary_grids(11, 2, 41, w, -(-w // 8), cuda)
    for reverse in (False, True):
        got, want = _sweep_case(1, trav, src, reverse, **kw)
        assert torch.equal(got, want)
    if kw.get("inner") == 0:      # no pass: the field comes back as it went
        assert torch.equal(got, block_sweep(got, ~trav & ~src, **kw))


@pytest.mark.parametrize("w", [64, 482])
def test_block_sweep2_inner_zero_and_short_blocks(cuda, w):
    trav, src = _boundary_grids(12, 2, 41, w, -(-w // 8), cuda)
    for kw in (dict(inner=0), dict(block=2, inner=3), dict(block=5, inner=7)):
        for reverse in (False, True):
            got, want = _sweep_case(2, trav, src, reverse, **kw)
            assert torch.equal(got, want)


@pytest.mark.parametrize("order", [1, 2])
def test_sweeps_on_more_grids_than_resident_clusters(cuda, order):
    """40 planning grids: more clusters than the card holds at once at the
    width's own cluster size, so the plan shrinks them or they queue."""
    trav, src = _grids(13, 40, 482, 482, cuda)
    plan = fmm_sweep.launch_plan(order, trav, 16)
    assert plan.cluster >= 1
    got, want = _sweep_case(order, trav, src, False)
    assert torch.equal(got, want)


@pytest.mark.parametrize("order", [1, 2])
def test_sweep_carry_isolated_between_grids_in_clusters(cuda, order):
    """Each grid of a batch swept by clusters of 8 equals the same grid
    swept alone: neither the carry nor a halo reaches another grid."""
    trav, src = _boundary_grids(14, 3, 40, 482, 2 if order == 1 else 61,
                                cuda, rows=order == 1)
    wall = ~trav & ~src
    d = torch.where(src, 0.0, fmm.BIG).float()
    sweep = ((lambda x, m, s: block_sweep(x, m, cluster=8, inner=20))
             if order == 1 else
             (lambda x, m, s: block_sweep2(x, m, s, cluster=8, inner=20)))
    got = sweep(d, wall, src)
    for i in range(3):
        sl = slice(i, i + 1)
        assert torch.equal(got[sl], sweep(d[sl], wall[sl], src[sl]))


def test_sweep_plans_agree_with_the_kernels(cuda):
    """The plan's shared-memory bytes are the kernels' own, and the card
    holds the paths' plans (B1's clusters above one at its path shapes)."""
    for w in (37, 242, 482, 960, 1024):
        for order in (1, 2):
            plan = fmm_sweep.sweep_plan(order, 1, w, 16,
                                        fmm_sweep.resident_clusters(
                                            order, w, 16, cuda))
            if order == 1:
                c_bytes = fmm_sweep._lib1().block_sweep_smem_bytes(
                    w, plan.seg)
            else:
                c_bytes = fmm_sweep._lib2().block_sweep2_smem_bytes(
                    plan.seg, 16)
            assert c_bytes == plan.smem_bytes
            assert fmm_sweep.resident_clusters(
                order, w, 16, cuda)[plan.cluster] >= 1
    assert fmm_sweep.launch_plan(
        2, torch.zeros(16, 482, 482, device=cuda), 16).cluster > 1
    from peanut_tpu_torch.kernels import fmm_fused
    for b, h, w, block in ((16, 482, 482, 16), (8, 480, 480, 8),
                           (16, 962, 962, 16), (2, 50, 37, 16)):
        plan = fmm_sweep.launch_plan(1, torch.zeros(b, h, w, device=cuda),
                                     block, fused_chunk=4)
        assert fmm_fused._lib().fused_eikonal_smem_bytes(
            h, w, block, plan.seg, 4) == plan.smem_bytes
        assert fmm_sweep.resident_clusters(
            1, w, block, cuda, (h, 4))[plan.cluster] >= b
        assert plan.cluster > 1


@pytest.mark.parametrize("order", [1, 2])
def test_eikonal_schedules_on_the_card(cuda, order):
    """Fused (3-D), composed 3-D and 2-D solves through the kernels equal
    the plain versions bit for bit; the composed ones launch B4."""
    trav, src = _grids(2, 4, 90, 70, cuda)
    for grids, schedule in (((trav, src), None),
                            ((trav, src), "composed"),
                            ((trav[1], src[1]), None)):
        b4 = block_sweep.launches
        got = fmm.eikonal_distance(*grids, order=order, schedule=schedule)
        want = fmm.eikonal_distance(*grids, order=order, schedule=schedule,
                                    plain=True)
        assert torch.equal(got, want)
        composed = schedule == "composed" or grids[0].ndim == 2
        assert (block_sweep.launches > b4) == composed
    with pytest.raises(ValueError):
        block_sweep2(torch.zeros(2, 8, 8), torch.zeros(2, 8, 8, dtype=bool),
                     torch.zeros(2, 8, 8, dtype=bool))
    with pytest.raises(ValueError):
        block_sweep(torch.zeros(2, 8, 8, device=cuda),
                    torch.zeros(2, 8, 8, dtype=bool, device=cuda), inner=10,
                    scan_chunk=4)


def _roi_inputs(seed, n, p, win_y, win_x, hs, ws, c, dev, dtype):
    rng = np.random.RandomState(seed)
    flat = torch.as_tensor(rng.standard_normal((hs, ws, c)).astype(
        np.float32), device=dev).to(dtype)
    # hat-like weights: nonnegative, with zero rows/columns around a support
    ay = rng.rand(n, p, win_y).astype(np.float32)
    ax = rng.rand(n, p, win_x).astype(np.float32)
    ay[:, :, :win_y // 4] = 0.0
    ax[:, :, win_x - win_x // 3:] = 0.0
    ay[0] = 0.0                                     # an empty ROI
    # origins inside, across and beyond every edge of the buffer
    row0 = rng.randint(-win_y, hs, n).astype(np.int32)
    col0 = rng.randint(-win_x, ws, n).astype(np.int32)
    return (flat, torch.as_tensor(ay, device=dev),
            torch.as_tensor(ax, device=dev), torch.as_tensor(row0, device=dev),
            torch.as_tensor(col0, device=dev))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-5)])
@pytest.mark.parametrize("p,win_y,win_x", [(7, 40, 40), (14, 40, 40),
                                           (7, 26, 274), (14, 208, 26),
                                           (7, 8, 24)])
def test_roi_window_pool_kernel_matches_plain(cuda, dtype, tol, p, win_y,
                                              win_x):
    args = _roi_inputs(3, 37, p, win_y, win_x, 90, 300, 136, cuda, dtype)
    before = roi_window_pool.launches
    got = roi_window_pool(*args, win_y, win_x)
    assert roi_window_pool.launches == before + 1
    want = roi_window_pool_reference(*args, win_y, win_x)
    torch.cuda.synchronize()
    assert got.shape == (37, p, p, 136) and got.dtype == torch.float32
    assert torch.count_nonzero(got[0]) == 0
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,win_y,win_x,hs,ws", [
    (7, 40, 40, 200, 272), (7, 26, 274, 60, 272), (7, 208, 26, 208, 100),
    (14, 40, 40, 100, 136), (14, 208, 26, 208, 60)])
def test_roi_window_pool_error_far_under_the_bar(cuda, dtype, p, win_y,
                                                 win_x, hs, ws):
    """The path's window shapes at C = 256 with hat-matrix supports (two
    taps a sample), origins across every edge of the buffer, a ROI without
    support on either axis: the kernel (bf16 on the tensor cores, their
    accumulation order) stays an order of magnitude under the 2e-5 x max
    bar of its plain version."""
    rng = np.random.RandomState(p + win_y + win_x)
    n = 64
    flat = torch.as_tensor(rng.standard_normal((hs, ws, 256)).astype(
        np.float32), device=cuda).to(dtype)

    def hats(length, count):
        out = np.zeros((n, p, length), np.float32)
        for i in range(n):
            span = rng.randint(1, length - 1)
            lo = rng.randint(0, length - span)
            for q in range(p):
                for s in range(count):
                    x = lo + (q + (s + 0.5) / count) * span / p
                    f = int(np.floor(x))
                    out[i, q, f] += 1.0 - (x - f)
                    if f + 1 < length:
                        out[i, q, f + 1] += x - f
        return out
    ay, ax = hats(win_y, 2), hats(win_x, 2)
    ay[1] = 0.0                                   # no rows
    ax[2] = 0.0                                   # no columns
    row0 = rng.randint(-win_y, hs, n).astype(np.int32)
    col0 = rng.randint(-win_x, ws, n).astype(np.int32)
    args = (flat, *(torch.as_tensor(a, device=cuda)
                    for a in (ay, ax, row0, col0)), win_y, win_x)
    got = roi_window_pool(*args)
    want = roi_window_pool_reference(*args)
    torch.cuda.synchronize()
    assert torch.count_nonzero(got[1]) == 0
    assert torch.count_nonzero(got[2]) == 0
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= 2e-6 * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_window_pool_parts(cuda, dtype):
    """The breakdown's launches: the whole pool equals the wrapper's, with
    ring stages of any size (a stage's columns are contracted in window
    order), the write alone (and with the loads) writes zeros; none is
    counted."""
    from peanut_tpu_torch.kernels.roi_window import roi_window_pool_part
    args = _roi_inputs(3, 37, 7, 26, 274, 90, 300, 136, cuda, dtype)
    want = roi_window_pool(*args, 26, 274)
    before = roi_window_pool.launches
    assert torch.equal(roi_window_pool_part(*args, 26, 274, "whole"), want)
    for rows in (32, 64, 128, 256):
        assert torch.equal(roi_window_pool_part(*args, 26, 274, "whole",
                                                rows=rows), want)
    for part in ("write", "load_write"):
        assert torch.count_nonzero(
            roi_window_pool_part(*args, 26, 274, part)) == 0
    assert roi_window_pool.launches == before


def test_roi_window_pool_bar_sees_unrounded_ay(cuda):
    """In bfloat16 the pool rounds A_y before it meets the window.  A pool
    that skipped it (the plain version over a float32 copy of the same
    values) misses the 2e-5 bar the kernel meets."""
    args = _roi_inputs(3, 37, 7, 40, 40, 90, 300, 136, cuda, torch.bfloat16)
    got = roi_window_pool(*args, 40, 40)
    unrounded = roi_window_pool_reference(args[0].float(), *args[1:], 40, 40)
    torch.cuda.synchronize()
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, unrounded, rtol=2e-5, atol=2e-5)


def test_roi_window_pool_reads_outside_as_zero(cuda):
    """A window half outside the buffer pools only its inside part: the
    same window over a zero-padded copy gives the same result."""
    flat, ay, ax, _, _ = _roi_inputs(4, 4, 7, 16, 16, 20, 24, 64, cuda,
                                     torch.float32)
    ay = torch.ones_like(ay)
    ax = torch.ones_like(ax)
    row0 = torch.tensor([-8, 12, -30, 0], dtype=torch.int32, device=cuda)
    col0 = torch.tensor([-8, 16, 0, 40], dtype=torch.int32, device=cuda)
    got = roi_window_pool(flat, ay, ax, row0, col0, 16, 16)
    padded = torch.nn.functional.pad(flat, (0, 0, 16, 16, 16, 16))
    want = roi_window_pool_reference(padded, ay, ax, row0 + 16, col0 + 16,
                                     16, 16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert torch.count_nonzero(got[2]) == 0 and torch.count_nonzero(got[3]) == 0
    with pytest.raises(ValueError):
        roi_window_pool(flat, ay[:, :3], ax[:, :3], row0, col0, 16, 16)


@pytest.mark.parametrize("problems,n,density", [
    (40, 1000, 0.003), (8, 1000, 0.03), (3, 70, 0.2), (1, 1, 0.0)])
def test_nms_keep_kernel_equals_plain(cuda, problems, n, density):
    rng = np.random.RandomState(6)
    sup = torch.as_tensor(np.triu(rng.rand(problems, n, n) < density, 1),
                          device=cuda)
    valid = torch.as_tensor(rng.rand(problems, n) > 0.05, device=cuda)
    before = nms_keep.launches
    got = nms_keep(sup, valid)
    assert nms_keep.launches == before + 1
    assert torch.equal(got, nms_keep_reference(sup, valid))
    # a suppression chain: every other box kept, n/2 bounding rounds
    chain = torch.ones(1000, 1000, dtype=torch.bool,
                       device=cuda).triu(1).tril(1)
    ones = torch.ones(1000, dtype=torch.bool, device=cuda)
    assert torch.equal(nms_keep(chain, ones), nms_keep_reference(chain, ones))
    assert int(nms_keep(chain, ones).sum()) == 500


@pytest.mark.parametrize("problems,n", [(3, 33), (2, 1025), (2, 1312),
                                        (2, 1400), (1, 3001)])
def test_nms_keep_packed_walk_equals_plain(cuda, problems, n):
    """n not a multiple of 32, past 32 words, and past the shared-memory
    bit matrix (~1300 boxes: the rows stream through the ring), with noise
    below the diagonal that the kernels must not read; and the adversarial
    chain (each box suppresses only the next) at those n."""
    rng = np.random.RandomState(n)
    sup = np.triu(rng.rand(problems, n, n) < 0.004, 1)
    sup |= np.tril(rng.rand(problems, n, n) < 0.5)
    sup_t = torch.as_tensor(sup, device=cuda)
    valid = torch.as_tensor(rng.rand(problems, n) > 0.05, device=cuda)
    got = nms_keep(sup_t, valid)
    assert torch.equal(got, nms_keep_reference(sup_t.triu(1), valid))
    chain = torch.ones(n, n, dtype=torch.bool, device=cuda).triu(1).tril(1)
    ones = torch.ones(n, dtype=torch.bool, device=cuda)
    got = nms_keep(chain, ones)
    assert torch.equal(got, torch.arange(n, device=cuda) % 2 == 0)


def test_nms_fixed_on_the_card_equals_the_cpu(cuda):
    from peanut_tpu_torch.models import boxes as tboxes
    rng = np.random.RandomState(7)
    xy = rng.rand(2, 1000, 2).astype(np.float32) * 700
    wh = rng.rand(2, 1000, 2).astype(np.float32) * 200 + 2
    b = np.concatenate([xy, xy + wh], -1)
    s = np.round(rng.rand(2, 1000).astype(np.float32) * 16) / 16
    s[:, -50:] = -np.inf
    cls = rng.randint(0, 9, (2, 1000))
    want = tboxes.batched_nms(*map(torch.as_tensor, (b, s, cls)), 0.5)
    got = tboxes.batched_nms(*(torch.as_tensor(x, device=cuda)
                               for x in (b, s, cls)), 0.5)
    assert torch.equal(got.cpu(), want)


def test_runtime_ticks_on_the_card(cuda):
    from peanut_tpu_torch.config import NavConfig
    from peanut_tpu_torch.envs import FakeNavEnv
    from peanut_tpu_torch.envs.batch_runner import BatchRunner

    cfg = NavConfig(
        env_frame_width=64, env_frame_height=48, frame_width=64,
        frame_height=48, map_size_cm=1200, vision_range=48,
        num_local_steps=10, use_gt_seg=1, only_explore=1, switch_step=999)
    runner = BatchRunner(cfg, [lambda s=s: FakeNavEnv(cfg, seed=s)
                               for s in range(3)], device=cuda)
    f0, b0 = fused_eikonal.launches, block_sweep2.launches
    out = runner.run(max_ticks=3)
    runner.close()
    assert out["env_steps"] == 9
    assert fused_eikonal.launches > f0 and block_sweep2.launches > b0
    assert runner.runtime.state.local_maps.is_cuda


def test_single_env_agent_on_the_card(cuda):
    """The single-env agent steps on the card; its 2-D planning solves
    launch B4 and B2."""
    from peanut_tpu_torch.agent import PeanutAgent
    from peanut_tpu_torch.config import NavConfig
    from peanut_tpu_torch.envs import FakeNavEnv

    cfg = NavConfig(
        env_frame_width=64, env_frame_height=48, frame_width=64,
        frame_height=48, map_size_cm=1200, vision_range=48,
        num_local_steps=10, use_gt_seg=1, only_explore=1, switch_step=999)
    agent = PeanutAgent(cfg, device=cuda)
    env = FakeNavEnv(cfg, seed=0, max_steps=4)
    b4, b2 = block_sweep.launches, block_sweep2.launches
    obs = env.reset()
    agent.reset()
    while not env.episode_over:
        obs = env.step(agent.act(obs))
    assert block_sweep.launches > b4 and block_sweep2.launches > b2
    assert agent.agent_state.local_map[1].sum() > 0


def test_prediction_model_on_the_card_matches_the_cpu(cuda):
    """PSPNet-R50-v1c in float32 on the card (cuDNN with TF32 off, as the
    agent sets it) against the CPU: probabilities within 1e-4 (the two
    sum the convolutions in other orders)."""
    from peanut_tpu_torch.config import NavConfig
    from peanut_tpu_torch.models.pspnet import (build_segmentor,
                                                peanut_prediction_config)
    from peanut_tpu_torch.prediction import PredictionModel

    full_map = np.random.RandomState(9).rand(14, 96, 80).astype(np.float32)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        probs = [PredictionModel(NavConfig(), model=build_segmentor(
            peanut_prediction_config(), seed=0), device=dev).get_prediction(
                full_map) for dev in ("cpu", cuda)]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert probs[1].shape == (6, 96, 80) and np.isfinite(probs[1]).all()
    np.testing.assert_allclose(probs[1], probs[0], rtol=0, atol=1e-4)


@pytest.mark.parametrize("profile", [
    dict(dd_downscale=2, dd_order=1, dd_block=8, dd_inner=24, plan_block=8,
         plan_inner=24, pred_async=1),
    dict(dd_downscale=1)])
def test_serving_tick_with_prediction_on_the_card(cuda, profile):
    """bench.py's serving and exact profiles at a small geometry: trigger
    ticks launch B1 (the goal-weighting solve), and the prediction branch
    through the kernels equals it through the plain versions (actions,
    goals, target_pred and dd_wt bit for bit)."""
    from peanut_tpu_torch.agent.batched_runtime import BatchedNavRuntime
    from peanut_tpu_torch.config import NavConfig
    from peanut_tpu_torch.envs import FakeNavEnv
    from peanut_tpu_torch.models.pspnet import build_segmentor
    from peanut_tpu_torch.prediction import PredictionModel

    cfg = NavConfig(
        env_frame_width=64, env_frame_height=48, frame_width=64,
        frame_height=48, map_size_cm=1200, vision_range=48,
        prediction_window=160, use_gt_seg=1, update_goal_freq=3, **profile)
    tiny = dict(type="EncoderDecoder",
                backbone=dict(type="ResNetV1c", base_channels=8,
                              stem_channels=8, in_channels=14),
                decode_head=dict(type="PSPHead", in_channels=256,
                                 channels=16, num_classes=6))
    pm = PredictionModel(cfg, model=build_segmentor(tiny, seed=0),
                         device=cuda)
    runs = []
    for plain in (False, True):
        rt = BatchedNavRuntime(cfg, 3, prediction_model=pm, device=cuda,
                               plain=plain)
        envs = [FakeNavEnv(cfg, seed=s) for s in range(3)]
        obs = [e.reset() for e in envs]
        for i in range(3):
            rt.reset_env(i)
        f0 = fused_eikonal.launches
        acts, fields = [], []
        for _ in range(5):
            out = rt.act_batch(obs)
            rt.wait_pending_goal()
            acts.append([a["action"] for a in out])
            fields.append([getattr(rt.state, k).cpu() for k in
                           ("cur_goal", "target_pred", "dd_wt")])
            obs = [e.step(a) for e, a in zip(envs, out)]
        runs.append((acts, fields, fused_eikonal.launches - f0))
        assert bool(rt.state.dd_valid.all())
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    # the kernel run's goal solves launch B1 beside its planning solves
    assert runs[0][2] > runs[1][2] > 0


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One train step of the tiny PSPNet (base width 8, batch 2, crop 64,
    dropout 0) from the same state on the card and the CPU, in float64:
    loss within 1e-5 relative, gradients within 1e-4 of the largest
    |gradient| (float32 gradients of this net are rounding-bound:
    tests/test_torch_training.py); the running statistics move alike."""
    from peanut_tpu_torch.models.pspnet import (build_segmentor,
                                                peanut_prediction_config)
    from peanut_tpu_torch.prediction.train import (TrainConfig,
                                                   create_train_state,
                                                   loss_and_grads)

    def tiny_cfg():
        cfg = peanut_prediction_config()
        cfg["backbone"].update(base_channels=8, stem_channels=8)
        cfg["decode_head"].update(in_channels=256, channels=64,
                                  dropout_ratio=0.0)
        cfg["auxiliary_head"].update(in_channels=128, channels=32,
                                     dropout_ratio=0.0)
        return cfg

    rng = np.random.RandomState(10)
    img = rng.rand(2, 14, 64, 64) * np.float64([1, 3])[:, None, None, None]
    gt = (rng.rand(2, 6, 64, 64) > 0.9) * 255.0
    tcfg = TrainConfig(lr=1e-3, max_iters=50)
    out = {}
    for where in ("cpu", cuda):
        state = create_train_state(build_segmentor(tiny_cfg(), seed=0)
                                   .double(), tcfg, device=where)
        batch = {"img": torch.as_tensor(img, device=where),
                 "gt": torch.as_tensor(gt, device=where)}
        loss = float(loss_and_grads(state, batch, tcfg)["loss"])
        out[str(where)] = (loss, {n: p.grad.cpu() for n, p in
                                  state.model.named_parameters()},
                           {k: v.cpu() for k, v in
                            state.model.state_dict().items()})
    (lc, gc, sc), (lg, gg, sg) = out["cpu"], out[str(cuda)]
    assert lg == pytest.approx(lc, rel=1e-5)
    top = max(float(g.abs().max()) for g in gc.values())
    for n in gc:
        assert float((gg[n] - gc[n]).abs().max()) <= 1e-4 * top, n
    for n in sc:
        torch.testing.assert_close(sg[n], sc[n], rtol=1e-5, atol=1e-5)


def test_swin_on_the_card_matches_the_cpu(cuda):
    """UPerNet-Swin-T at its config's widths (150 classes), seeded, in
    float64 on the card and the CPU on a 96x160 input (its 24x40 patch
    grid pads to the 7x7 windows, the shifted blocks roll and mask):
    within 1e-8 of the largest |logit|."""
    import copy
    import os

    from peanut_tpu_torch.core.config_file import load_config
    from peanut_tpu_torch.models.builder import build_segmentor

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(
        root, "configs/swin/upernet_swin-t_512x512_160k_ade20k.py"))
    model = build_segmentor(cfg["model"], seed=0).double()
    x = torch.as_tensor(np.random.RandomState(11).rand(1, 3, 96, 160))
    with torch.no_grad():
        want = model(x)
        got = copy.deepcopy(model).to(cuda)(x.to(cuda)).cpu()
    assert got.shape == (1, 150, 96, 160)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-8 * float(want.abs().max())


def test_hrnet_on_the_card_matches_the_cpu(cuda):
    """FCN over HRNet-W18 at its config's widths (19 classes, all four
    branches upsampled and concatenated into the head), seeded, in
    float64 on the card and the CPU on a 128x256 input: within 1e-8 of
    the largest |logit|."""
    import copy
    import os

    from peanut_tpu_torch.core.config_file import load_config
    from peanut_tpu_torch.models.builder import build_segmentor

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(
        root, "configs/hrnet/fcn_hr18_512x1024_80k_cityscapes.py"))
    model = build_segmentor(cfg["model"], seed=0).double()
    x = torch.as_tensor(np.random.RandomState(12).rand(1, 3, 128, 256))
    with torch.no_grad():
        want = model(x)
        got = copy.deepcopy(model).to(cuda)(x.to(cuda)).cpu()
    assert got.shape == (1, 19, 128, 256)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-8 * float(want.abs().max())


def test_export_on_the_card_matches_eager(cuda, tmp_path):
    """cli.export of FCN over U-Net on the card at (1, 64, 64, 3): the
    reloaded program within rtol = atol = 1e-5 of the eager model (the
    JAX package's bar), TF32 off."""
    import os

    from peanut_tpu_torch import apis
    from peanut_tpu_torch.cli import export

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    config = os.path.join(root, "configs", "unet", "fcn_unet.py")
    out = str(tmp_path / "unet.pt2")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        export.export_segmentor(config, out, (1, 64, 64, 3), verify=True,
                                device=cuda)
        model = apis.init_segmentor(config, device=cuda).model
        x = torch.as_tensor(np.random.RandomState(13).rand(1, 64, 64, 3)
                            .astype(np.float32), device=cuda)
        with torch.no_grad():
            got = torch.export.load(out).module()(x)
            want = model.inference(x)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    assert got.device.type == "cuda" and got.shape == (1, 64, 64, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_converted_convnext_on_the_card_matches_the_cpu(cuda):
    """An mmcls ConvNeXt-T state dict of seeded values, converted
    (zoo_import.convert_mmcls_convnext) and laid into the port's ConvNeXt
    (converted_backbone_state): its features in float64 on the card and
    the CPU at 64x64, within 1e-9 of the largest."""
    import copy

    from peanut_tpu_torch.models.convnext import ConvNeXt
    from peanut_tpu_torch.models.mmseg_import import load_mmseg_state
    from peanut_tpu_torch.models.zoo_import import (converted_backbone_state,
                                                    convert_mmcls_convnext)

    rng = np.random.RandomState(14)
    sd, in_c = {}, 3
    for i, (nd, d) in enumerate(zip((3, 3, 9, 3), (96, 192, 384, 768))):
        t = f"backbone.downsample_layers.{i}"
        conv, norm = (0, 1) if i == 0 else (1, 0)
        k = 4 if i == 0 else 2
        sd[f"{t}.{conv}.weight"] = rng.randn(d, in_c, k, k) / (k * in_c)
        sd[f"{t}.{conv}.bias"] = 0.1 * rng.randn(d)
        sd[f"{t}.{norm}.weight"] = 1 + 0.1 * rng.randn(d if i == 0 else in_c)
        sd[f"{t}.{norm}.bias"] = 0.1 * rng.randn(d if i == 0 else in_c)
        for j in range(nd):
            b = f"backbone.stages.{i}.{j}"
            sd[f"{b}.depthwise_conv.weight"] = rng.randn(d, 1, 7, 7) / 7
            sd[f"{b}.depthwise_conv.bias"] = 0.1 * rng.randn(d)
            sd[f"{b}.norm.weight"] = 1 + 0.1 * rng.randn(d)
            sd[f"{b}.norm.bias"] = 0.1 * rng.randn(d)
            sd[f"{b}.pointwise_conv1.weight"] = rng.randn(4 * d, d) / d ** .5
            sd[f"{b}.pointwise_conv1.bias"] = 0.1 * rng.randn(4 * d)
            sd[f"{b}.pointwise_conv2.weight"] = (rng.randn(d, 4 * d)
                                                 / (4 * d) ** .5)
            sd[f"{b}.pointwise_conv2.bias"] = 0.1 * rng.randn(d)
            sd[f"{b}.gamma"] = 0.5 + rng.rand(d)
        sd[f"backbone.norm{i}.weight"] = 1 + 0.1 * rng.randn(d)
        sd[f"backbone.norm{i}.bias"] = 0.1 * rng.randn(d)
        in_c = d
    tree, leftovers = convert_mmcls_convnext(sd)
    assert leftovers == []
    backbone = ConvNeXt().double()
    load_mmseg_state(backbone, converted_backbone_state(tree, backbone))
    x = torch.as_tensor(np.random.RandomState(15).rand(1, 3, 64, 64))
    with torch.no_grad():
        want = backbone(x)
        got = [g.cpu() for g in copy.deepcopy(backbone).to(cuda)(x.to(cuda))]
    top = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-9 * top
