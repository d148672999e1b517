"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test asks the ``cuda`` fixture for the card and skips
without one (the decision is made inside the test, never at import).  On
the H100 (where JAX is not installed, hence no conftest):

    python -m pytest tests/test_torch_cuda.py -m gpu -q --noconftest

Tolerance: bitwise for the eikonal kernels (B1, B2, B4), which keep their plain
versions' operation order, scan association and rounding (see the notes in
kernels/csrc/*.cu), and for ``nms_keep`` (both give the unique greedy keep
set).  ``roi_window_pool`` sums in another association than its plain
version (x before y): rtol/atol 2e-5, in bfloat16 too, since both sides
contract the same bfloat16-rounded operands in float32.  The bfloat16 bar
of tests/test_roi_window.py (2e-2) would pass a kernel that skips rounding
A_y; 2e-5 does not (``test_roi_window_pool_bar_sees_unrounded_ay``).
"""

import numpy as np
import pytest
import torch

from peanut_tpu_torch.kernels import fmm
from peanut_tpu_torch.kernels.fmm_fused import (fused_eikonal,
                                                fused_eikonal_reference)
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
