"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test asks the ``cuda`` fixture for the card and skips
without one (the decision is made inside the test, never at import).  On
the H100 (where JAX is not installed, hence no conftest):

    python -m pytest tests/test_torch_cuda.py -m gpu -q --noconftest

Tolerance: bitwise.  Each kernel keeps its plain version's operation order,
scan association and rounding (see the notes in kernels/csrc/*.cu).
"""

import numpy as np
import pytest
import torch

from peanut_tpu_torch.kernels import fmm
from peanut_tpu_torch.kernels.fmm_fused import (fused_eikonal,
                                                fused_eikonal_reference)
from peanut_tpu_torch.kernels.fmm_sweep import (block_sweep2,
                                                block_sweep2_reference)

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


@pytest.mark.parametrize("shape", [(3, 50, 37), (2, 49, 64), (1, 482, 482)])
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


def test_eikonal_schedules_on_the_card(cuda):
    trav, src = _grids(2, 4, 90, 70, cuda)
    got = fmm.eikonal_distance(trav, src)           # fused, kernels
    want = fmm.eikonal_distance(trav, src, plain=True)
    assert torch.equal(got, want)
    with pytest.raises(NotImplementedError, match="B4"):
        fmm.eikonal_distance(trav, src, schedule="composed")
    with pytest.raises(NotImplementedError, match="B4"):
        fmm.eikonal_distance(trav[0], src[0])
    with pytest.raises(ValueError):
        block_sweep2(torch.zeros(2, 8, 8), torch.zeros(2, 8, 8, dtype=bool),
                     torch.zeros(2, 8, 8, dtype=bool))


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
