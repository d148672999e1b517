"""The port's eikonal solver against the JAX package's, on the CPU.

The plain PyTorch versions of the three CUDA eikonal kernels are held
against the TPU kernels run in interpret mode (as tests/test_fmm_pallas.py
runs them), the first-order sweep (B4) also against the JAX package's
``_v_sweep``, the composed schedule (3-D and 2-D) against the JAX package's
CPU path, the fused schedule against a JAX assembly of the same schedule and
against the heap-marching oracle.  Inputs are numpy arrays made from a seed.

Tolerances: the first-order sweep, the composed schedule and the planning
windows must be bit-equal to the JAX CPU path (the agents' decisions are
compared exactly, and the plain versions keep XLA's operation order and FMA
contractions); against the interpret-mode TPU kernels, atol 1e-4, the bound
of tests/test_fmm_pallas.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from peanut_tpu.agent import batched_ops as jops
from peanut_tpu.kernels import fmm as jfmm
from peanut_tpu.kernels.fmm_fused import fused_eikonal as jfused
from peanut_tpu.kernels.fmm_pallas import v_sweep2_pallas, v_sweep_pallas
from peanut_tpu_torch.agent import batched_ops as tops
from peanut_tpu_torch.kernels import fmm as tfmm
from peanut_tpu_torch.kernels.fmm_fused import (fused_eikonal,
                                                fused_eikonal_reference)
from peanut_tpu_torch.kernels.fmm_sweep import (block_sweep2_reference,
                                                block_sweep_reference,
                                                v_sweep, v_sweep2)

from heap_fmm_oracle import heap_fmm
from test_fmm_oracle import (MAX_CELL_ERR, MEAN_CELL_ERR, make_floorplan,
                             random_goal)

torch.set_num_threads(1)
BIG = tfmm.BIG
T = torch.from_numpy


def _assert_fields_close(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    m = np.isfinite(want)
    np.testing.assert_allclose(got[m], want[m], atol=atol, rtol=0)


@pytest.mark.parametrize("vscan", [False, True])
@pytest.mark.parametrize("rounds", [2, 4])
@pytest.mark.parametrize("block,inner", [(16, 40), (8, 24)])
def test_fused_reference_matches_pallas_interpret(vscan, rounds, block,
                                                  inner):
    rng = np.random.RandomState(0)
    b, h, w = 2, 48, 40
    trav = rng.rand(b, h, w) > 0.2
    src = np.zeros((b, h, w), bool)
    src[0, 10, 8] = src[1, 40, 30] = True
    kw = dict(rounds=rounds, block=block, inner=inner, scan_chunk=4,
              vscan=vscan)
    want = jfused(jnp.asarray(trav), jnp.asarray(src), bt=1,
                  interpret=True, **kw)
    got = fused_eikonal_reference(T(trav), T(src), **kw)
    _assert_fields_close(got, want, atol=1e-4)
    # the dispatcher takes the plain version for a CPU tensor
    np.testing.assert_array_equal(fused_eikonal(T(trav), T(src), **kw), got)


def _sweep_inputs(seed, shape):
    """The inputs of tests/test_fmm_pallas.py: point sources, 20% walls."""
    rng = np.random.RandomState(seed)
    d = np.where(rng.rand(*shape) > 0.95, 0.0, BIG).astype(np.float32)
    wall = rng.rand(*shape) > 0.8
    return np.where(wall, BIG, d).astype(np.float32), wall


SWEEP_SHAPES = [(2, 48, 40), (3, 50, 200), (1, 33, 33)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("scan_chunk", [1, 2, 5])
@pytest.mark.parametrize("shape", SWEEP_SHAPES)
def test_block_sweep_plain_bit_equal_to_jax(shape, scan_chunk, reverse):
    d, wall = _sweep_inputs(6, shape)
    kw = dict(block=16, inner=10, scan_chunk=scan_chunk)
    want = np.asarray(jfmm._v_sweep(jnp.asarray(d), jnp.asarray(wall),
                                    reverse, **kw))
    got = block_sweep_reference(T(d), T(wall), reverse, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    # the dispatcher takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        v_sweep(T(d), T(wall), reverse, **kw).numpy(), got)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape,scan_chunk", zip(SWEEP_SHAPES, [1, 2, 5]))
def test_block_sweep_plain_matches_pallas_interpret(shape, scan_chunk,
                                                    reverse):
    d, wall = _sweep_inputs(7, shape)
    kw = dict(block=16, inner=10, scan_chunk=scan_chunk)
    want = np.asarray(v_sweep_pallas(jnp.asarray(d), jnp.asarray(wall),
                                     reverse, interpret=True, **kw))
    got = block_sweep_reference(T(d), T(wall), reverse, **kw).numpy()
    np.testing.assert_allclose(np.minimum(got, 1e9), np.minimum(want, 1e9),
                               rtol=0, atol=1e-4)


def test_block_sweep_plain_carry_isolated_between_grids():
    """The case of tests/test_fmm_pallas.py: a source in grid 0 only; the
    carry must not leak into the other grids of the batch."""
    d = np.full((4, 32, 200), BIG, np.float32)
    d[0, 0, 0] = 0.0
    wall = np.zeros(d.shape, bool)
    got = block_sweep_reference(T(d), T(wall), False, block=16,
                                inner=10).numpy()
    assert (got[1:] >= 0.5 * BIG).all()
    assert got[0, 5, 0] < 10.0


@pytest.mark.parametrize("reverse", [False, True])
def test_block_sweep2_matches_pallas_and_composed(reverse):
    rng = np.random.RandomState(1)
    b, h, w = 2, 50, 37            # ragged: 50 = 3 x 16 + 2
    src = rng.rand(b, h, w) > 0.97
    wall = (rng.rand(b, h, w) > 0.8) & ~src
    # start from a partly converged field, as the refinement's later
    # sweeps do
    d = np.array(jfmm._v_sweep2(jnp.asarray(np.where(src, 0.0, BIG)
                                              .astype(np.float32)),
                                 jnp.asarray(wall), jnp.asarray(src),
                                 not reverse, block=16, inner=10))
    args = (jnp.asarray(d), jnp.asarray(wall), jnp.asarray(src), reverse)
    want_pallas = np.asarray(v_sweep2_pallas(*args, block=16, inner=10,
                                             interpret=True))
    want_xla = np.asarray(jfmm._v_sweep2(*args, block=16, inner=10))
    targs = (T(d), T(wall), T(src), reverse)
    got_ref = block_sweep2_reference(*targs, block=16, inner=10).numpy()
    got = v_sweep2(*targs, block=16, inner=10).numpy()
    np.testing.assert_array_equal(got, got_ref)
    np.testing.assert_allclose(np.minimum(got, 1e9),
                               np.minimum(want_pallas, 1e9), atol=1e-4)
    np.testing.assert_allclose(np.minimum(got, 1e9),
                               np.minimum(want_xla, 1e9), atol=1e-4)


@pytest.mark.parametrize("order", [1, 2])
def test_composed_schedule_bit_equal_to_jax_cpu(order):
    rng = np.random.RandomState(2)
    b, h, w = 2, 48, 40
    trav = rng.rand(b, h, w) > 0.2
    src = np.zeros((b, h, w), bool)
    src[:, 10, 8] = True
    want = np.asarray(jfmm.eikonal_distance(jnp.asarray(trav),
                                            jnp.asarray(src), order=order))
    got = tfmm.eikonal_distance(T(trav), T(src), order=order,
                                schedule="composed").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("order", [1, 2])
def test_composed_2d_bit_equal_to_jax_cpu(order):
    """A single grid, as the single-env planner and goal solve pass it."""
    rng = np.random.RandomState(8)
    trav = rng.rand(50, 37) > 0.2
    src = np.zeros((50, 37), bool)
    src[40, 3] = True
    want = np.asarray(jfmm.eikonal_distance(jnp.asarray(trav),
                                            jnp.asarray(src), order=order))
    got = tfmm.eikonal_distance(trav, src, order=order, device="cpu").numpy()
    assert got.shape == (50, 37) and np.isfinite(got).sum() > 1000
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1, 16, 1040), (1, 1040, 16)])
@pytest.mark.parametrize("order", [1, 2])
def test_composed_schedule_past_1024_bit_equal_to_jax_cpu(shape, order):
    """Lines over 1024 cells (a full map at map_size_cm=5200): the plain
    solve, which the order-1 kernels are held to bit for bit on the card,
    equals the JAX package's."""
    rng = np.random.RandomState(11)
    trav = rng.rand(*shape) > 0.2
    src = np.zeros(shape, bool)
    src[0, shape[1] // 3, shape[2] // 3] = True
    kw = dict(order=order, n_iters=1, n_iters2=1)
    want = np.asarray(jfmm.eikonal_distance(jnp.asarray(trav),
                                            jnp.asarray(src), **kw))
    got = tfmm.eikonal_distance(T(trav), T(src), schedule="composed",
                                **kw).numpy()
    assert np.isfinite(got).sum() > shape[1] * shape[2] // 2
    np.testing.assert_array_equal(got, want)


def _jax_fused_order2(trav, src, n_iters=2, block=16, inner=40, n_iters2=2):
    """The fused order-2 schedule of fmm.py:417-483 assembled from the JAX
    package's parts (interpret-mode blanket, XLA refinement sweeps)."""
    t, s = jnp.asarray(trav), jnp.asarray(src)
    wall = ~t & ~s
    d = jfused(t, s, rounds=max(n_iters, 2), block=block, inner=inner,
               scan_chunk=4, vscan=False, bt=1, interpret=True)
    d = jnp.where(jnp.isinf(d), BIG, d)
    d2 = jnp.where(s, 0.0, BIG).astype(jnp.float32)
    for _ in range(n_iters2):
        d2 = jfmm._v_sweep2(d2, wall, s, False, block, inner)
        d2 = jfmm._v_sweep2(d2, wall, s, True, block, inner)
        dt = jfmm._v_sweep2(jnp.swapaxes(d2, -1, -2),
                            jnp.swapaxes(wall, -1, -2),
                            jnp.swapaxes(s, -1, -2), False, block, inner)
        dt = jfmm._v_sweep2(dt, jnp.swapaxes(wall, -1, -2),
                            jnp.swapaxes(s, -1, -2), True, block, inner)
        d2 = jnp.swapaxes(dt, -1, -2)
    d = jnp.minimum(d, d2)
    return np.asarray(jnp.where(d >= 0.5 * BIG, jnp.inf, d))


def test_fused_schedule_matches_jax_assembly():
    rng = np.random.RandomState(3)
    trav = np.stack([make_floorplan(rng, n=64, room=32, clutter=8)
                     for _ in range(2)])
    src = np.stack([random_goal(rng, trav[i], blob=i == 1)
                    for i in range(2)])
    want = _jax_fused_order2(trav, src)
    got = tfmm.eikonal_distance(T(trav), T(src), schedule="fused")
    _assert_fields_close(got, want, atol=1e-4)


def test_fused_schedule_within_heap_oracle_bounds():
    worst = (0.0, 0.0)
    rng = np.random.RandomState(4)
    trav = np.stack([make_floorplan(rng, n=120, room=40, clutter=15)
                     for _ in range(2)])
    src = np.stack([random_goal(rng, trav[i], blob=i == 1)
                    for i in range(2)])
    got = tfmm.eikonal_distance(T(trav), T(src),
                                schedule="fused").double().numpy()
    for i in range(2):
        want = heap_fmm(trav[i], src[i])
        np.testing.assert_array_equal(np.isfinite(got[i]),
                                      np.isfinite(want))
        m = np.isfinite(want)
        err = np.abs(got[i][m] - want[m])
        worst = (max(worst[0], err.max()), max(worst[1], err.mean()))
    assert worst[0] <= MAX_CELL_ERR and worst[1] <= MEAN_CELL_ERR, worst


def test_plan_windows_bit_equal_to_jax():
    rng = np.random.RandomState(5)
    b, h, w = 2, 40, 40
    trav = rng.rand(b, h, w) > 0.15
    goal = np.zeros((b, h, w), np.float32)
    goal[0, 5:8, 30:33] = 1.0
    goal[1, 35, 3] = 1.0
    loc_r = np.array([20, 0], np.int32)      # env 1 at the map edge
    loc_c = np.array([18, 39], np.int32)
    want = jops.plan_distance_fields(jnp.asarray(trav), jnp.asarray(goal),
                                     jnp.asarray(loc_r), jnp.asarray(loc_c))
    got = tops.plan_distance_fields(T(trav), T(goal), T(loc_r).long(),
                                    T(loc_c).long())
    np.testing.assert_array_equal(got.window.numpy(),
                                  np.asarray(want.window))
    np.testing.assert_array_equal(got.distance.numpy(),
                                  np.asarray(want.distance))
    np.testing.assert_array_equal(tfmm.masked_fill_unreachable(
        T(np.array([[[1.0, np.inf], [2.0, 0.0]]], np.float32))).numpy(),
        np.asarray(jfmm.masked_fill_unreachable(
            jnp.asarray([[[1.0, np.inf], [2.0, 0.0]]], jnp.float32))))
