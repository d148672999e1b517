"""The port's geometry, map kernels and semantic mapper against the JAX
package's, on the CPU, from the same seeded numpy inputs.

Tolerances: bitwise where the two compute the same float operations in the
same order (pose twins, morphology, the exact splat, which rounds to
integers); 1e-5 absolute (1e-4 for maps warped twice) where torch's
built-ins round differently from the
JAX package's re-implementations (F.affine_grid / F.grid_sample weights,
matmul and scatter summation order) — the bounds tests/test_kernels.py and
tests/test_mapping.py already hold those ops to against torch.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from peanut_tpu import geometry as jgeo
from peanut_tpu.config import NavConfig as JCfg
from peanut_tpu.kernels import morphology as jmorph
from peanut_tpu.kernels import splat as jsplat
from peanut_tpu.mapping import SemanticMapper as JMapper
from peanut_tpu_torch import geometry as tgeo
from peanut_tpu_torch.config import NavConfig as TCfg
from peanut_tpu_torch.kernels import morphology as tmorph
from peanut_tpu_torch.kernels import splat as tsplat
from peanut_tpu_torch.mapping import SemanticMapper as TMapper

from test_mapping import SMALL, make_inputs

# the packages export a function of the module's name
jgs = importlib.import_module("peanut_tpu.kernels.grid_sample")
tgs = importlib.import_module("peanut_tpu_torch.kernels.grid_sample")

torch.set_num_threads(1)
T = torch.from_numpy


def test_geometry_matches_jax():
    rng = np.random.RandomState(0)
    cam_j = jgeo.get_camera_matrix(32, 24, 79.0)
    cam_t = tgeo.get_camera_matrix(32, 24, 79.0)
    assert tuple(cam_j) == tuple(cam_t)
    depth = (50.0 + rng.rand(2, 24, 32) * 400.0).astype(np.float32)
    for scale in (1, 2):
        pj = np.asarray(jgeo.point_cloud_from_depth(jnp.asarray(depth), cam_j,
                                                    scale=scale))
        pt = tgeo.point_cloud_from_depth(T(depth), cam_t, scale=scale)
        np.testing.assert_array_equal(pt.numpy(), pj)
        np.testing.assert_allclose(
            tgeo.transform_camera_view(pt, 88.0, 0.0).numpy(),
            np.asarray(jgeo.transform_camera_view(jnp.asarray(pj), 88.0,
                                                  0.0)), atol=1e-5)
        np.testing.assert_allclose(
            tgeo.transform_pose(pt, (120.0, 0, np.pi / 2.0)).numpy(),
            np.asarray(jgeo.transform_pose(jnp.asarray(pj),
                                           (120.0, 0, np.pi / 2.0))),
            atol=1e-5)
    pose = np.array([[6.0, 6.0, 170.0], [5.1, 7.2, -33.0]], np.float32)
    rel = np.array([[0.25, 0.0, 0.52], [0.1, -0.2, -0.52]], np.float32)
    # the host twin is shared code; the torch twin within float32 rounding
    np.testing.assert_array_equal(tgeo.integrate_pose_np(pose, rel),
                                  jgeo.pose.integrate_pose_np(pose, rel))
    np.testing.assert_allclose(
        tgeo.integrate_pose(T(pose), T(rel)).numpy(),
        np.asarray(jgeo.integrate_pose(jnp.asarray(pose), jnp.asarray(rel))),
        atol=1e-5)
    assert tgeo.get_rel_pose_change((1.0, 2.0, 0.3), (0.5, 1.0, 0.1)) == \
        jgeo.get_rel_pose_change((1.0, 2.0, 0.3), (0.5, 1.0, 0.1))
    assert tgeo.threshold_poses([-3, 99], (40, 50)) == \
        jgeo.threshold_poses([-3, 99], (40, 50))


def test_splat_exact_bitwise_and_fast_close():
    rng = np.random.RandomState(1)
    b, c, p, vr, nz = 2, 5, 700, 24, 16
    feat = np.ones((b, c, p), np.float32)
    feat[:, 1:] = (rng.rand(b, c - 1, p) > 0.5).astype(np.float32)
    coords = (rng.rand(b, 3, p).astype(np.float32) * 2.4 - 1.2)
    coords[:, :, :20] = 99999.0               # stair-masked points
    init = np.zeros((b, c, vr, vr, nz), np.float32)
    want = np.asarray(jsplat.splat_feat_nd(jnp.asarray(init),
                                           jnp.asarray(feat),
                                           jnp.asarray(coords), exact=True))
    got = tsplat.splat_feat_nd(T(init), T(feat), T(coords), exact=True)
    np.testing.assert_array_equal(got.numpy(), want)
    jb, jt = jsplat.splat_projected_2d(jnp.asarray(feat), jnp.asarray(coords),
                                       vr, nz, min_z=3, max_z=9)
    tb, tt = tsplat.splat_projected_2d(T(feat), T(coords), vr, nz, min_z=3,
                                       max_z=9)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5,
                               rtol=1e-5)


def test_grid_sample_and_pose_warp_match_jax():
    rng = np.random.RandomState(2)
    theta = rng.randn(3, 2, 3).astype(np.float32)
    size = (3, 2, 15, 21)
    np.testing.assert_allclose(
        tgs.affine_grid(T(theta), size).numpy(),
        np.asarray(jgs.affine_grid(jnp.asarray(theta), size)), atol=1e-6)
    inp = rng.randn(2, 3, 17, 19).astype(np.float32)
    grid = rng.rand(2, 10, 12, 2).astype(np.float32) * 2.6 - 1.3
    np.testing.assert_allclose(
        tgs.grid_sample(T(inp), T(grid)).numpy(),
        np.asarray(jgs.grid_sample(jnp.asarray(inp), jnp.asarray(grid))),
        atol=1e-5)
    st_pose = np.array([[0.21, -0.4, 33.0], [-0.1, 0.3, -120.0]],
                       np.float32)
    for gt, gj in zip(tgs.pose_warp_grids(T(st_pose), (2, 4, 48, 48)),
                      jgs.pose_warp_grids(jnp.asarray(st_pose),
                                          (2, 4, 48, 48))):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-5)


def test_morphology_bitwise():
    rng = np.random.RandomState(3)
    img = rng.rand(30, 31) > 0.85
    for r in (1, 2, 4):
        fp = tmorph.disk(r)
        np.testing.assert_array_equal(fp, jmorph.disk(r))
        np.testing.assert_array_equal(
            tmorph.binary_dilation(T(img), fp).numpy(),
            np.asarray(jmorph.binary_dilation(jnp.asarray(img), fp)))
        np.testing.assert_array_equal(
            tmorph.binary_erosion(T(~img), fp).numpy(),
            np.asarray(jmorph.binary_erosion(jnp.asarray(~img), fp)))
        np.testing.assert_array_equal(tmorph.np_binary_dilation(img, fp),
                                      jmorph.np_binary_dilation(img, fp))
        np.testing.assert_array_equal(tmorph.np_binary_erosion(~img, fp),
                                      jmorph.np_binary_erosion(~img, fp))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("stairs", [False, True])
def test_mapper_update_core_matches_jax_over_steps(exact, stairs):
    """A few chained map updates (each step's map feeds the next) on the
    same observations: the exact path's splat and projections are bitwise;
    the warped maps, values in [0, 1], agree to 1e-4 (two chained bilinear
    passes whose weights round differently: measured 1.8e-5).  The fast
    path's one composed affine takes its per-pixel steps as differences of
    ~50-cell coordinates, which magnifies XLA's FMA-contracted rounding
    against torch's across a 128-cell window (measured 6.3e-4): 2e-3."""
    rng = np.random.RandomState(4)
    jcfg = JCfg(**SMALL, exact_parity=exact)
    tcfg = TCfg(**dataclasses.asdict(jcfg))
    jm, tm = JMapper(jcfg), TMapper(tcfg)
    obs, _, maps, poses = make_inputs(rng, jcfg, bs=2, stairs=stairs)
    jmaps, tmaps = jnp.asarray(maps), T(maps)
    for step in range(3):
        poses = poses + np.array([[0.1, -0.05, 15.0]], np.float32) * step
        fpj, jmaps, _ = jm.apply_core(jnp.asarray(obs), jnp.asarray(poses),
                                      jmaps)
        fpt, tmaps, _ = tm.update_core(T(obs), T(poses), tmaps)
        if exact:
            np.testing.assert_array_equal(fpt.numpy(), np.asarray(fpj))
        else:
            # band sums of matmuls in another order, scaled by 1/0.1
            np.testing.assert_allclose(fpt.numpy(), np.asarray(fpj),
                                       atol=1e-4)
        np.testing.assert_allclose(tmaps.numpy(), np.asarray(jmaps),
                                   atol=1e-4 if exact else 2e-3)
        obs = obs[::-1].copy()                 # new observations per step
