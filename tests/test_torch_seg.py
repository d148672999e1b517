"""The Mask R-CNN serving path of the runtime, port against the JAX package,
on the CPU, with the detect stage swapped for a synthetic head in each
package (the idea of tests/test_seg_integration.py): the head decodes
FakeNavEnv's category-coded RGB rectangles from the already preprocessed
image, so the real preprocess (BGR, shortest-edge-800 resize, mean),
chunking, mask pasting, gates and per-class accumulation stay live.

* ``batch_device`` equals JAX ``seg_program`` on env frames, float32 and
  bfloat16 serving, and the paste equals JAX ``_paste_jit`` on random
  detections: bit for bit (the paste's sums have two nonzero terms).
* The port's ``BatchRunner`` under ``use_gt_seg=0`` explore-only takes the
  JAX runner's actions, tick for tick (no tolerance), and its maps lie
  within 1e-4 of JAX's (the mapper bound of tests/test_torch_mapping.py).
* The chunked detect pipeline (``stage_obs`` launches a chunk as frames
  arrive) equals one detect call per tick, bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from peanut_tpu.envs import FakeNavEnv as JEnv
from peanut_tpu.envs.batch_runner import BatchRunner as JRunner
from peanut_tpu_torch.config import NavConfig
from peanut_tpu_torch.envs import FakeNavEnv
from peanut_tpu_torch.envs.batch_runner import BatchRunner
from peanut_tpu_torch.models import PIXEL_MEAN_BGR
from peanut_tpu_torch.perception import MaskRCNNSegmenter

from test_agent_e2e import small_cfg
from test_seg_integration import SyntheticHeadSegmenter as JSynth

torch.set_num_threads(1)
SEEDS = (3, 11, 42)
TICKS = 6


class Synth(MaskRCNNSegmenter):
    """The port's twin of the JAX synthetic head: one detection per
    category per frame, the decoded pixel box in resized-frame coordinates,
    full-box 28x28 masks."""

    def __init__(self, cfg):
        super().__init__(cfg, model=torch.nn.Module(), device="cpu")

    def _detect_stage(self, imgs):
        bgr = imgs + torch.as_tensor(PIXEL_MEAN_BGR).to(imgs.dtype)
        cats = np.arange(9)
        targets = torch.as_tensor(np.stack(
            [[40.0, 200.0 - 15 * c, 40.0 + 20 * c] for c in cats])).to(
            imgs.dtype)
        close = (torch.abs(bgr[:, None] - targets[None, :, None, None])
                 < 8.0).all(-1)                          # (chunk, 9, ph, pw)
        ph, pw = imgs.shape[1], imgs.shape[2]
        ys = torch.arange(ph, dtype=torch.float32)
        xs = torch.arange(pw, dtype=torch.float32)
        big = float(ph + pw)
        rows, cols = close.any(3), close.any(2)
        y1 = torch.where(rows, ys, big).amin(2)
        y2 = torch.where(rows, ys, -1.0).amax(2) + 1.0
        x1 = torch.where(cols, xs, big).amin(2)
        x2 = torch.where(cols, xs, -1.0).amax(2) + 1.0
        scores = torch.where(close.any((2, 3)), 0.99, 0.0)
        return {"boxes": torch.stack([x1, y1, x2, y2], -1),
                "scores": scores,
                "classes": torch.as_tensor(cats).expand(scores.shape),
                "masks": torch.ones(scores.shape + (28, 28))}


def _cfg(**kw):
    base = dict(use_gt_seg=0, only_explore=1, switch_step=999,
                seg_batch_chunk=2, cat_pred_threshold=1.0, map_size_cm=960)
    base.update(kw)
    return small_cfg(**base)


def _port(cfg):
    return NavConfig(**dataclasses.asdict(cfg))


def _frames(cfg):
    """FakeNavEnv frames with objects in view (both packages' envs emit
    the same bytes, tests/test_torch_package.py)."""
    rgbs, cats = [], []
    for seed in SEEDS:
        env = JEnv(cfg, size_m=8.0, seed=seed, objects_in_depth=True)
        obs = env.reset()
        for _ in range(12):
            if obs["gtsem"][..., :9].sum() > 0:
                break
            obs = env.step(3)
        rgbs.append(np.asarray(obs["rgb"], np.uint8))
        cats.append(int(np.asarray(obs["objectgoal"]).reshape(-1)[0]))
    return np.stack(rgbs), cats


@pytest.mark.parametrize("bf16", [False, True])
def test_batch_device_matches_jax_seg_program(bf16):
    cfg = _cfg(serve_bf16=bf16)
    rgbs, cats = _frames(cfg)
    want = np.asarray(JSynth(cfg).batch_device(rgbs, cats))
    got = Synth(_port(cfg)).batch_device(rgbs, cats)
    assert got.dtype == torch.float32
    assert got.shape == (len(SEEDS), cfg.num_sem_categories,
                         cfg.frame_height, cfg.frame_width)
    assert float(got[:, :9].sum()) > 0              # objects were decoded
    np.testing.assert_array_equal(got.numpy(), want)


def test_paste_matches_jax():
    cfg = _cfg()
    jseg = JSynth(cfg)
    jseg._seg_program = jseg._build_seg_program()
    seg = Synth(_port(cfg))
    rng = np.random.RandomState(0)
    b, nd = 3, 100
    xy = rng.rand(b, nd, 2) * [seg.rw, seg.rh]
    wh = rng.rand(b, nd, 2) * [seg.rw, seg.rh] / 2
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.uniform(0.9, 1.0, (b, nd)).astype(np.float32)
    scores[:, -10:] = -np.inf
    classes = rng.randint(0, 10, (b, nd)).astype(np.int32)   # 9 = no class
    masks = rng.rand(b, nd, 28, 28).astype(np.float32)
    goal = np.array([0, 4, 8], np.int32)
    want = np.asarray(jseg._paste_jit(jnp.asarray(boxes), jnp.asarray(scores),
                                      jnp.asarray(classes),
                                      jnp.asarray(masks), jnp.asarray(goal)))
    got = seg.paste(*(torch.as_tensor(x) for x in (boxes, scores)),
                    torch.as_tensor(classes).long(), torch.as_tensor(masks),
                    torch.as_tensor(goal).long())
    assert want.sum() > 0
    np.testing.assert_array_equal(got.numpy(), want)


def _record(runner):
    acts = []
    act = runner.runtime.act_batch

    def recording(obs):
        out = act(obs)
        acts.append([a["action"] for a in out])
        return out

    runner.runtime.act_batch = recording
    return acts


def _roll(runner, ticks=TICKS):
    acts = _record(runner)
    runner.reset_all()
    for _ in range(ticks):
        runner.tick()
    return acts


def _envs(cls, cfg):
    return [lambda s=s: cls(cfg, size_m=8.0, seed=s, objects_in_depth=True,
                            max_steps=TICKS + 5) for s in SEEDS]


@pytest.fixture(scope="module")
def jax_rollout():
    cfg = _cfg()
    runner = JRunner(cfg, _envs(JEnv, cfg), segmenter=JSynth(cfg))
    acts = _roll(runner)
    return cfg, acts, np.asarray(runner.runtime.state.local_maps)


def test_runner_actions_equal_jax(jax_rollout):
    jcfg, want_acts, want_maps = jax_rollout
    cfg = _port(jcfg)
    seg = Synth(cfg)
    runner = BatchRunner(cfg, _envs(FakeNavEnv, cfg), segmenter=seg,
                         device="cpu")
    try:
        acts = _roll(runner)
    finally:
        runner.close()
    assert acts == want_acts
    maps = runner.runtime.state.local_maps.numpy()
    np.testing.assert_allclose(maps, want_maps, rtol=0, atol=1e-4)
    assert maps[:, 4:13].sum() > 0           # Mask R-CNN semantics mapped
    assert len({a for tick in acts for a in tick}) > 1


def test_chunked_detect_equals_unchunked():
    cfg = _port(_cfg())
    runs = {}
    for chunked in (True, False):
        seg = Synth(cfg)
        calls = []
        detect = seg.batch_device
        seg.batch_device = lambda r, c: calls.append(len(c)) or detect(r, c)
        runner = BatchRunner(cfg, _envs(FakeNavEnv, cfg), segmenter=seg,
                             device="cpu")
        if not chunked:
            runner.runtime._seg_chunk = 0       # one detect call per tick
        try:
            acts = _roll(runner, ticks=3)
        finally:
            runner.close()
        runs[chunked] = (acts, runner.runtime.state.local_maps.numpy(),
                         calls)
    (acts_c, maps_c, calls_c), (acts_u, maps_u, calls_u) = runs[True], \
        runs[False]
    assert set(calls_u) == {len(SEEDS)}
    # after the first tick, chunks of 2 as frames are staged and the tail
    # of 1 flushed in _pack_obs
    assert calls_c[0] == len(SEEDS) and set(calls_c[1:]) == {1, 2}
    assert acts_c == acts_u
    np.testing.assert_array_equal(maps_c, maps_u)
