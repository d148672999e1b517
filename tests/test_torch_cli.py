"""The port's CLIs against the JAX package's, on the CPU.

``collect_maps`` on tests/test_cli.py's SMALL_ARGS (map collection's
geometry enlarged as tests/test_cli.py enlarges it, full GT semantics and a
seed whose episode passes the save gate) writes the JAX CLI's npz: the same
file name and the same uint8 (20, 14, H, W) maps, byte for byte.  The
single-env and the batched ``collect`` need the prediction weights; both
refuse without them rather than run on something else.
"""

import glob
import os

import numpy as np
import pytest
import torch

from peanut_tpu.cli import collect_maps as jcollect_maps
from peanut_tpu_torch.cli import collect, collect_maps, eval as teval
from peanut_tpu_torch.config import NavConfig

from test_cli import SMALL_ARGS

torch.set_num_threads(1)

MAPS_ARGS = SMALL_ARGS + [
    "--num_episodes", "1", "--split", "val", "--map_size_cm", "1920",
    "--vision_range", "24", "--max_episode_length", "26",
    "--timestep_limit", "26", "--use_gt_seg", "2", "--cat_pred_threshold",
    "1", "--seed", "3"]


def _npz(root):
    files = sorted(glob.glob(os.path.join(root, "val_80", "*.npz")))
    return [os.path.basename(f) for f in files], \
        [np.load(f)["maps"] for f in files]


def test_collect_maps_npz_equals_jax(tmp_path):
    jcollect_maps.main(MAPS_ARGS + ["--out_dir", str(tmp_path / "jax")])
    collect_maps.main(MAPS_ARGS + ["--out_dir", str(tmp_path / "torch")],
                      device="cpu")
    want_names, want = _npz(tmp_path / "jax")
    names, got = _npz(tmp_path / "torch")
    assert names == want_names == ["f00000.npz"]
    assert got[0].dtype == np.uint8 and got[0].shape == (20, 14, 384, 384)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0][:, 4:].sum() > 0 and got[0][:, 1].sum() > 4000


def test_collect_refuses_without_its_models():
    args = SMALL_ARGS + ["--num_episodes", "1",
                         "--pred_model_wts", "no/such/pspnet.pth"]
    # collect forces only_explore=0: the single-env agent loads the PSPNet
    with pytest.raises(FileNotFoundError, match="no/such/pspnet.pth"):
        collect.main(args, device="cpu")
    # the batched runtime loads the same PSPNet for its prediction hook
    with pytest.raises(FileNotFoundError, match="no/such/pspnet.pth"):
        collect.main(args + ["--num_envs", "2"], device="cpu")
    # --fake_env 0 builds the habitat adapter, which needs habitat
    with pytest.raises(ImportError, match="habitat"):
        collect.make_env(NavConfig(), fake=False)


def test_eval_shim_drives_the_agent():
    class Agent:
        calls = []

        def reset(self):
            self.calls.append("reset")

        def act(self, obs):
            self.calls.append(obs)
            return {"action": 1}

    shim = teval._ChallengeAgent(Agent())
    shim.reset()
    assert shim.act("obs") == {"action": 1}
    assert Agent.calls == ["reset", "obs"]
