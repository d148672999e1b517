"""The data-parallel trainer CLI of the port on the CPU, over two gloo
ranks (tests/torch_dist_support.py): ``cli.train_prediction_model
--distributed 1`` trains the tiny PSPNet of tests/test_torch_training.py
(as a ``--config`` file) at a global batch of 4, two rows a rank, then
resumes: rank 0 alone writes the log and the checkpoints, and every rank
resumes from the same iteration.  The step itself is held against JAX's
global-batch step in tests/test_torch_ddp.py."""

import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (kept on the CPU by conftest)

from peanut_tpu_torch.core.config_file import dump_config
from peanut_tpu_torch.utils.loggers import read_train_log

from test_torch_training import tiny_cfg, write_maps
from torch_dist_support import run_ranks, train_cli

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_cli")
    write_maps(str(root / "train"), n_files=2, size=48, seed=6)
    cfg = str(root / "tiny.py")
    dump_config({"model": tiny_cfg()}, cfg)
    return str(root), cfg


def _argv(root, cfg, work, iters):
    return ["--data_root", root, "--img_dir", "train", "--work_dir", work,
            "--config", cfg, "--max_iters", str(iters), "--batch_size", "4",
            "--crop_size", "32", "--num_workers", "1", "--seed", "5",
            "--checkpoint_interval", "2", "--log_interval", "1",
            "--distributed", "1"]


def test_cli_trains_distributed_and_resumes(data, tmp_path):
    root, cfg = data
    work = str(tmp_path / "w")
    run_ranks(train_cli, 2, tmp_path, _argv(root, cfg, work, 2))
    assert sorted(os.listdir(work)) == ["iter_2", "rank0_step.txt",
                                        "rank1_step.txt", "train_log.jsonl"]
    run_ranks(train_cli, 2, tmp_path, _argv(root, cfg, work, 4))
    for r in (0, 1):
        with open(os.path.join(work, f"rank{r}_step.txt")) as f:
            assert f.read() == "4"
    assert sorted(d for d in os.listdir(work) if d.startswith("iter_")) \
        == ["iter_2", "iter_4"]
    log = read_train_log(os.path.join(work, "train_log.jsonl"))
    # one record an iteration: rank 0's alone, the resumed run's after
    assert [r["iter"] for r in log] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and "aux.loss_bce" in r for r in log)
