"""Prediction-model training CLI (port of
``peanut_tpu.cli.train_prediction_model``).

The reference recipe (train_prediction_model.py:214-319): PSPNet-R50-v1c
over 14-channel maps, 6 classes, BCE plus 0.4 x the auxiliary head, batch
8, crop 960, Adam 5e-4 with poly decay, 60k iterations, a checkpoint every
2k with auto-resume; ``--remat 1`` (the default) recomputes the backbone's
blocks in backward.  One process on one card, in float32 (the caller's
TF32 settings apply; PyTorch's default runs cuDNN convolutions in TF32).
Samples go through the native fused augment (``native/map_pipeline.cc``).

    python -m peanut_tpu_torch.cli.train_prediction_model \
        --data_root DIR --img_dir train_80 --work_dir W

With ``--config FILE`` the model is the ``model`` entry of a zoo config
file (``core/config_file.py``) in place of PEANUT's PSPNet, trained by the
same recipe on the same 14-channel maps, as the reference's: its
backbone takes ``in_channels`` from the config, 14 when the config names
none; parameters shaped by the input (``layers.InputShaped``: BEiT's
tables, MAE's positional embedding) are bound by one forward at (1,
in_channels, crop, crop) before Adam is built, the shape the reference
initialises at; ``--remat`` is ignored, as in the reference.  The config
needs one auxiliary head (``prediction.train.check_heads``).

``main(argv, device=)`` runs on ``device`` (the card unless ``"cpu"``).

``--distributed 1``: data parallelism, one process a card
(``prediction.train.distribute``):

    torchrun --nproc_per_node=N -m peanut_tpu_torch.cli.train_prediction_model \
        --distributed 1 --data_root DIR --img_dir train_80 --work_dir W

Each process joins the group from torchrun's environment
(``core.mesh.init_distributed``: NCCL on ``cuda:{LOCAL_RANK}``; a caller
that joined a group before, gloo say, keeps it), takes rank 0's
``--seed``, loads ``--batch_size / world`` samples of every global batch
from its rank-strided share of the episodes and trains on its device;
``--batch_size`` is the global batch and must divide by the world size.
Rank 0 alone writes the log and the checkpoints; every rank resumes from
the same one.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", type=str, default="../data/saved_maps")
    ap.add_argument("--img_dir", type=str, default="train_80")
    ap.add_argument("--work_dir", type=str,
                    default="./work_dirs/final_model")
    ap.add_argument("--max_iters", type=int, default=60000)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--crop_size", type=int, default=960)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log_interval", type=int, default=500)
    ap.add_argument("--checkpoint_interval", type=int, default=2000)
    ap.add_argument("--num_workers", type=int, default=8)
    ap.add_argument("--no_resume", action="store_true")
    ap.add_argument("--config", type=str, default=None,
                    help="model config file (the model zoo's); PEANUT's "
                         "PSPNet when unset")
    ap.add_argument("--remat", type=int, default=1,
                    help="recompute the backbone's blocks in backward")
    ap.add_argument("--distributed", type=int, default=0,
                    help="data parallelism over processes (DDP; under "
                         "torchrun)")
    ns, _ = ap.parse_known_args(argv)
    return ns


def config_model(path: str, crop: int, seed: int, device):
    """The ``model`` entry of the config file at ``path`` (or the file's
    dict when it has none), its backbone at ``in_channels`` (14 unless the
    config names it), random weights from ``seed``, on ``device``, with
    its input-shaped parameters bound at (1, in_channels, crop, crop)."""
    import torch

    from ..core.config_file import load_config
    from ..models.builder import build_segmentor
    from ..models.layers import needs_binding

    cfg = load_config(path)
    cfg = dict(cfg.get("model", cfg))
    cfg["backbone"] = dict(cfg["backbone"])
    in_ch = cfg["backbone"].setdefault("in_channels", 14)
    model = build_segmentor(cfg, seed=seed).to(device)
    if needs_binding(model):
        with torch.no_grad():
            model(torch.zeros(1, in_ch, crop, crop, device=device),
                  train=False)
    return model


def main(argv=None, device=None):
    """Train; returns the final ``TrainState``."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    ns = parse_args(argv)

    import torch
    import torch.distributed as dist

    from .. import resolve_device
    from ..core.mesh import init_distributed
    from ..models.pspnet import build_segmentor, peanut_prediction_config
    from ..prediction.dataset import (GlobalShardedLoader, PrefetchLoader,
                                      SemMapDataset, training_pipeline)
    from ..prediction.runner import IterRunner
    from ..prediction.train import (TrainConfig, create_train_state,
                                    distribute, make_train_step)

    seed, rank, world = ns.seed, 0, 1
    joined = False
    if ns.distributed:
        joined = not dist.is_initialized()
        device = init_distributed(device=device)
        rank, world = dist.get_rank(), dist.get_world_size()
        # rank 0's seed everywhere: every rank draws the same epoch
        # permutation to take its stride of
        t = torch.tensor([ns.seed], dtype=torch.int64, device=device)
        dist.broadcast(t, 0)
        seed = int(t.item())
        if ns.batch_size % world:
            raise SystemExit(f"--batch_size {ns.batch_size} must be "
                             f"divisible by the world size {world}")
    else:
        device = resolve_device(device)
    local_bs = ns.batch_size // world
    tcfg = TrainConfig(lr=ns.lr, max_iters=ns.max_iters,
                       batch_size=ns.batch_size, seed=seed,
                       log_interval=ns.log_interval,
                       checkpoint_interval=ns.checkpoint_interval)
    rng = np.random.RandomState(seed)
    dataset = SemMapDataset(ns.data_root, ns.img_dir,
                            pipeline=training_pipeline(ns.crop_size, rng=rng))
    loader = PrefetchLoader(dataset, local_bs, seed=seed,
                            num_workers=ns.num_workers, num_shards=world,
                            shard_id=rank)
    if ns.distributed:
        loader = GlobalShardedLoader(loader, device)
    logging.info("Loaded %d samples (%d processes x batch %d)",
                 len(dataset), world, local_bs)
    if ns.config:
        model = config_model(ns.config, ns.crop_size, seed, device)
    else:
        model = build_segmentor(
            peanut_prediction_config(remat=bool(ns.remat)), seed=seed)
    state = create_train_state(model, tcfg, device=device)
    runner = IterRunner(make_train_step(tcfg), state, loader, tcfg,
                        ns.work_dir, auto_resume=not ns.no_resume)
    if ns.distributed:
        steps = torch.tensor([state.step, -state.step], device=device)
        dist.all_reduce(steps, op=dist.ReduceOp.MAX)
        if int(steps[0]) != -int(steps[1]):
            raise RuntimeError(f"the ranks resumed from different "
                               f"iterations ({int(steps[0])} and "
                               f"{-int(steps[1])}): is {ns.work_dir} "
                               f"shared?")
        distribute(state)
    try:
        return runner.run()
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
