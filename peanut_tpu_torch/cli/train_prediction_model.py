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

``main(argv, device=)`` runs on ``device`` (the card unless ``"cpu"``).
``--distributed 1`` (DDP) is ROADMAP A14; ``--config`` (the zoo's config
files) ROADMAP A13.
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
                    help="model config file (the model zoo's; not ported)")
    ap.add_argument("--remat", type=int, default=1,
                    help="recompute the backbone's blocks in backward")
    ap.add_argument("--distributed", type=int, default=0,
                    help="data parallelism over processes (not ported)")
    ns, _ = ap.parse_known_args(argv)
    return ns


def main(argv=None, device=None):
    """Train; returns the final ``TrainState``."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    ns = parse_args(argv)
    if ns.distributed:
        raise NotImplementedError("--distributed: data parallelism over "
                                  "processes (DDP) is ROADMAP A14")
    if ns.config:
        raise NotImplementedError("--config: model config files are the "
                                  "zoo's (core/config_file.py), ROADMAP A13")

    from .. import resolve_device
    from ..models.pspnet import build_segmentor, peanut_prediction_config
    from ..prediction.dataset import (PrefetchLoader, SemMapDataset,
                                      training_pipeline)
    from ..prediction.runner import IterRunner
    from ..prediction.train import (TrainConfig, create_train_state,
                                    make_train_step)

    device = resolve_device(device)
    tcfg = TrainConfig(lr=ns.lr, max_iters=ns.max_iters,
                       batch_size=ns.batch_size, seed=ns.seed,
                       log_interval=ns.log_interval,
                       checkpoint_interval=ns.checkpoint_interval)
    rng = np.random.RandomState(ns.seed)
    dataset = SemMapDataset(ns.data_root, ns.img_dir,
                            pipeline=training_pipeline(ns.crop_size, rng=rng))
    loader = PrefetchLoader(dataset, ns.batch_size, seed=ns.seed,
                            num_workers=ns.num_workers)
    logging.info("Loaded %d samples (batch %d)", len(dataset), ns.batch_size)
    model = build_segmentor(peanut_prediction_config(remat=bool(ns.remat)),
                            seed=ns.seed)
    state = create_train_state(model, tcfg, device=device)
    runner = IterRunner(make_train_step(tcfg), state, loader, tcfg,
                        ns.work_dir, auto_resume=not ns.no_resume)
    return runner.run()


if __name__ == "__main__":
    main()
