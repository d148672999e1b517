"""Map-dataset collection (torch port of ``peanut_tpu.cli.collect_maps``,
PEANUT's nav/collect_maps.py).

Explore-only policy (Stubborn corner presets), snapshots of the full map at
steps 25, 50, ..., 500 saved as uint8 (20, 14, H, W) .npz under
``<out_dir>/<split>_80/fNNNNN.npz``, the JAX CLI's files byte for byte on
the same episode (same save gate: some semantics seen and >4000 explored
cells).  ``main`` runs on the card unless given ``device="cpu"``.

    python -m peanut_tpu_torch.cli.collect_maps --fake_env 1 \\
        --num_episodes 1 --use_gt_seg 1
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..agent import PeanutAgent
from ..config import NavConfig
from .collect import make_env


def main(argv=None, device=None):
    import argparse

    parser = argparse.ArgumentParser()
    NavConfig.add_args(parser)
    parser.add_argument("--fake_env", type=int, default=0)
    parser.add_argument("--num_episodes", type=int, default=1000)
    parser.add_argument("--split", type=str, default="val")
    parser.add_argument("--out_dir", type=str, default="./data/saved_maps")
    ns, _ = parser.parse_known_args(argv)

    cfg = NavConfig.from_args(argv)
    # collect_maps.py:27-29 overrides
    cfg = cfg.replace(only_explore=1, switch_step=999, global_downscaling=4)

    env = make_env(cfg, ns.fake_env)
    agent = PeanutAgent(cfg, device=device)

    save_steps = list(range(25, 525, 25))
    start = cfg.start_ep
    end = cfg.end_ep if cfg.end_ep > 0 else ns.num_episodes
    out_dir = os.path.join(ns.out_dir, f"{ns.split}_80")
    os.makedirs(out_dir, exist_ok=True)

    count_episodes = 0
    while count_episodes < min(ns.num_episodes, end):
        observations = env.reset()
        observations["objectgoal"] = [0]
        agent.reset()
        print(count_episodes)
        sys.stdout.flush()

        if start <= count_episodes < end:
            step_i = 0
            seq_i = 0
            st = agent.agent_state
            full_map_seq = np.zeros(
                (len(save_steps), cfg.num_map_channels, st.full_w,
                 st.full_h), dtype=np.uint8)
            while not env.episode_over:
                action = agent.act(observations)
                observations = env.step(action)
                observations["objectgoal"] = [0]
                if step_i % 100 == 0:
                    print("episode %d, step %d" % (count_episodes, step_i))
                    sys.stdout.flush()
                step_i += 1
                if step_i in save_steps:
                    full_map_seq[seq_i] = (st.full_map * 255).astype(
                        np.uint8)
                    seq_i += 1

            if np.sum(full_map_seq[:, 4:]) > 0 and \
                    np.sum(full_map_seq[:, 1]) > 4000:
                np.savez_compressed(
                    os.path.join(out_dir, "f%05d.npz" % count_episodes),
                    maps=full_map_seq)
        count_episodes += 1


if __name__ == "__main__":
    main()
