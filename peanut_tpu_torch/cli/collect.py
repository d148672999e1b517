"""Local evaluation over episodes (torch port of ``peanut_tpu.cli.collect``,
PEANUT's nav/collect.py).

Same CLI flags and stdout format (per-episode metrics + running Success/SPL
averages).  ``--fake_env 1`` runs the synthetic environment, ``--fake_env
0`` habitat through ``envs/habitat_adapter.py`` (inside the habitat image;
elsewhere building it raises ImportError).  ``main`` and ``run_batched``
run on the card unless given ``device="cpu"``.

    python -m peanut_tpu_torch.cli.collect --fake_env 1 --num_episodes 1 \\
        --seg_model_wts <mask_rcnn.pth> --pred_model_wts <pspnet.pth>
"""

from __future__ import annotations

import sys

import numpy as np

from ..agent import PeanutAgent
from ..config import NavConfig
from ..constants import hm3d_names


def make_env(cfg: NavConfig, fake: bool, seed: int = None):
    # --seed (reference arguments.py:10) seeds the env; the fake env's
    # historical default (100) holds while the flag is unset (cfg.seed None)
    seed = (100 if cfg.seed is None else cfg.seed) if seed is None else seed
    if fake:
        from ..envs import FakeNavEnv
        return FakeNavEnv(cfg, seed=seed)
    from ..envs.habitat_adapter import HabitatEnvAdapter
    return HabitatEnvAdapter(cfg, split="val", seed=seed)


def main(argv=None, device=None):
    import argparse

    parser = argparse.ArgumentParser()
    NavConfig.add_args(parser)
    parser.add_argument("--fake_env", type=int, default=0)
    parser.add_argument("--num_episodes", type=int, default=500)
    parser.add_argument("--ticks", type=int, default=0,
                        help="tick budget for batched mode (0 = derive)")
    ns, _ = parser.parse_known_args(argv)
    cfg = NavConfig.from_args(argv)
    cfg = cfg.replace(only_explore=0)

    if cfg.num_envs > 1:
        return run_batched(cfg, ns, device=device)

    env = make_env(cfg, ns.fake_env)
    agent = PeanutAgent(cfg, device=device)

    num_episodes = ns.num_episodes
    start = cfg.start_ep
    end = cfg.end_ep if cfg.end_ep > 0 else num_episodes

    sucs, spls, ep_lens = [], [], []
    ep_i = 0
    while ep_i < min(num_episodes, end):
        observations = env.reset()
        agent.reset()
        print("-" * 40)
        sys.stdout.flush()
        if start <= ep_i < end:
            print("Episode %d | Target: %s" % (
                ep_i, hm3d_names[int(np.asarray(
                    observations["objectgoal"]).reshape(-1)[0])]))
            step_i = 0
            while not env.episode_over:
                action = agent.act(observations)
                observations = env.step(action)
                if step_i % 100 == 0:
                    print("step %d..." % step_i)
                    sys.stdout.flush()
                step_i += 1
            print("ended at step %d" % step_i)
            metrics = env.get_metrics()
            print(metrics)
            sucs.append(metrics["success"])
            spls.append(metrics["spl"])
            ep_lens.append(step_i)
            print("-" * 40)
            print("Average Success: %.4f, Average SPL: %.4f"
                  % (np.mean(sucs), np.mean(spls)))
            print("-" * 40)
            sys.stdout.flush()
        ep_i += 1


def run_batched(cfg: NavConfig, ns, device=None):
    """Parallel-episode evaluation: N envs through the batched runtime
    (no reference counterpart), with the PSPNet at ``cfg.pred_model_wts``
    (FileNotFoundError naming the path without it)."""
    from ..envs.batch_runner import BatchRunner
    from ..prediction import PredictionModel

    def env_fn(i):
        if ns.fake_env:
            from ..envs import FakeNavEnv
            return lambda: FakeNavEnv(cfg, seed=100 + i)
        return lambda: make_env(cfg, False, seed=100 + i)

    pm = PredictionModel(cfg, device=device) if cfg.only_explore == 0 \
        else None
    runner = BatchRunner(cfg, [env_fn(i) for i in range(cfg.num_envs)],
                         device=device, prediction_model=pm)
    try:
        ticks = ns.ticks or (ns.num_episodes * cfg.max_episode_length
                             // max(cfg.num_envs, 1))
        summary = runner.run(max_ticks=ticks, max_episodes=ns.num_episodes)
    finally:
        runner.close()
    print(summary)
    if "success" in summary:
        print("Average Success: %.4f, Average SPL: %.4f"
              % (summary["success"], summary["spl"]))
    sys.stdout.flush()
    return summary


if __name__ == "__main__":
    main()
