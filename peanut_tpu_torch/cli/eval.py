"""Habitat Challenge submission entry (torch port of
``peanut_tpu.cli.eval``, PEANUT's nav/eval.py).

Drives the agent through habitat.Challenge's episode loop, local or remote
(--evaluation local|remote).  Needs the habitat challenge image: habitat is
imported only inside ``main``, so this module imports without it.
"""

from __future__ import annotations

from ..agent import PeanutAgent
from ..config import NavConfig


class _ChallengeAgent:
    """habitat.Agent-shaped shim over PeanutAgent (duck-typed so this module
    imports without habitat installed)."""

    def __init__(self, agent: PeanutAgent):
        self._agent = agent

    def reset(self):
        self._agent.reset()

    def act(self, observations):
        return self._agent.act(observations)


def main(argv=None, device=None):
    import habitat

    cfg = NavConfig.from_args(argv)
    nav_agent = _ChallengeAgent(PeanutAgent(cfg, device=device))
    challenge = habitat.Challenge(eval_remote=(cfg.evaluation != "local"))
    challenge.submit(nav_agent)


if __name__ == "__main__":
    main()
