"""Blocked-agent escape policy (Stubborn-derived).

State machine matching the reference UnTrapHelper
(PEANUT nav/agent/agent_helper.py:19-48): scripted left/right
escalation keyed on how many untrap episodes have occurred, falling back to
random turns after 30 attempts.  Action ids: 2 = turn left, 3 = turn right.
"""

from __future__ import annotations

import numpy as np


class UnTrapHelper:
    def __init__(self):
        self.total_id = 0
        self.epi_id = 0

    def reset(self, full: bool = False) -> None:
        self.total_id += 1
        if full:
            self.total_id = 0
        self.epi_id = 0

    def get_action(self) -> int:
        self.epi_id += 1
        if self.epi_id > 30:
            return int(np.random.randint(2, 4))
        if self.epi_id > 18:
            return 2 if self.total_id % 2 == 0 else 3
        if self.epi_id < 3:
            return 2 if self.total_id % 2 == 0 else 3
        return 3 if self.total_id % 2 == 0 else 2
