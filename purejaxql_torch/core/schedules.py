"""Schedules for exploration epsilon and learning rate.

Port of purejaxql_tpu/core/schedules.py with ``optax.linear_schedule``'s
semantics: the count is clipped to ``[0, transition_steps]``, and a
non-positive ``transition_steps`` gives the constant ``init_value``. Counts
are host integers, so a schedule costs no device work; the value is computed
in float32 with optax's order of operations and returned as a Python float.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np

Schedule = Callable[[int], float]


def linear_schedule(init_value: float, end_value: float, transition_steps) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init_value
    steps = np.float32(transition_steps)
    span = np.float32(init_value - end_value)
    end = np.float32(end_value)

    def schedule(count: int) -> float:
        c = np.float32(min(max(count, 0), transition_steps))
        frac = np.float32(1.0) - c / steps
        return float(span * frac + end)

    return schedule


def epsilon_schedule(eps_start: float, eps_finish: float, eps_decay_updates: float) -> Schedule:
    """Linear decay of exploration epsilon over `eps_decay_updates` updates."""
    return linear_schedule(eps_start, eps_finish, eps_decay_updates)


def lr_schedule(config) -> Union[float, Schedule]:
    """LR: constant, or linear decay to ~0 over all gradient steps when
    LR_LINEAR_DECAY is set."""
    if config.get("LR_LINEAR_DECAY", False):
        return linear_schedule(
            config["LR"],
            1e-20,
            config["NUM_UPDATES_DECAY"]
            * config["NUM_MINIBATCHES"]
            * config["NUM_EPOCHS"],
        )
    return config["LR"]
