"""DeepSea-bsuite: the N x N hard-exploration grid, batched over E envs.

Port of purejaxql_tpu/envs/classic/deep_sea.py: the agent starts top-left
and descends one row a step, left or right; only the all-right path reaches
the treasure in the bottom-right corner (+1), and every right move costs
0.01 / N. Which action means "right" is drawn per column at reset (the
state's ``action_map``, bsuite's randomize_actions); the step looks up each
env's own column with a gather. The episode ends at the bottom row or after
max_steps_in_episode steps. The observation is the flattened N x N board,
one-hot at the agent.

A reset's randomness comes in as an argument (``start_state``, fed by
``draw_start``): the (E, size) action map ~ bernoulli(0.5) (deep_sea.py:
48-50). The step draws nothing. ``size`` is a param, so ENV_KWARGS sizes the
state and the obs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment
from purejaxql_torch.envs.classic.catch import one_hot_board


@dataclass
class DeepSeaState:
    row: torch.Tensor  # int32
    column: torch.Tensor  # int32
    action_map: torch.Tensor  # (E, size) int32: which action means "right" per column
    time: torch.Tensor  # int32


@dataclass(frozen=True)
class DeepSeaParams:
    size: int = 8
    deterministic: bool = True
    max_steps_in_episode: int = 2000


def draw_start(generator: torch.Generator, num_envs: int, params: DeepSeaParams) -> torch.Tensor:
    """(E, size) int32 reset draws: the action map, bernoulli(0.5)."""
    u = torch.rand((num_envs, params.size), generator=generator, device=generator.device)
    return (u < 0.5).to(torch.int32)


def start_state(action_map: torch.Tensor) -> DeepSeaState:
    zero = torch.zeros(action_map.shape[0], dtype=torch.int32, device=action_map.device)
    return DeepSeaState(row=zero, column=zero, action_map=action_map, time=zero)


class DeepSea(Environment):
    @property
    def default_params(self) -> DeepSeaParams:
        return DeepSeaParams()

    @property
    def name(self) -> str:
        return "DeepSea-bsuite"

    def reset_env(self, generator, num_envs, params):
        state = start_state(draw_start(generator, num_envs, params))
        return self.get_obs(state, params), state

    def step_env(self, state, action, params, draws):
        p = params
        right_action = state.action_map.gather(1, state.column.long()[:, None])[:, 0]
        go_right = action.to(torch.int32) == right_action
        column = torch.clamp(torch.where(go_right, state.column + 1, state.column - 1), 0, p.size - 1)
        row = state.row + 1
        at_bottom = row == p.size
        treasure = at_bottom & (column == p.size - 1)
        reward = torch.where(treasure, 1.0, 0.0) - torch.where(go_right, 0.01 / p.size, 0.0)
        new_state = DeepSeaState(row=torch.clamp_max(row, p.size - 1), column=column, action_map=state.action_map,
                                 time=state.time + 1)
        done = at_bottom | (new_state.time >= p.max_steps_in_episode)
        return self.get_obs(new_state, p), new_state, reward, done, {}

    def get_obs(self, state: DeepSeaState, params) -> torch.Tensor:
        return one_hot_board(params.size, params.size, ((state.row, state.column),))

    def observation_space(self, params) -> spaces.Box:
        return spaces.Box(0.0, 1.0, (params.size * params.size,), np.float32)

    def action_space(self, params=None) -> spaces.Discrete:
        return spaces.Discrete(2)
