"""Catch-bsuite: a ball falls one row a step down a rows x columns board and
a paddle on the bottom row (left / stay / right) must be under it when it
lands, batched over E envs.

Port of purejaxql_tpu/envs/classic/catch.py: +1 for a catch, -1 for a miss,
0 elsewhere; the episode ends when the ball lands or after
max_steps_in_episode steps. The observation is the flattened rows x columns
board, one-hot at the ball and at the paddle (catch.py:87-91).

A reset's randomness comes in as an argument (``start_state``, fed by
``draw_start``): the ball's column ~ randint(0, columns) (catch.py:47); the
paddle starts in the middle column. The step draws nothing. ``rows`` and
``columns`` are params, so ENV_KWARGS sizes the board and the obs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment


@dataclass
class CatchState:
    ball_y: torch.Tensor  # int32
    ball_x: torch.Tensor  # int32
    paddle_x: torch.Tensor  # int32
    time: torch.Tensor  # int32


@dataclass(frozen=True)
class CatchParams:
    rows: int = 10
    columns: int = 5
    max_steps_in_episode: int = 2000


def draw_start(generator: torch.Generator, num_envs: int, params: CatchParams) -> torch.Tensor:
    """(E,) int32 reset draws: the ball's column, randint(0, columns)."""
    return torch.randint(0, params.columns, (num_envs,), generator=generator, device=generator.device,
                         dtype=torch.int32)


def start_state(ball_x: torch.Tensor, params: CatchParams) -> CatchState:
    zero = torch.zeros_like(ball_x)
    return CatchState(ball_y=zero, ball_x=ball_x, paddle_x=torch.full_like(ball_x, params.columns // 2), time=zero)


def one_hot_board(rows: int, columns: int, cells) -> torch.Tensor:
    """(E, rows x columns) float32 boards, one at each (row, column) pair of
    (E,) ints in ``cells``."""
    first = cells[0][0]
    board = torch.zeros(first.shape[0], rows * columns, device=first.device)
    for row, col in cells:
        board.scatter_(1, (row.long() * columns + col.long())[:, None], 1.0)
    return board


class Catch(Environment):
    @property
    def default_params(self) -> CatchParams:
        return CatchParams()

    @property
    def name(self) -> str:
        return "Catch-bsuite"

    def reset_env(self, generator, num_envs, params):
        state = start_state(draw_start(generator, num_envs, params), params)
        return self.get_obs(state, params), state

    def step_env(self, state, action, params, draws):
        p = params
        # action: 0 left, 1 stay, 2 right
        paddle_x = torch.clamp(state.paddle_x + (action.to(torch.int32) - 1), 0, p.columns - 1)
        ball_y = state.ball_y + 1
        landed = ball_y == p.rows - 1
        reward = torch.where(landed, torch.where(state.ball_x == paddle_x, 1.0, -1.0), 0.0)
        new_state = CatchState(ball_y=ball_y, ball_x=state.ball_x, paddle_x=paddle_x, time=state.time + 1)
        done = landed | (new_state.time >= p.max_steps_in_episode)
        return self.get_obs(new_state, p), new_state, reward, done, {}

    def get_obs(self, state: CatchState, params) -> torch.Tensor:
        bottom = torch.full_like(state.paddle_x, params.rows - 1)
        return one_hot_board(params.rows, params.columns, ((state.ball_y, state.ball_x), (bottom, state.paddle_x)))

    def observation_space(self, params) -> spaces.Box:
        return spaces.Box(0.0, 1.0, (params.rows * params.columns,), np.float32)

    def action_space(self, params=None) -> spaces.Discrete:
        return spaces.Discrete(3)
