"""Breakout-MinAtar, batched over E envs.

Port of purejaxql_tpu/envs/minatar/breakout.py: a 10x10 grid, 3 actions
[noop, left, right], observations (E, 10, 10, 4) float32 in NHWC with the
channels [paddle, ball, trail, brick]. The ball moves diagonally in one of 4
directions and bounces off the side walls, the ceiling, a brick (+1, the
brick removed, with a one-step strike latch) and the paddle (straight back
when caught from above, re-aimed when caught at the corner); a miss ends
the episode, and clearing every brick respawns the 3-row wall. The step
applies the rules in the order of breakout.py:83-159.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment

# direction -> (dx, dy); 0: up-left, 1: up-right, 2: down-right, 3: down-left
_DX = (-1, 1, 1, -1)
_DY = (-1, -1, 1, 1)
_BOUNCE_X = (1, 0, 3, 2)  # side-wall reflection
_BOUNCE_Y = (3, 2, 1, 0)  # ceiling/brick/paddle reflection
_BOUNCE_CORNER = (2, 3, 0, 1)  # paddle-corner reflection


@dataclass
class BreakoutState:
    ball_y: torch.Tensor  # (E,) int32
    ball_x: torch.Tensor
    ball_dir: torch.Tensor
    pos: torch.Tensor
    brick_map: torch.Tensor  # (E, 10, 10) int32
    strike: torch.Tensor  # (E,) bool
    last_y: torch.Tensor
    last_x: torch.Tensor
    terminal: torch.Tensor  # (E,) bool
    time: torch.Tensor  # (E,) int32


@dataclass(frozen=True)
class BreakoutParams:
    max_steps_in_episode: int = 1000


def wall_rows(num_envs: int, device) -> torch.Tensor:
    """(E, 10, 10) int32 brick maps holding the full wall (rows 1-3)."""
    bricks = torch.zeros(num_envs, 10, 10, dtype=torch.int32, device=device)
    bricks[:, 1:4, :] = 1
    return bricks


def _lookup(table, index: torch.Tensor) -> torch.Tensor:
    return torch.tensor(table, dtype=index.dtype, device=index.device)[index.long()]


def start_state(side: torch.Tensor) -> BreakoutState:
    """The start of an episode for each env, given the ball's side (E,)
    int32: 0 starts it at x = 0 heading down-right, 1 at x = 9 heading
    down-left (breakout.py:66-81)."""
    n, dev = side.shape[0], side.device
    full = lambda v: torch.full((n,), v, dtype=torch.int32, device=dev)  # noqa: E731
    no = torch.zeros(n, dtype=torch.bool, device=dev)
    ball_x = side * 9
    return BreakoutState(
        ball_y=full(3), ball_x=ball_x, ball_dir=side + 2, pos=full(4),
        brick_map=wall_rows(n, dev), strike=no, last_y=full(3),
        last_x=ball_x.clone(), terminal=no.clone(), time=full(0),
    )


class MinBreakout(Environment):
    @property
    def default_params(self) -> BreakoutParams:
        return BreakoutParams()

    @property
    def name(self) -> str:
        return "Breakout-MinAtar"

    def reset_env(self, generator, num_envs, params):
        side = torch.randint(0, 2, (num_envs,), generator=generator, device=generator.device)
        state = start_state(side.to(torch.int32))
        return self.get_obs(state), state

    def step_env(self, state, action, params, draws):
        action = action.to(torch.int32)
        move = torch.where(action == 1, -1, torch.where(action == 2, 1, 0))
        pos = (state.pos + move).clamp(0, 9)

        last_x, last_y = state.ball_x, state.ball_y
        d = state.ball_dir
        new_x = state.ball_x + _lookup(_DX, d)
        new_y = state.ball_y + _lookup(_DY, d)

        # side walls
        hit_wall = (new_x < 0) | (new_x > 9)
        new_x = new_x.clamp(0, 9)
        d = torch.where(hit_wall, _lookup(_BOUNCE_X, d), d)

        # ceiling
        hit_ceiling = new_y < 0
        new_y = new_y.clamp(min=0)
        d = torch.where(hit_ceiling, _lookup(_BOUNCE_Y, d), d)

        # brick strike (latched: no reward while `strike` is held); the row
        # is clamped as JAX clamps a gather index (a ball below the paddle
        # row is never reached in play)
        cell = (torch.arange(d.shape[0], device=d.device), new_y.clamp(max=9).long(), new_x.long())
        hit_brick = state.brick_map[cell] == 1
        scored = hit_brick & ~state.strike
        reward = scored.to(torch.float32)
        brick_map = state.brick_map.clone()
        brick_map[cell] *= (~scored).to(brick_map.dtype)
        d = torch.where(scored, _lookup(_BOUNCE_Y, d), d)
        new_y = torch.where(scored, last_y, new_y)

        # bottom row: paddle or death
        at_bottom = (new_y == 9) & ~hit_brick
        # respawn the wall when cleared
        respawn = at_bottom & (brick_map.sum((1, 2)) == 0)
        brick_map = torch.where(respawn[:, None, None], wall_rows(d.shape[0], d.device), brick_map)
        caught_above = at_bottom & (state.ball_x == pos)
        caught_corner = at_bottom & ~caught_above & (new_x == pos)
        missed = at_bottom & ~(caught_above | caught_corner)
        d = torch.where(caught_above, _lookup(_BOUNCE_Y, d), d)
        d = torch.where(caught_corner, _lookup(_BOUNCE_CORNER, d), d)
        new_y = torch.where(caught_above | caught_corner, last_y, new_y)

        strike = hit_brick & (scored | state.strike)

        new_state = BreakoutState(
            ball_y=new_y,
            ball_x=new_x,
            ball_dir=d,
            pos=pos,
            brick_map=brick_map,
            strike=strike,
            last_y=last_y,
            last_x=last_x,
            terminal=missed,
            time=state.time + 1,
        )
        done = self.is_terminal(new_state, params)
        return self.get_obs(new_state), new_state, reward, done, {}

    def get_obs(self, state: BreakoutState) -> torch.Tensor:
        n = state.pos.shape[0]
        dev = state.pos.device
        rows = torch.arange(10, device=dev)[None, :, None]
        cols = torch.arange(10, device=dev)[None, None, :]

        def at(y, x):
            return ((rows == y[:, None, None]) & (cols == x[:, None, None])).to(torch.float32)

        nine = torch.full((n,), 9, dtype=state.pos.dtype, device=dev)
        return torch.stack(
            [
                at(nine, state.pos),
                at(state.ball_y, state.ball_x),
                at(state.last_y, state.last_x),
                state.brick_map.to(torch.float32),
            ],
            -1,
        )

    def is_terminal(self, state: BreakoutState, params: BreakoutParams) -> torch.Tensor:
        return state.terminal | (state.time >= params.max_steps_in_episode)

    def observation_space(self, params) -> spaces.Box:
        return spaces.Box(0.0, 1.0, (10, 10, 4))

    def action_space(self, params=None) -> spaces.Discrete:
        return spaces.Discrete(3)
