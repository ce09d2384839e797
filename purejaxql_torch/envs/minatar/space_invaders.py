"""SpaceInvaders-MinAtar, batched over E envs.

Port of purejaxql_tpu/envs/minatar/space_invaders.py: a cannon on the
bottom row with 4 actions [noop, left, right, fire] shoots, with a cooldown,
at a 4x6 wave of aliens that marches sideways, drops a row and turns at the
walls, and shoots back from the column nearest the cannon. A kill scores
+1; an enemy bullet on the cannon, an alien on it, or a drop with aliens on
the bottom row ends the episode. A cleared wave respawns and marches
faster. Observations (E, 10, 10, 6) float32, channels [cannon, alien,
alien moving left, alien moving right, friendly bullet, enemy bullet]. The
step follows space_invaders.py:73-185; the env draws no randomness.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment


@dataclass
class SpaceInvadersState:
    pos: torch.Tensor  # (E,) int32
    f_bullet_map: torch.Tensor  # (E, 10, 10) int32
    e_bullet_map: torch.Tensor  # (E, 10, 10) int32
    alien_map: torch.Tensor  # (E, 10, 10) int32
    alien_dir: torch.Tensor  # (E,) int32, -1 or +1
    enemy_move_interval: torch.Tensor
    alien_move_timer: torch.Tensor
    alien_shot_timer: torch.Tensor
    ramp_index: torch.Tensor
    shot_timer: torch.Tensor
    terminal: torch.Tensor  # (E,) bool
    time: torch.Tensor  # (E,) int32


@dataclass(frozen=True)
class SpaceInvadersParams:
    shot_cool_down: int = 5
    enemy_move_interval: int = 12
    enemy_shot_interval: int = 10
    ramping: bool = True
    max_steps_in_episode: int = 1000


def alien_wave(num_envs: int, device) -> torch.Tensor:
    """(E, 10, 10) int32 maps holding a fresh wave: rows 0-3, columns 2-7."""
    wave = torch.zeros(num_envs, 10, 10, dtype=torch.int32, device=device)
    wave[:, 0:4, 2:8] = 1
    return wave


def start_state(num_envs: int, params: SpaceInvadersParams, device) -> SpaceInvadersState:
    """The start of an episode (space_invaders.py:55-71)."""
    full = lambda v: torch.full((num_envs,), v, dtype=torch.int32, device=device)  # noqa: E731
    empty = torch.zeros(num_envs, 10, 10, dtype=torch.int32, device=device)
    return SpaceInvadersState(
        pos=full(5), f_bullet_map=empty, e_bullet_map=empty.clone(),
        alien_map=alien_wave(num_envs, device), alien_dir=full(-1),
        enemy_move_interval=full(params.enemy_move_interval),
        alien_move_timer=full(params.enemy_move_interval),
        alien_shot_timer=full(params.enemy_shot_interval), ramp_index=full(0),
        shot_timer=full(0), terminal=torch.zeros(num_envs, dtype=torch.bool, device=device),
        time=full(0),
    )


class MinSpaceInvaders(Environment):
    @property
    def default_params(self) -> SpaceInvadersParams:
        return SpaceInvadersParams()

    @property
    def name(self) -> str:
        return "SpaceInvaders-MinAtar"

    def reset_env(self, generator, num_envs, params):
        state = start_state(num_envs, params, generator.device)
        return self.get_obs(state), state

    def step_env(self, state, action, params, draws):
        action = action.to(torch.int32)
        n, dev = action.shape[0], action.device
        envs = torch.arange(n, device=dev)
        cols = torch.arange(10, device=dev)

        # the cannon moves, then fires from its new column
        fire = (action == 3) & (state.shot_timer == 0)
        move = (action == 2).to(torch.int32) - (action == 1).to(torch.int32)
        pos = (state.pos + move).clamp(0, 9)
        f_bullet_map = state.f_bullet_map.clone()
        f_bullet_map[envs, 9, pos] = torch.where(fire, 1, f_bullet_map[envs, 9, pos]).to(torch.int32)
        shot_timer = torch.where(
            fire, params.shot_cool_down, (state.shot_timer - 1).clamp(min=0)
        ).to(torch.int32)

        # bullets travel: friendly up, enemy down
        f_bullet_map = torch.roll(f_bullet_map, -1, dims=1)
        f_bullet_map[:, 9, :] = 0
        e_bullet_map = torch.roll(state.e_bullet_map, 1, dims=1)
        e_bullet_map[:, 0, :] = 0
        terminal = state.terminal | (e_bullet_map[envs, 9, pos] == 1)

        # the alien march: a drop and a turn at the wall, else a step sideways
        alien_map, alien_dir = state.alien_map, state.alien_dir
        do_move = state.alien_move_timer == 0
        at_edge = ((alien_map[:, :, 0].sum(1) > 0) & (alien_dir < 0)) | (
            (alien_map[:, :, 9].sum(1) > 0) & (alien_dir > 0)
        )
        drop = do_move & at_edge
        shift = do_move & ~at_edge
        terminal = terminal | (drop & (alien_map[:, 9, :].sum(1) > 0))
        alien_dir = torch.where(drop, -alien_dir, alien_dir)
        alien_map = torch.where(drop[:, None, None], torch.roll(alien_map, 1, dims=1), alien_map)
        sideways = torch.where(
            (state.alien_dir < 0)[:, None, None],
            torch.roll(alien_map, -1, dims=2),
            torch.roll(alien_map, 1, dims=2),
        )
        alien_map = torch.where(shift[:, None, None], sideways, alien_map)
        alien_move_timer = torch.where(
            do_move,
            torch.minimum(alien_map.sum((1, 2)).to(torch.int32), state.enemy_move_interval),
            state.alien_move_timer - 1,
        )
        terminal = terminal | (alien_map[envs, 9, pos] == 1)

        # the lowest alien of the column nearest the cannon shoots (the
        # first such column on ties)
        do_shoot = state.alien_shot_timer == 0
        col_has = alien_map.sum(1) > 0
        col_dist = torch.where(col_has, (cols - pos[:, None]).abs(), 100)
        shoot_col = col_dist.argmin(1)
        col_aliens = alien_map[envs, :, shoot_col]
        shoot_row = torch.where(col_aliens > 0, cols, -1).max(1).values.clamp(min=0)
        can_shoot = do_shoot & col_has.any(1)
        e_bullet_map[envs, shoot_row, shoot_col] = torch.where(
            can_shoot, 1, e_bullet_map[envs, shoot_row, shoot_col]
        ).to(torch.int32)
        alien_shot_timer = torch.where(
            do_shoot, params.enemy_shot_interval, state.alien_shot_timer - 1
        ).to(torch.int32)

        # kills
        kill = ((alien_map == 1) & (f_bullet_map == 1)).to(torch.int32)
        reward = kill.sum((1, 2)).to(torch.float32)
        alien_map = alien_map * (1 - kill)
        f_bullet_map = f_bullet_map * (1 - kill)

        # a cleared wave respawns, and the march speeds up
        cleared = alien_map.sum((1, 2)) == 0
        alien_map = torch.where(cleared[:, None, None], alien_wave(n, dev), alien_map)
        ramp = cleared & (state.enemy_move_interval > 6) & params.ramping
        new_state = SpaceInvadersState(
            pos=pos,
            f_bullet_map=f_bullet_map,
            e_bullet_map=e_bullet_map,
            alien_map=alien_map,
            alien_dir=alien_dir,
            enemy_move_interval=state.enemy_move_interval - ramp.to(torch.int32),
            alien_move_timer=alien_move_timer,
            alien_shot_timer=alien_shot_timer,
            ramp_index=state.ramp_index + cleared.to(torch.int32),
            shot_timer=shot_timer,
            terminal=terminal,
            time=state.time + 1,
        )
        done = self.is_terminal(new_state, params)
        return self.get_obs(new_state), new_state, reward, done, {}

    def get_obs(self, state: SpaceInvadersState) -> torch.Tensor:
        n, dev = state.pos.shape[0], state.pos.device
        alien = state.alien_map.to(torch.float32)
        cannon = torch.zeros(n, 10, 10, dtype=torch.float32, device=dev)
        cannon[:, 9, :] = (torch.arange(10, device=dev) == state.pos[:, None]).to(torch.float32)
        left = (state.alien_dir < 0)[:, None, None]
        right = (state.alien_dir > 0)[:, None, None]
        return torch.stack(
            [
                cannon,
                alien,
                torch.where(left, alien, 0.0),
                torch.where(right, alien, 0.0),
                state.f_bullet_map.to(torch.float32),
                state.e_bullet_map.to(torch.float32),
            ],
            -1,
        )

    def is_terminal(self, state: SpaceInvadersState, params: SpaceInvadersParams) -> torch.Tensor:
        return state.terminal | (state.time >= params.max_steps_in_episode)

    def observation_space(self, params) -> spaces.Box:
        return spaces.Box(0.0, 1.0, (10, 10, 6))

    def action_space(self, params=None) -> spaces.Discrete:
        return spaces.Discrete(4)
