"""Environment wrappers. Port of the ``Log`` wrapper of
purejaxql_tpu/envs/wrappers.py:68-101: per-episode return and length
accounting, reported in ``info`` on the step that ends an episode. The
other wrappers come with the slices that need them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from purejaxql_torch.envs.base import Wrapper


@dataclass
class LogEnvState:
    env_state: Any
    episode_returns: torch.Tensor  # (E,) f32
    episode_lengths: torch.Tensor  # (E,) int32
    returned_episode_returns: torch.Tensor
    returned_episode_lengths: torch.Tensor
    timestep: torch.Tensor  # (E,) int32


class Log(Wrapper):
    """Accumulate per-episode return/length; emit them in `info` on done."""

    def reset(self, generator, num_envs, params=None):
        obs, env_state = self._env.reset(generator, num_envs, params)
        zero_f = torch.zeros(num_envs, device=obs.device)
        zero_i = torch.zeros(num_envs, dtype=torch.int32, device=obs.device)
        state = LogEnvState(env_state, zero_f, zero_i, zero_f, zero_i, zero_i)
        return obs, state

    def step(self, generator, state, action, params=None):
        obs, env_state, reward, done, info = self._env.step(
            generator, state.env_state, action, params
        )
        new_episode_return = state.episode_returns + reward
        new_episode_length = state.episode_lengths + 1
        done_f = done.to(new_episode_return.dtype)
        done_i = done.to(torch.int32)
        not_done = 1 - done_f
        not_done_i = 1 - done_i
        state = LogEnvState(
            env_state=env_state,
            episode_returns=new_episode_return * not_done,
            episode_lengths=new_episode_length * not_done_i,
            returned_episode_returns=state.returned_episode_returns * not_done
            + new_episode_return * done_f,
            returned_episode_lengths=state.returned_episode_lengths * not_done_i
            + new_episode_length * done_i,
            timestep=state.timestep + 1,
        )
        info = dict(info)
        info["returned_episode_returns"] = state.returned_episode_returns
        info["returned_episode_lengths"] = state.returned_episode_lengths
        info["timestep"] = state.timestep
        info["returned_episode"] = done
        return obs, state, reward, done, info
