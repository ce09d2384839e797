"""Environment wrappers. Port of purejaxql_tpu/envs/wrappers.py for the
wrappers the ported trainers use:

- ``Log`` (wrappers.py:68-101): per-episode return and length accounting,
  reported in ``info`` on the step that ends an episode;
- ``ScrubNaN`` (:488-524): non-finite rewards and observations become 0,
  counted per env in ``info["nan_events"]``;
- ``LogVec`` (:691-742): ``Log`` for the continuous-control stack, with a
  scalar step counter and the raw reward as ``info["original_reward"]``;
- ``ClipAction`` (:527-537): clip continuous actions to the box.

``VecEnv`` has no counterpart: an env here already steps a whole batch. The
other wrappers (the observation and reward normalizers among them) come with
the slices that need them.
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


class ScrubNaN(Wrapper):
    """Zero non-finite rewards and observations at the env boundary, and
    count what was scrubbed per env in ``info["nan_events"]`` (int32, zero on
    a healthy env)."""

    def reset(self, generator, num_envs, params=None):
        obs, state = self._env.reset(generator, num_envs, params)
        return torch.where(torch.isfinite(obs), obs, 0.0), state

    def step(self, generator, state, action, params=None):
        obs, state, reward, done, info = self._env.step(generator, state, action, params)
        bad_r = ~torch.isfinite(reward)
        bad_o = (~torch.isfinite(obs)).reshape(reward.shape[0], -1).sum(-1)
        info = dict(info)
        info["nan_events"] = (bad_r.to(torch.int32) + bad_o).to(torch.int32)
        reward = torch.where(bad_r, 0.0, reward)
        obs = torch.where(torch.isfinite(obs), obs, 0.0)
        return obs, state, reward, done, info


class ClipAction(Wrapper):
    """Clip continuous actions to [low, high]."""

    def __init__(self, env, low: float = -1.0, high: float = 1.0):
        super().__init__(env)
        self.low, self.high = low, high

    def step(self, generator, state, action, params=None):
        return self._env.step(generator, state, action.clamp(self.low, self.high), params)


@dataclass
class LogVecState:
    env_state: Any
    episode_returns: torch.Tensor  # (E,) f32
    episode_lengths: torch.Tensor  # (E,) int32
    returned_episode_returns: torch.Tensor
    returned_episode_lengths: torch.Tensor
    timestep: torch.Tensor  # () int32, one counter for the batch


class LogVec(Wrapper):
    """Batched episode accounting for the continuous-control stack; also
    reports the reward it saw as ``original_reward`` and the scalar step
    counter broadcast to (E,)."""

    def reset(self, generator, num_envs, params=None):
        obs, env_state = self._env.reset(generator, num_envs, params)
        zero_f = torch.zeros(num_envs, device=obs.device)
        zero_i = torch.zeros(num_envs, dtype=torch.int32, device=obs.device)
        timestep = torch.zeros((), dtype=torch.int32, device=obs.device)
        return obs, LogVecState(env_state, zero_f, zero_i, zero_f, zero_i, timestep)

    def step(self, generator, state, action, params=None):
        obs, env_state, reward, done, info = self._env.step(
            generator, state.env_state, action, params
        )
        new_episode_return = state.episode_returns + reward
        new_episode_length = state.episode_lengths + 1
        done_f = done.to(new_episode_return.dtype)
        done_i = done.to(torch.int32)
        state = LogVecState(
            env_state=env_state,
            episode_returns=new_episode_return * (1 - done_f),
            episode_lengths=new_episode_length * (1 - done_i),
            returned_episode_returns=state.returned_episode_returns * (1 - done_f)
            + new_episode_return * done_f,
            returned_episode_lengths=state.returned_episode_lengths * (1 - done_i)
            + new_episode_length * done_i,
            timestep=state.timestep + 1,
        )
        info = dict(info)
        info["returned_episode_returns"] = state.returned_episode_returns
        info["returned_episode_lengths"] = state.returned_episode_lengths
        info["returned_episode"] = done
        info["timestep"] = state.timestep.expand(done.shape)
        info["original_reward"] = reward
        return obs, state, reward, done, info
