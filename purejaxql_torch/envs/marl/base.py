"""Multi-agent env protocol (jaxmarl-style), the team-return Log wrapper and
the batched rollout manager.

Port of purejaxql_tpu/envs/marl/base.py. Where the JAX package writes one env
and ``vmap``s it, an env here steps a whole batch of E envs: its state is a
dataclass of (E, ...) tensors, and its observations, actions, rewards and
dones are dicts keyed by agent (plus ``"__all__"`` for the team reward and
episode end) of (E, ...) tensors.

Randomness is passed in, as the single-agent envs take theirs
(``envs/base.py:step_draws``): ``reset_draws(generator, num_envs)`` makes the
random inputs of a reset (Spread's and Skirmish's positions, Hanabi's
shuffled deck; Kitchen's reset draws nothing), ``reset_env(draws)`` builds
the state from them, and ``step(state, actions, draws)`` auto-resets every
env whose episode ended into the state ``draws`` gives, as the JAX envs
reset from their step key (spread.py:102). So a test can hand both packages
the same reset.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import select_state


class MultiAgentEnv:
    """A batch of multi-agent envs: subclasses implement ``reset_draws``,
    ``reset_env``, ``step_env``, ``get_obs`` and the spaces."""

    agents: List[str]
    num_agents: int

    def constant(self, name: str, value, device, dtype=torch.float32) -> torch.Tensor:
        """A constant table of the env on ``device``, copied there once (a
        copy from the host each step would wait for the device)."""
        cache = self.__dict__.setdefault("_constants", {})
        key = (name, str(device))
        if key not in cache:
            cache[key] = torch.as_tensor(value, dtype=dtype).to(device)
        return cache[key]

    def reset_draws(self, generator: torch.Generator, num_envs: int) -> Any:
        raise NotImplementedError

    def reset_env(self, draws) -> Any:
        """The reset state built from ``draws``."""
        raise NotImplementedError

    def reset(self, generator: torch.Generator, num_envs: int) -> Tuple[Dict, Any]:
        state = self.reset_env(self.reset_draws(generator, num_envs))
        return self.get_obs(state), state

    def step_env(self, state, actions: Dict) -> Tuple[Any, torch.Tensor, torch.Tensor, Dict]:
        """One step without reset: (stepped state, team reward (E,), done
        (E,) bool, infos)."""
        raise NotImplementedError

    def step(self, state, actions: Dict, draws) -> Tuple[Dict, Any, Dict, Dict, Dict]:
        """Returns (obs, state, rewards, dones, infos), every env whose
        episode ended reset into the state of ``draws``; rewards and dones
        carry an ``"__all__"`` entry (the team's). The JAX envs select each
        state leaf and each observation on done; the observation here is
        taken of the selected state, which gives the same values."""
        stepped, reward, done, infos = self.step_env(state, actions)
        state = select_state(done, self.reset_env(draws), stepped)
        rewards = {a: reward for a in self.agents}
        rewards["__all__"] = reward
        dones = {a: done for a in self.agents}
        dones["__all__"] = done
        return self.get_obs(state), state, rewards, dones, infos

    def get_obs(self, state) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def get_avail_actions(self, state) -> Dict[str, torch.Tensor]:
        """Legal-action mask per agent, (E, n) float 0/1 (all legal by
        default)."""
        first = getattr(state, dataclasses.fields(state)[0].name)
        return {
            a: torch.ones(first.shape[0], self.action_space(a).n, device=first.device) for a in self.agents
        }

    def observation_space(self, agent: str) -> spaces.Space:
        raise NotImplementedError

    def action_space(self, agent: str) -> spaces.Space:
        raise NotImplementedError


@dataclasses.dataclass
class MARLLogState:
    env_state: Any
    episode_returns: torch.Tensor  # (E,) float32
    episode_lengths: torch.Tensor  # (E,) int32
    returned_episode_returns: torch.Tensor
    returned_episode_lengths: torch.Tensor


class MARLLogWrapper(MultiAgentEnv):
    """Episode accounting for multi-agent envs (base.py:48-95): tracks the
    team ("__all__") return and length and emits the returned_episode_*
    infos, the last finished episode's, every step."""

    def __init__(self, env: MultiAgentEnv):
        self._env = env
        self.agents = env.agents
        self.num_agents = env.num_agents

    def __getattr__(self, name):
        return getattr(self._env, name)

    def reset_draws(self, generator, num_envs):
        return self._env.reset_draws(generator, num_envs)

    def reset(self, generator, num_envs):
        obs, env_state = self._env.reset(generator, num_envs)
        dev = obs[self.agents[0]].device
        zero = torch.zeros(num_envs, device=dev)
        zero_i = torch.zeros(num_envs, dtype=torch.int32, device=dev)
        return obs, MARLLogState(env_state, zero, zero_i, zero, zero_i)

    def step(self, state: MARLLogState, actions, draws):
        obs, env_state, rewards, dones, info = self._env.step(state.env_state, actions, draws)
        done = dones["__all__"]
        new_ret = state.episode_returns + rewards["__all__"]
        new_len = state.episode_lengths + 1
        not_done = 1 - done.to(torch.int32)
        state = MARLLogState(
            env_state,
            new_ret * not_done,
            new_len * not_done,
            state.returned_episode_returns * not_done + new_ret * done,
            state.returned_episode_lengths * not_done + new_len * done.to(torch.int32),
        )
        info = dict(info)
        info["returned_episode_returns"] = state.returned_episode_returns
        info["returned_episode_lengths"] = state.returned_episode_lengths
        info["returned_episode"] = done
        return obs, state, rewards, dones, info

    def get_obs(self, state: MARLLogState):
        return self._env.get_obs(state.env_state)

    def get_avail_actions(self, state: MARLLogState):
        return self._env.get_avail_actions(state.env_state)

    def observation_space(self, agent: str):
        return self._env.observation_space(agent)

    def action_space(self, agent: str):
        return self._env.action_space(agent)


class CTRolloutManager:
    """Centralized-training rollout manager over a batch of ``batch_size``
    envs (base.py:98-129): batched reset and step, each drawing its
    randomness from the generator it is given, and the legal-action masks."""

    def __init__(self, env: MultiAgentEnv, batch_size: int):
        self._env = env
        self.batch_size = batch_size
        self.agents = env.agents
        self.num_agents = env.num_agents
        self.max_action_space = max(env.action_space(a).n for a in env.agents)
        self.obs_size = max(
            int(torch.tensor(env.observation_space(a).shape).prod()) for a in env.agents
        )

    def batch_reset(self, generator: torch.Generator):
        return self._env.reset(generator, self.batch_size)

    def batch_step(self, generator: torch.Generator, state, actions: Dict):
        return self._env.step(state, actions, self._env.reset_draws(generator, self.batch_size))

    def get_valid_actions(self, state) -> Dict[str, torch.Tensor]:
        return self._env.get_avail_actions(state)
