"""Batched environment protocol.

Port of purejaxql_tpu/envs/base.py. Where the JAX package writes one env and
``vmap``s it, an environment here steps a whole batch: its state is a
dataclass of (E,)-shaped tensors, and ``reset``/``step`` take the batch size
and a ``torch.Generator`` on the device the envs live on.

Auto-reset: ``step`` computes both the stepped state and a fresh reset
state and selects between them on ``done`` (purejaxql_tpu/envs/base.py:
77-84), so a finished env starts its next episode on the same step.

Randomness inside a step: where the JAX env draws from the step's key (an
Asterix spawn, new Freeway car speeds), the env here takes the draws as an
argument, ``step_env(state, action, params, draws)``, and makes them with
``step_draws(generator, num_envs)``. So one set of rules serves three
callers: ``step`` draws them from the device generator, each fused rollout's
plain twin passes its kernel's Philox words, and the tests pass the draws the
JAX env makes from its own key. An env whose step draws nothing returns
``NO_DRAWS``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from purejaxql_torch.envs import spaces


def select_env(done: torch.Tensor, on_true: torch.Tensor, on_false: torch.Tensor) -> torch.Tensor:
    """Per-env select between two (E, ...) tensors of any rank."""
    mask = done.reshape(done.shape + (1,) * (on_true.dim() - done.dim()))
    return torch.where(mask, on_true, on_false)


def select_state(done: torch.Tensor, on_true, on_false):
    """Per-env select between two state dataclasses of (E, ...) tensors."""
    return dataclasses.replace(
        on_false,
        **{
            f.name: select_env(done, getattr(on_true, f.name), getattr(on_false, f.name))
            for f in dataclasses.fields(on_false)
        },
    )


@dataclasses.dataclass(frozen=True)
class NoDraws:
    """The draws of an env whose step takes no randomness."""


NO_DRAWS = NoDraws()


class Environment:
    """Base class: subclasses implement ``reset_env``/``step_env``/spaces."""

    @property
    def default_params(self):
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__

    def reset(self, generator: torch.Generator, num_envs: int, params=None):
        if params is None:
            params = self.default_params
        return self.reset_env(generator, num_envs, params)

    def step(self, generator: torch.Generator, state, action: torch.Tensor, params=None):
        """Step with auto-reset on episode end."""
        if params is None:
            params = self.default_params
        draws = self.step_draws(generator, action.shape[0])
        obs_st, state_st, reward, done, info = self.step_env(state, action, params, draws)
        obs_re, state_re = self.reset_env(generator, done.shape[0], params)
        state = select_state(done, state_re, state_st)
        obs = select_env(done, obs_re, obs_st)
        return obs, state, reward, done, info

    def reset_env(self, generator: torch.Generator, num_envs: int, params) -> Tuple[torch.Tensor, Any]:
        raise NotImplementedError

    def step_draws(self, generator: torch.Generator, num_envs: int):
        """The random inputs of one step of ``num_envs`` envs."""
        return NO_DRAWS

    def step_env(self, state, action: torch.Tensor, params, draws):
        raise NotImplementedError

    def observation_space(self, params) -> spaces.Space:
        raise NotImplementedError

    def action_space(self, params) -> spaces.Space:
        raise NotImplementedError


class Wrapper(Environment):
    """Attribute-forwarding wrapper base."""

    def __init__(self, env: Environment):
        self._env = env

    def __getattr__(self, name: str) -> Any:
        return getattr(self._env, name)

    def reset(self, generator, num_envs, params=None):
        return self._env.reset(generator, num_envs, params)

    def step(self, generator, state, action, params=None):
        return self._env.step(generator, state, action, params)

    @property
    def default_params(self):
        return self._env.default_params

    def observation_space(self, params):
        return self._env.observation_space(params)

    def action_space(self, params):
        return self._env.action_space(params)
