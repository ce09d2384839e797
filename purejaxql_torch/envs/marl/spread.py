"""Spread: a cooperative multi-agent coverage env (MPE simple-spread-class).

Port of purejaxql_tpu/envs/marl/spread.py, batched. N homogeneous agents
move on the [-1, 1]^2 plane and must jointly cover N landmarks; the team
reward is minus the sum over landmarks of the distance to the closest agent,
minus 0.5 a colliding pair. Five actions (noop and four impulses), 25-step
episodes, auto-reset at the horizon into the state of the step's draws
(spread.py:102).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.marl.base import MultiAgentEnv

_IMPULSE = ((0.0, 0.0), (-1.0, 0.0), (1.0, 0.0), (0.0, -1.0), (0.0, 1.0))


@dataclass
class SpreadState:
    agent_pos: torch.Tensor  # (E, N, 2)
    agent_vel: torch.Tensor  # (E, N, 2)
    landmark_pos: torch.Tensor  # (E, N, 2)
    time: torch.Tensor  # (E,) int32


@dataclass
class SpreadDraws:
    """A reset's draws: positions uniform in [-1, 1)^2."""

    agent_pos: torch.Tensor  # (E, N, 2)
    landmark_pos: torch.Tensor  # (E, N, 2)


def norm(x: torch.Tensor) -> torch.Tensor:
    """The Euclidean norm over the last axis, as ``jnp.linalg.norm`` sums it."""
    return torch.sqrt((x * x).sum(-1))


class Spread(MultiAgentEnv):
    def __init__(
        self,
        num_agents: int = 3,
        max_steps: int = 25,
        dt: float = 0.1,
        damping: float = 0.25,
        accel: float = 3.0,
        collision_radius: float = 0.1,
    ):
        self.num_agents = num_agents
        self.agents = [f"agent_{i}" for i in range(num_agents)]
        self.max_steps = max_steps
        self.dt = dt
        self.damping = damping
        self.accel = accel
        self.collision_radius = collision_radius
        # obs: own pos + vel, landmarks relative, other agents relative
        self.obs_dim = 4 + 2 * num_agents + 2 * (num_agents - 1)

    def reset_draws(self, generator: torch.Generator, num_envs: int) -> SpreadDraws:
        shape = (num_envs, self.num_agents, 2)

        def uniform():
            return torch.rand(shape, generator=generator, device=generator.device) * 2.0 - 1.0

        return SpreadDraws(agent_pos=uniform(), landmark_pos=uniform())

    def reset_env(self, draws: SpreadDraws) -> SpreadState:
        return SpreadState(
            agent_pos=draws.agent_pos,
            agent_vel=torch.zeros_like(draws.agent_pos),
            landmark_pos=draws.landmark_pos,
            time=torch.zeros(draws.agent_pos.shape[0], dtype=torch.int32, device=draws.agent_pos.device),
        )

    def step_env(self, state: SpreadState, actions: Dict):
        acts = torch.stack([actions[a] for a in self.agents], 1)  # (E, N)
        impulse = self.constant("impulse", _IMPULSE, acts.device)[acts] * self.accel
        vel = state.agent_vel * (1 - self.damping) + impulse * self.dt
        pos = torch.clamp(state.agent_pos + vel * self.dt, -1.2, 1.2)

        # team reward: coverage and the collision penalty
        d = norm(pos[:, None, :, :] - state.landmark_pos[:, :, None, :])  # (E, landmark, agent)
        coverage = -d.min(2).values.sum(1)
        aa = norm(pos[:, None, :, :] - pos[:, :, None, :])
        ncol = ((aa < 2 * self.collision_radius).sum((1, 2)) - self.num_agents) / 2
        reward = coverage - 0.5 * ncol

        new_time = state.time + 1
        stepped = SpreadState(agent_pos=pos, agent_vel=vel, landmark_pos=state.landmark_pos, time=new_time)
        return stepped, reward, new_time >= self.max_steps, {}

    def get_obs(self, state: SpreadState) -> Dict[str, torch.Tensor]:
        pos = state.agent_pos
        n_envs = pos.shape[0]
        obs = {}
        for i, a in enumerate(self.agents):
            rel_land = (state.landmark_pos - pos[:, i:i + 1]).reshape(n_envs, -1)
            others = torch.cat([pos[:, :i], pos[:, i + 1:]], 1)
            rel_others = (others - pos[:, i:i + 1]).reshape(n_envs, -1)
            obs[a] = torch.cat([pos[:, i], state.agent_vel[:, i], rel_land, rel_others], 1)
        return obs

    def observation_space(self, agent: str) -> spaces.Box:
        return spaces.Box(-2.0, 2.0, (self.obs_dim,))

    def action_space(self, agent: str) -> spaces.Discrete:
        return spaces.Discrete(5)
