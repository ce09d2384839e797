"""AcrobotSwingup-v0 / AcrobotSwingupSparse-v0: the acrobot under a
continuous elbow torque, batched over E envs.

Port of purejaxql_tpu/envs/classic/acrobot_swingup.py: Acrobot-v1's
equations of motion, RK4 step and params (acrobot.py's ``integrate``), the
torque clip(action, -1, 1), no solve-and-terminate: 500-step episodes. Over the
normalized tip height h = (-cos q1 - cos(q1 + q2)) / 2 the dense task pays
(h + 1) / 2, the sparse one 1 while h > 0.9. Observations as Acrobot-v1's.

A reset's randomness comes in as an argument (acrobot.py's ``start_state``,
fed by its ``draw_start``): the four state values ~ U[-0.1, 0.1). The step
draws nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment
from purejaxql_torch.envs.classic import acrobot


class AcrobotSwingup(Environment):
    def __init__(self, sparse: bool = False):
        self.sparse = sparse

    @property
    def default_params(self) -> acrobot.AcrobotParams:
        return acrobot.AcrobotParams()

    @property
    def name(self) -> str:
        return "AcrobotSwingupSparse-v0" if self.sparse else "AcrobotSwingup-v0"

    def reset_env(self, generator, num_envs, params):
        state = acrobot.start_state(acrobot.draw_start(generator, num_envs))
        return acrobot.get_obs(state), state

    def step_env(self, state, action, params, draws):
        p = params
        new_state = acrobot.integrate(state, torch.clamp(action[:, 0], -1.0, 1.0), p)
        # normalized tip height in [-1, 1]: -1 hanging, +1 fully inverted
        h = (-torch.cos(new_state.joint_angle1) - torch.cos(new_state.joint_angle1 + new_state.joint_angle2)) / 2.0
        reward = (h > 0.9).float() if self.sparse else (h + 1.0) / 2.0
        done = new_state.time >= p.max_steps_in_episode
        return acrobot.get_obs(new_state), new_state, reward, done, {}

    def get_obs(self, state, params=None) -> torch.Tensor:
        return acrobot.get_obs(state)

    def observation_space(self, params) -> spaces.Box:
        return acrobot.observation_space(params)

    def action_space(self, params=None) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (1,), np.float32)
