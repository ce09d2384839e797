"""MemoryChain (bsuite-style), batched over E envs: a pure-memory task for
recurrent agents.

Port of purejaxql_tpu/envs/classic/memory_chain.py. At t = 0 each env shows a
random context bit; afterwards the observation carries no context. On the
last step of the chain (t = memory_length - 1) it shows the query, and the
agent must act the remembered bit: reward +1 for a correct recall, -1
otherwise, 0 on every other step. Done when time >= memory_length.

Observations (E, 2 + num_bits) float32, as memory_chain.py:79-92 builds
them under jit: [time / memory_length, the query on the last step (else 0),
2 * context - 1 at t = 0 (else 0)].

A reset's randomness (the Bernoulli context bits and the query) comes in
``MemoryChainDraws`` (``draw_context``), so the tests can hand the JAX env's
draws to ``start_state``. The step draws nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment


@dataclass
class MemoryChainState:
    context: torch.Tensor  # (E, num_bits) int32, 0 or 1
    query: torch.Tensor  # (E,) int32 in [0, num_bits)
    total_perfect: torch.Tensor  # (E,) int32
    total_regret: torch.Tensor  # (E,) float32
    time: torch.Tensor  # (E,) int32


@dataclass(frozen=True)
class MemoryChainParams:
    memory_length: int = 5
    num_bits: int = 1
    max_steps_in_episode: int = 1000


@dataclass
class MemoryChainDraws:
    context: torch.Tensor  # (E, num_bits) int32
    query: torch.Tensor  # (E,) int32


def draw_context(
    generator: torch.Generator, num_envs: int, params: MemoryChainParams
) -> MemoryChainDraws:
    """Bernoulli(0.5) context bits and a uniform query (memory_chain.py:46-51)."""
    dev = generator.device
    bits = torch.rand((num_envs, params.num_bits), generator=generator, device=dev) < 0.5
    query = torch.randint(0, params.num_bits, (num_envs,), generator=generator, device=dev)
    return MemoryChainDraws(context=bits.to(torch.int32), query=query.to(torch.int32))


def start_state(draws: MemoryChainDraws) -> MemoryChainState:
    n, dev = draws.query.shape[0], draws.query.device
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    return MemoryChainState(
        context=draws.context.to(torch.int32),
        query=draws.query.to(torch.int32),
        total_perfect=zero,
        total_regret=torch.zeros(n, dtype=torch.float32, device=dev),
        time=zero.clone(),
    )


def _reciprocal(n: int) -> float:
    """1 / n rounded to float32: the JAX env's ``time / memory_length`` runs
    jitted, and XLA divides by the constant as a multiply by its float32
    reciprocal (9 / 10 gives 0.90000004 there, 0.9 in a true division)."""
    return float(np.float32(1.0 / n))


class MemoryChain(Environment):
    @property
    def default_params(self) -> MemoryChainParams:
        return MemoryChainParams()

    @property
    def name(self) -> str:
        return "MemoryChain-bsuite"

    def reset_env(self, generator, num_envs, params):
        state = start_state(draw_context(generator, num_envs, params))
        return self.get_obs(state, params), state

    def step_env(self, state, action, params, draws):
        at_final = state.time == params.memory_length - 1
        remembered = state.context.gather(1, state.query.long()[:, None]).squeeze(1)
        correct = action == remembered
        reward = torch.where(
            at_final, torch.where(correct, 1.0, -1.0), 0.0
        ).to(torch.float32)
        new_state = MemoryChainState(
            context=state.context,
            query=state.query,
            total_perfect=state.total_perfect + (at_final & correct).to(torch.int32),
            total_regret=state.total_regret + torch.where(at_final & ~correct, 2.0, 0.0),
            time=state.time + 1,
        )
        done = new_state.time >= params.memory_length
        return self.get_obs(new_state, params), new_state, reward, done, {}

    def get_obs(self, state: MemoryChainState, params: MemoryChainParams) -> torch.Tensor:
        last = state.time == params.memory_length - 1
        front = torch.stack(
            [
                state.time.to(torch.float32) * _reciprocal(params.memory_length),
                torch.where(last, state.query, 0).to(torch.float32),
            ],
            -1,
        )
        context = torch.where(
            (state.time == 0)[:, None], 2 * state.context - 1, 0
        ).to(torch.float32)
        return torch.cat([front, context], -1)

    def observation_space(self, params) -> spaces.Box:
        return spaces.Box(-1.0, params.num_bits, (2 + params.num_bits,))

    def action_space(self, params=None) -> spaces.Discrete:
        return spaces.Discrete(2)
