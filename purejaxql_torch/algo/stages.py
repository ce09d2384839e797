"""Staged PQN API: rollout / targets / learn / evaluate as separate stage
functions, and a host-loop trainer built from them (port of
purejaxql_tpu/algo/stages.py).

Each stage can be tested and stepped through on its own, and the host-loop
trainer checkpoints the full state mid-run (``train_stepwise``); the
production path is ``algo.pqn.make_train``. The stages are built from the
FF trainer's own pieces: ``algo/pqn.py:build_env``, ``make_q_network``,
``algo/exploration.py:make_eps_greedy`` (the epsilon-greedy kernel where
EXPLORATION_KERNEL is "pallas", as the cuda policy sets it for
TRAINER=stepwise), ``ops.lambda_returns.lambda_returns`` (the returns
kernel on the GPU) and ``algo/pqn.py:learn_minibatch``.

Where the JAX stages take keys, these take generators: a host generator for
the initial weights and the kernel seeds, and one on the run's device for
resets, exploration and permutations. The port runs eagerly, so ``jit`` is
accepted and changes nothing. The stages mutate in place where the JAX ones
return new values: ``learn`` steps the train state it is given and returns
it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from purejaxql_torch.algo.exploration import draw_seed, eps_greedy_batch, make_eps_greedy
from purejaxql_torch.algo.metrics import episode_mean_metrics
from purejaxql_torch.algo.pqn import build_env, learn_minibatch
from purejaxql_torch.algo.types import Transition
from purejaxql_torch.core.config import derive_pqn_schedule_keys
from purejaxql_torch.core.optim import make_optimizer
from purejaxql_torch.core.schedules import epsilon_schedule, lr_schedule
from purejaxql_torch.core.train_state import PQNTrainState
from purejaxql_torch.models.factory import make_q_network
from purejaxql_torch.ops.lambda_returns import lambda_returns
from purejaxql_torch.utils.platform import resolve_device


@dataclass
class PQNStages:
    """The stage functions of one config."""

    init_agent: Callable  # (host_gen) -> train_state
    reset: Callable  # (gen) -> (obs, env_state)
    rollout: Callable  # (train_state, obs, env_state, gen, host_gen) -> (obs', env_state', transitions, infos)
    compute_targets: Callable  # (train_state, transitions) -> targets
    learn: Callable  # (train_state, transitions, targets, gen) -> (train_state, loss, qvals)
    evaluate: Callable  # (train_state, gen) -> metrics dict
    config: Dict[str, Any]
    device: torch.device


def make_stages(config: Dict[str, Any], jit: bool = True) -> PQNStages:
    """The stages of an FF config (stages.py:48-226), on the config's
    DEVICE, else ``cuda``; ``jit`` is ignored. As in the JAX stages, the
    rollout is the unfused one whatever FUSED_ROLLOUT says, and the targets
    are always the lambda returns."""
    config = derive_pqn_schedule_keys(dict(config))
    device = resolve_device(config.get("DEVICE"))
    config.setdefault("TEST_NUM_ENVS", config["NUM_ENVS"])
    train_env, test_env, env, env_params = build_env(config)
    config.setdefault("TEST_NUM_STEPS", env_params.max_steps_in_episode)

    n_envs, n_steps = config["NUM_ENVS"], config["NUM_STEPS"]
    n_minibatches, n_epochs = config["NUM_MINIBATCHES"], config["NUM_EPOCHS"]
    action_dim = env.action_space(env_params).n
    obs_shape = env.observation_space(env_params).shape
    eps_scheduler = epsilon_schedule(
        config["EPS_START"], config["EPS_FINISH"], config["EPS_DECAY"] * config["NUM_UPDATES_DECAY"]
    )
    rew_scale = config.get("REW_SCALE", 1.0)

    def init_agent(host_gen: torch.Generator) -> PQNTrainState:
        network = make_q_network(config, action_dim, obs_shape, generator=host_gen).to(device)
        optimizer = make_optimizer(network.parameters(), config["MAX_GRAD_NORM"], lr_schedule(config))
        return PQNTrainState(network, optimizer)

    def reset(gen: torch.Generator):
        return train_env.reset(gen, n_envs, env_params)

    @torch.no_grad()
    def rollout(train_state, obs, env_state, gen: torch.Generator, host_gen: torch.Generator):
        explore = make_eps_greedy(config, gen, host_gen)
        eps = eps_scheduler(train_state.n_updates)
        steps, infos = [], []
        for _ in range(n_steps):
            q_vals = train_state.network(obs, train=False)
            action = explore(q_vals, eps)
            new_obs, env_state, reward, done, info = train_env.step(gen, env_state, action, env_params)
            steps.append((obs, action, rew_scale * reward, done, new_obs, q_vals))
            infos.append(info)
            obs = new_obs
        transitions = Transition(*(torch.stack(f) for f in zip(*steps)))
        return obs, env_state, transitions, {k: torch.stack([i[k] for i in infos]) for k in infos[0]}

    @torch.no_grad()
    def compute_targets(train_state, transitions: Transition) -> torch.Tensor:
        last_q = train_state.network(transitions.next_obs[-1], train=False).max(-1).values
        return lambda_returns(
            last_q, transitions.reward, transitions.done.float(), transitions.q_val.max(-1).values,
            config["GAMMA"], config["LAMBDA"],
        )

    def learn(train_state, transitions: Transition, targets: torch.Tensor, gen: torch.Generator):
        n = n_steps * n_envs
        leaves = [x.reshape(n, *x.shape[2:]) for x in (transitions.obs, transitions.action, targets)]
        losses, qvals = [], []
        for _ in range(n_epochs):
            # one permutation an epoch, shared by the transitions and the targets
            perm = torch.randperm(n, generator=gen, device=device)
            batches = [x[perm].reshape(n_minibatches, -1, *x.shape[1:]) for x in leaves]
            for obs, action, target in zip(*batches):
                loss, chosen = learn_minibatch(train_state.network, train_state.optimizer, obs, action, target)
                train_state.grad_steps += 1
                losses.append(loss)
                qvals.append(chosen)
        train_state.timesteps += n
        train_state.n_updates += 1
        return train_state, torch.stack(losses).mean(), torch.stack(qvals).mean()

    @torch.no_grad()
    def evaluate(train_state, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        obs, state = test_env.reset(gen, config["TEST_NUM_ENVS"], env_params)
        infos = []
        for _ in range(config["TEST_NUM_STEPS"]):
            action = eps_greedy_batch(gen, train_state.network(obs, train=False), config.get("EPS_TEST", 0.0))
            obs, state, _, _, info = test_env.step(gen, state, action, env_params)
            infos.append(info)
        return episode_mean_metrics({k: torch.stack([i[k] for i in infos]) for k in infos[0]})

    return PQNStages(init_agent, reset, rollout, compute_targets, learn, evaluate, config, device)


def train_stepwise(
    config: Dict[str, Any],
    seed: Optional[int] = None,
    jit: bool = True,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    on_update: Optional[Callable[[int, Dict[str, float]], None]] = None,
):
    """Host-loop trainer over the stages (stages.py:229-282): NUM_UPDATES
    updates from a fresh agent, the full state saved to ``checkpoint_path``
    every ``checkpoint_every`` updates. Returns (train_state, history), a
    metrics dict an update."""
    from purejaxql_torch.core.checkpoint import save_state
    from purejaxql_torch.parallel.mesh import is_main_process

    stages = make_stages(config, jit=jit)
    config = stages.config
    host_gen = torch.Generator().manual_seed(config.get("SEED", 0) if seed is None else seed)
    train_state = stages.init_agent(host_gen)
    gen = torch.Generator(device=stages.device).manual_seed(draw_seed(host_gen))
    obs, env_state = stages.reset(gen)

    history = []
    for update in range(config["NUM_UPDATES"]):
        obs, env_state, transitions, infos = stages.rollout(train_state, obs, env_state, gen, host_gen)
        targets = stages.compute_targets(train_state, transitions)
        train_state, loss, qvals = stages.learn(train_state, transitions, targets, gen)
        metrics = {
            "update": update,
            "td_loss": float(loss),
            "qvals": float(qvals),
            "returned_episode_returns": float(infos["returned_episode_returns"].float().mean()),
        }
        history.append(metrics)
        if on_update is not None:
            on_update(update, metrics)
        if checkpoint_every and checkpoint_path and (update + 1) % checkpoint_every == 0 and is_main_process():
            # one writer in a process group (stages.py:276-281)
            save_state(train_state, checkpoint_path)
    return train_state, history
