"""FF-PQN trainer for feedforward Q-networks.

Port of purejaxql_tpu/algo/pqn.py `make_train` for the MLP QNetwork
(CartPole-v1) and the MinAtar CNN (Asterix-, Breakout-, Freeway-, Seaquest-
and SpaceInvaders-MinAtar). Each update: a
NUM_STEPS rollout over NUM_ENVS envs (epsilon-greedy on the current params),
Q(lambda) targets, NUM_EPOCHS epochs of NUM_MINIBATCHES minibatch steps of
clip + RAdam on the 0.5 * MSE TD loss, the update metrics, and every
TEST_INTERVAL of the run a greedy eval.

Where the JAX package scans, this trainer loops in Python; it keeps host
syncs out of the update loop: counters and schedules are host integers and
floats, metrics stay device tensors and are stacked once at the end. The
only sync is the fused eval's early-exit test, once per chunk.

Two rollout paths:

- unfused (pqn.py:321-340): network forward, `eps_greedy_batch` and the
  Log-wrapped env step, one env step at a time;
- FUSED_ROLLOUT (pqn.py:342-406): the whole rollout in one launch of the
  game's kernel (`fused_game_rollout`: ops/cartpole_rollout.py and the
  MinAtar games' ops/<game>_rollout.py), with the Log wrapper's episode
  statistics replayed from the (reward, done) streams afterwards, summed in
  step order as the JAX trainer sums them (Seaquest's rewards are not
  integers).

The lambda targets always go through `ops.lambda_returns.lambda_returns`,
the CUDA kernel on the GPU; PALLAS_RETURNS is accepted and changes nothing.

Line references ``pqn.py:N`` in this module are to purejaxql_tpu/algo/pqn.py.

Randomness comes from two generators seeded from SEED: a host generator
(parameter init, kernel seeds) and one on the run's device (env resets,
exploration, minibatch permutations). Parameters are initialised on the
host, so a CPU and a GPU run start from the same weights.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from purejaxql_torch.algo.exploration import eps_greedy_batch
from purejaxql_torch.algo.metrics import (
    apply_eval_subsample,
    episode_mean_metrics,
    eval_episode_metrics,
    running_episode_sums,
    test_interval_updates,
)
from purejaxql_torch.algo.types import Transition
from purejaxql_torch.core.config import FUSED_GAMES, derive_pqn_schedule_keys
from purejaxql_torch.core.optim import ClipRAdam, make_optimizer
from purejaxql_torch.core.schedules import epsilon_schedule, lr_schedule
from purejaxql_torch.core.train_state import PQNTrainState
from purejaxql_torch.envs import make as make_env
from purejaxql_torch.envs import wrappers
from purejaxql_torch.models.factory import make_q_network
from purejaxql_torch.ops.asterix_rollout import (
    asterix_from_state_matrix,
    asterix_rollout,
    state_matrix_from_asterix,
)
from purejaxql_torch.ops.breakout_rollout import (
    breakout_from_state_matrix,
    breakout_rollout,
    state_matrix_from_breakout,
)
from purejaxql_torch.ops.cartpole_rollout import (
    cartpole_from_state_matrix,
    cartpole_rollout,
    cartpole_weights,
    state_matrix_from_cartpole,
)
from purejaxql_torch.ops.freeway_rollout import (
    freeway_from_state_matrix,
    freeway_rollout,
    state_matrix_from_freeway,
)
from purejaxql_torch.ops.lambda_returns import lambda_returns
from purejaxql_torch.ops.minatar_rollout import minatar_weights
from purejaxql_torch.ops.seaquest_rollout import (
    seaquest_from_state_matrix,
    seaquest_rollout,
    state_matrix_from_seaquest,
)
from purejaxql_torch.ops.space_invaders_rollout import (
    space_invaders_from_state_matrix,
    space_invaders_rollout,
    state_matrix_from_space_invaders,
)
from purejaxql_torch.utils.platform import resolve_device

# options of the JAX trainer that later slices port; asking for one raises
_NOT_PORTED = {
    "BATCH_ENV": "BATCH_ENV",
    "USE_OPTIMISTIC_RESETS": "optimistic resets",
    "FAST_TARGETS": "FAST_TARGETS",
    "DONE_MASKED_INFO_METRICS": "DONE_MASKED_INFO_METRICS",
    "LOG_VIA_CALLBACK": "LOG_VIA_CALLBACK",
}


# games whose kernel, as its TPU kernel, keeps its env params built in but
# max_steps: the CartPole physics, Asterix's cadences and `ramping`,
# SpaceInvaders' cooldowns and reset march interval, Seaquest's six
# (pallas_rollout.py:469-472, 860, 1473-1474, 2031-2037); the Breakout and
# Freeway kernels take all of their env's params
_BUILT_IN_PARAMS = ("CartPole-v1", "Asterix-MinAtar", "SpaceInvaders-MinAtar", "Seaquest-MinAtar")


def fused_ff_eligible(config: Dict[str, Any]) -> bool:
    """The configs the FF trainer's fused rollout runs, which the cuda
    policy (core/config.py) fuses and ``_check_supported`` accepts: a game
    with a rollout kernel, layer_norm and NORM_INPUT=False, CartPole with a
    2-layer MLP, and for a game whose kernel keeps its env params built in,
    no ENV_KWARGS but max_steps_in_episode, which every kernel takes."""
    env_name = config.get("ENV_NAME")
    return (
        env_name in FUSED_GAMES
        and config.get("NORM_TYPE") == "layer_norm"
        and not config.get("NORM_INPUT", False)
        and (env_name != "CartPole-v1" or config.get("NUM_LAYERS", 2) == 2)
        and (env_name not in _BUILT_IN_PARAMS
             or set(config.get("ENV_KWARGS") or {}) <= {"max_steps_in_episode"})
    )


def _check_supported(config: Dict[str, Any]) -> None:
    if str(config.get("ALG_NAME", "pqn")) != "pqn":
        raise NotImplementedError(f"ALG_NAME '{config.get('ALG_NAME')}' is not ported yet")
    if config.get("NUM_SEEDS", 1) != 1:
        raise NotImplementedError("NUM_SEEDS > 1 is not ported yet: run one seed")
    if not config.get("Q_LAMBDA", True):
        raise NotImplementedError("Q_LAMBDA=False (1-step TD) is not ported yet")
    for key, what in _NOT_PORTED.items():
        if config.get(key, False):
            raise NotImplementedError(f"{what} is not ported yet")
    if config.get("FUSED_ROLLOUT", False) and not fused_ff_eligible(config):
        raise ValueError(
            "FUSED_ROLLOUT supports CartPole-v1 with a 2-layer MLP and the MinAtar "
            "games Asterix, Breakout, Freeway, Seaquest and SpaceInvaders with the MinAtar "
            "CNN, all with layer_norm and NORM_INPUT=False; for CartPole, Asterix, "
            "Seaquest and SpaceInvaders no ENV_KWARGS but max_steps_in_episode (their "
            "kernels keep the other env params built in): ops/cartpole_rollout.py, "
            "ops/<game>_rollout.py"
        )


def build_env(config: Dict[str, Any]):
    """The env of the config, its params and its Log-wrapped form
    (pqn.py:50-107, "split" mode, the only one ported): ``(log_env, env,
    env_params)``. Shared with the recurrent trainer."""
    env, env_params = make_env(config["ENV_NAME"], **(config.get("ENV_KWARGS") or {}))
    return wrappers.Log(env), env, env_params


def stack_metrics(history):
    """The per-update metric dicts as one tensor per metric, (NUM_UPDATES,):
    device tensors stack on the device, host counters on the host."""
    stacked = {}
    for k in history[0] if history else {}:
        values = [m[k] for m in history]
        stacked[k] = torch.stack(values) if torch.is_tensor(values[0]) else torch.tensor(values)
    return stacked


def _draw_seed(generator: torch.Generator) -> int:
    """A kernel seed from the host generator (no device sync)."""
    return int(torch.randint(0, 2**62, (1,), generator=generator))


def fused_weights(env_name: str, network: torch.nn.Module):
    """The weight tensors the game's rollout kernel takes."""
    if env_name == "CartPole-v1":
        return cartpole_weights(network)
    return minatar_weights(network)


def fused_game_rollout(env_name, seed, eps, weights, env_state, num_steps, env_params):
    """A whole ``num_steps`` rollout of the game (network forward,
    epsilon-greedy, env dynamics and auto-reset) in one launch of its kernel
    (pqn.py:126-171), with the env params the kernel takes. Returns the
    (obs, action, reward, done, q) streams, the final obs and the final env
    state. Shared by the training rollout and the chunked eval."""
    max_steps = env_params.max_steps_in_episode
    if env_name == "CartPole-v1":
        stf, sti = state_matrix_from_cartpole(env_state)
        *streams, stf, sti = cartpole_rollout(
            seed, eps, weights, stf, sti, num_steps, max_steps=max_steps
        )
        return (*streams, cartpole_from_state_matrix(stf, sti))
    if env_name == "Asterix-MinAtar":
        *streams, st = asterix_rollout(
            seed, eps, weights, state_matrix_from_asterix(env_state), num_steps,
            max_steps=max_steps,
        )
        return (*streams, asterix_from_state_matrix(st))
    if env_name == "Freeway-MinAtar":
        *streams, st = freeway_rollout(
            seed, eps, weights, state_matrix_from_freeway(env_state), num_steps,
            max_steps=max_steps, player_speed=env_params.player_speed,
        )
        return (*streams, freeway_from_state_matrix(st))
    if env_name == "Seaquest-MinAtar":
        *streams, st = seaquest_rollout(
            seed, eps, weights, state_matrix_from_seaquest(env_state), num_steps,
            max_steps=max_steps,
        )
        return (*streams, seaquest_from_state_matrix(st))
    if env_name == "SpaceInvaders-MinAtar":
        *streams, st, alien, fmap, emap = space_invaders_rollout(
            seed, eps, weights, *state_matrix_from_space_invaders(env_state), num_steps,
            max_steps=max_steps,
        )
        return (*streams, space_invaders_from_state_matrix(st, alien, fmap, emap))
    st, brick = state_matrix_from_breakout(env_state)
    *streams, st, brick = breakout_rollout(
        seed, eps, weights, st, brick, num_steps, max_steps=max_steps
    )
    return (*streams, breakout_from_state_matrix(st, brick))


def log_replay(log_state: wrappers.LogEnvState, rew: torch.Tensor, done: torch.Tensor):
    """The Log wrapper's infos and end state over a (T, E) stream of rewards
    and done flags from the fused rollout (pqn.py:371-405): the running
    sums in step order, as the JAX replay's scan adds them (exact for the
    float rewards of Seaquest's cash-ins), the returned values of the last
    episode to end held between ends."""
    ner, nel, ep_r, ep_l = running_episode_sums(
        rew, done.float(), log_state.episode_returns, log_state.episode_lengths
    )
    T = rew.shape[0]
    steps = torch.arange(T, device=rew.device)[:, None].expand_as(rew)
    last_done = torch.where(done, steps, -1).cummax(0).values
    ended = last_done >= 0
    idx = last_done.clamp(min=0)
    ret_r = torch.where(ended, ner.gather(0, idx), log_state.returned_episode_returns)
    ret_l = torch.where(ended, nel.gather(0, idx), log_state.returned_episode_lengths)
    timestep = log_state.timestep + 1 + steps.to(torch.int32)
    infos = {
        "returned_episode_returns": ret_r,
        "returned_episode_lengths": ret_l,
        "timestep": timestep,
        "returned_episode": done,
    }
    new_state = wrappers.LogEnvState(
        env_state=log_state.env_state,
        episode_returns=ep_r,
        episode_lengths=ep_l,
        returned_episode_returns=ret_r[-1],
        returned_episode_lengths=ret_l[-1],
        timestep=timestep[-1],
    )
    return new_state, infos


def learn_minibatch(
    network: torch.nn.Module,
    optimizer: ClipRAdam,
    obs: torch.Tensor,
    action: torch.Tensor,
    target: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One minibatch step (pqn.py:492-553): a train-mode forward (the batch
    norms update their running statistics, even the unused input norm), the
    0.5 * MSE TD loss on the taken actions, and clip + RAdam on every
    parameter (zero gradients for the unused ones, as jax.grad gives).
    Returns the loss and the chosen Q-values, detached."""
    q_vals = network(obs, train=True)
    chosen = q_vals.gather(1, action[:, None]).squeeze(1)
    loss = 0.5 * torch.square(chosen - target).mean()
    grads = torch.autograd.grad(
        loss, optimizer.params, allow_unused=True, materialize_grads=True
    )
    optimizer.step(grads)
    return loss.detach(), chosen.detach()


def make_train(
    config: Dict[str, Any], device: Optional[str] = None
) -> Callable[..., Dict[str, Any]]:
    """Build ``train(seed=None) -> {"runner_state", "metrics"}``.

    ``device`` defaults to the config's DEVICE key, else ``cuda``; a missing
    GPU raises. ``metrics`` maps each metric name to a tensor of shape
    (NUM_UPDATES,); ``runner_state`` is (train_state, (obs, env_state),
    test_metrics).
    """
    config = derive_pqn_schedule_keys(apply_eval_subsample(dict(config)))
    _check_supported(config)
    device = resolve_device(device if device is not None else config.get("DEVICE"))

    log_env, env, env_params = build_env(config)
    config.setdefault("TEST_NUM_STEPS", env_params.max_steps_in_episode)
    action_dim = env.action_space(env_params).n
    obs_shape = env.observation_space(env_params).shape

    n_envs, n_steps = config["NUM_ENVS"], config["NUM_STEPS"]
    n_minibatches, n_epochs = config["NUM_MINIBATCHES"], config["NUM_EPOCHS"]
    rew_scale = config.get("REW_SCALE", 1.0)
    timestep_scale = config.get("TIMESTEP_SCALE", 1)
    use_fused = config.get("FUSED_ROLLOUT", False)
    test_during_training = config.get("TEST_DURING_TRAINING", False)
    eps_scheduler = epsilon_schedule(
        config["EPS_START"],
        config["EPS_FINISH"],
        config["EPS_DECAY"] * config["NUM_UPDATES_DECAY"],
    )

    def train(seed: Optional[int] = None) -> Dict[str, Any]:
        host_gen = torch.Generator().manual_seed(config["SEED"] if seed is None else seed)
        network = make_q_network(config, action_dim, obs_shape, generator=host_gen)
        network = network.to(device)
        dev_gen = torch.Generator(device=device).manual_seed(_draw_seed(host_gen))
        optimizer = make_optimizer(
            network.parameters(), config["MAX_GRAD_NORM"], lr_schedule(config)
        )
        train_state = PQNTrainState(network, optimizer)
        env_name = config["ENV_NAME"]

        def rollout(obs, log_state):
            eps = eps_scheduler(train_state.n_updates)
            if use_fused:
                obs_seq, act, rew, done_i, q_seq, final_obs, env_state = fused_game_rollout(
                    env_name, _draw_seed(host_gen), eps, fused_weights(env_name, network),
                    log_state.env_state, n_steps, env_params,
                )
                done = done_i.bool()
                transitions = Transition(
                    obs=obs_seq,
                    action=act.long(),
                    reward=rew_scale * rew,
                    done=done,
                    next_obs=torch.cat([obs_seq[1:], final_obs[None]]),
                    q_val=q_seq,
                )
                log_state, infos = log_replay(log_state, rew, done)
                log_state.env_state = env_state
                return final_obs, log_state, transitions, infos

            steps = []
            with torch.no_grad():
                for _ in range(n_steps):
                    q_vals = network(obs, train=False)
                    action = eps_greedy_batch(dev_gen, q_vals, eps)
                    new_obs, log_state, reward, done, info = log_env.step(
                        dev_gen, log_state, action, env_params
                    )
                    steps.append((obs, action, rew_scale * reward, done, new_obs, q_vals, info))
                    obs = new_obs
            fields = list(zip(*steps))
            transitions = Transition(*(torch.stack(f) for f in fields[:6]))
            infos = {k: torch.stack([i[k] for i in fields[6]]) for k in fields[6][0]}
            return obs, log_state, transitions, infos

        def learn(transitions, targets):
            n = n_steps * n_envs
            obs = transitions.obs.reshape(n, *obs_shape)
            action = transitions.action.reshape(n)
            targets = targets.reshape(n)
            losses, qvals = [], []
            for _ in range(n_epochs):
                # one permutation per epoch, shared by every leaf and the targets
                perm = torch.randperm(n, generator=dev_gen, device=device)
                batches = zip(
                    obs[perm].reshape(n_minibatches, -1, *obs_shape),
                    action[perm].reshape(n_minibatches, -1),
                    targets[perm].reshape(n_minibatches, -1),
                )
                for mb_obs, mb_action, mb_target in batches:
                    loss, chosen = learn_minibatch(
                        network, optimizer, mb_obs, mb_action, mb_target
                    )
                    train_state.grad_steps += 1
                    losses.append(loss)
                    qvals.append(chosen)
            return torch.stack(losses).mean(), torch.stack(qvals).mean()

        @torch.no_grad()
        def get_test_metrics() -> Dict[str, torch.Tensor]:
            n_test = config["TEST_NUM_ENVS"]
            n_test_steps = config["TEST_NUM_STEPS"]
            _, test_state = log_env.reset(dev_gen, n_test, env_params)
            if use_fused:
                # the greedy rollout through the same kernel in NUM_STEPS
                # chunks; with EVAL_EARLY_EXIT it stops once every env has
                # finished an episode, and unexecuted steps count as not done
                chunk = n_steps
                n_chunks = -(-n_test_steps // chunk)
                seed0 = _draw_seed(host_gen)
                weights = fused_weights(env_name, network)
                env_state = test_state.env_state
                rews = torch.zeros(n_chunks, chunk, n_test, device=device)
                dones = torch.zeros(n_chunks, chunk, n_test, dtype=torch.bool, device=device)
                done_once = torch.zeros(n_test, dtype=torch.bool, device=device)
                for i in range(n_chunks):
                    _, _, rew, done_i, _, _, env_state = fused_game_rollout(
                        env_name, seed0 + i * chunk, config["EPS_TEST"], weights,
                        env_state, chunk, env_params,
                    )
                    rews[i], dones[i] = rew, done_i.bool()
                    if config.get("EVAL_EARLY_EXIT", False):
                        done_once |= dones[i].any(0)
                        if bool(done_once.all()):  # one host sync per chunk
                            break
                rews = rews.reshape(-1, n_test)[:n_test_steps]
                dones = dones.reshape(-1, n_test)[:n_test_steps]
                return eval_episode_metrics(rews, dones.float())

            obs, state = log_env.reset(dev_gen, n_test, env_params)
            infos = []
            for _ in range(n_test_steps):
                q_vals = network(obs, train=False)
                action = eps_greedy_batch(dev_gen, q_vals, config["EPS_TEST"])
                obs, state, _, _, info = log_env.step(dev_gen, state, action, env_params)
                infos.append(info)
            return episode_mean_metrics(
                {k: torch.stack([i[k] for i in infos]) for k in infos[0]}
            )

        test_metrics = get_test_metrics() if test_during_training else {}
        obs, log_state = log_env.reset(dev_gen, n_envs, env_params)
        history = []
        for _ in range(config["NUM_UPDATES"]):
            obs, log_state, transitions, infos = rollout(obs, log_state)
            train_state.timesteps += n_steps * n_envs * timestep_scale

            with torch.no_grad():
                last_q = network(transitions.next_obs[-1], train=False).max(-1).values
                targets = lambda_returns(
                    last_q,
                    transitions.reward,
                    transitions.done.float(),
                    transitions.q_val.max(-1).values,
                    config["GAMMA"],
                    config["LAMBDA"],
                )
            td_loss, qvals = learn(transitions, targets)
            train_state.n_updates += 1

            metrics = {
                "env_step": train_state.timesteps,
                "update_steps": train_state.n_updates,
                "grad_steps": train_state.grad_steps,
                "td_loss": td_loss,
                "qvals": qvals,
            }
            metrics.update({k: v.float().mean() for k, v in infos.items()})
            if test_during_training:
                if train_state.n_updates % test_interval_updates(config) == 0:
                    test_metrics = get_test_metrics()
                metrics.update({f"test/{k}": v for k, v in test_metrics.items()})
            history.append(metrics)

        return {
            "runner_state": (train_state, (obs, log_state), test_metrics),
            "metrics": stack_metrics(history),
        }

    return train
