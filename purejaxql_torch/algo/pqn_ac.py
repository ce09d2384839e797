"""AC-PQN: the actor-critic PQN trainer for continuous control.

Port of purejaxql_tpu/algo/pqn_ac.py `make_train` for Pendulum-v1
(``+alg=pqn_pendulum``). Line references ``pqn_ac.py:N`` are to that module.

- A deterministic tanh actor explored with the per-env Gaussian noise ladder
  (algo/exploration.py), and an ensemble of NUM_CRITICS Q-critics with
  member-stacked parameters applied in one pass (models/actor_critic.py).
- Each update: a NUM_STEPS rollout over NUM_ENVS envs recording the greedy
  and the explored action and the ensemble-mean value of the explored one;
  the next actions filled in from the rollout and one more policy step; the
  Q(lambda) targets over the recorded values, which stand in for max-Q
  (:404-414), through ``ops.lambda_returns`` (the CUDA kernel on the GPU);
  NUM_EPOCHS epochs, each with one permutation shared by every field and the
  targets, of NUM_MINIBATCHES minibatch steps.
- A minibatch step updates the critic on the Huber loss summed over its
  members and the actor on -meanQ plus a thresholded smooth-L1 penalty
  toward the behavior action, each with its own clip + RAdam. The actor's
  loss reads the critic as it was before this minibatch's critic step
  (:477-479, the state is replaced at :537): ``learn_minibatch`` runs
  ``actor_step`` first and ``critic_step`` after it, which gives the same
  result since neither step reads what the other writes. USE_QLAMBDA=False takes 1-step TD targets per
  minibatch from the ensemble at (next_obs, next_action) (:441-459).
- Two rollout paths: unfused (:258-285), the actor, the ladder, the critics
  and the wrapped env one step at a time; FUSED_ROLLOUT (:287-384), the whole
  rollout in one launch of the Pendulum kernel (ops/pendulum_rollout.py),
  with LogVec's infos replayed from its (reward, done) streams in step order.
  The greedy eval follows the same switch (:613-748).

Env stack (:85-101): Pendulum -> ScrubNaN -> LogVec -> ClipAction; the
normalization wrappers are not ported yet and raise.

As in the other trainers, counters and schedules are host numbers and
metrics stay device tensors until the end, so the update loop makes no host
sync. Parameters are initialised from a host generator seeded with SEED, so
a CPU and a GPU run start from the same weights.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Any, Callable, Dict, Optional

import torch

from purejaxql_torch.algo.exploration import gaussian_noise_ladder
from purejaxql_torch.algo.metrics import (
    apply_eval_subsample,
    eval_episode_metrics,
    running_episode_sums,
    test_interval_updates,
)
from purejaxql_torch.algo.pqn import _draw_seed, stack_metrics
from purejaxql_torch.core.optim import ClipRAdam, make_optimizer
from purejaxql_torch.core.schedules import linear_schedule
from purejaxql_torch.core.train_state import PQNTrainState
from purejaxql_torch.envs import make as make_env
from purejaxql_torch.envs import wrappers
from purejaxql_torch.models.actor_critic import Actor, CriticEnsemble
from purejaxql_torch.ops.lambda_returns import lambda_returns
from purejaxql_torch.ops.pendulum_rollout import (
    pendulum_ac_rollout,
    pendulum_ac_weights,
    pendulum_from_state_matrix,
    state_matrix_from_pendulum,
)
from purejaxql_torch.utils.platform import resolve_device

# continuous envs of the JAX package this port has so far
_PORTED_ENVS = ("Pendulum-v1",)


@dataclass
class ACTransition:
    """An actor-critic rollout, each field stacked over time (T, E, ...)."""

    done: torch.Tensor  # float 0/1
    original_action: torch.Tensor  # the greedy action
    action: torch.Tensor  # the explored action
    next_action: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    obs: torch.Tensor
    next_obs: torch.Tensor


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber-style loss of pqn_ac.py:56-59."""
    diff = pred - target
    abs_diff = diff.abs()
    return torch.where(abs_diff < beta, 0.5 * diff**2 / beta, abs_diff - 0.5 * beta)


def fused_ac_eligible(config: Dict[str, Any]) -> bool:
    """The shapes the fused Pendulum kernel runs (pqn_ac.py:143-158), and
    env params the kernel keeps built in left at their defaults: only
    max_steps_in_episode may be set in ENV_KWARGS."""
    return (
        config.get("ENV_NAME") == "Pendulum-v1"
        and config.get("NORM_TYPE") == "layer_norm"
        and not config.get("NORM_INPUT", False)
        and not config.get("NORMALIZE_OBS", False)
        and not config.get("NORMALIZE_REWARD", False)
        and len(config.get("ACTOR_HIDDEN_SIZES") or ()) == 2
        and len(config.get("CRITIC_HIDDEN_SIZES") or ()) == 2
        and config.get("NUM_CRITICS", 2) == 2
        and config.get("ACTIVATION", "relu") == "relu"
        and set(config.get("ENV_KWARGS") or {}) <= {"max_steps_in_episode"}
    )


def _check_supported(config: Dict[str, Any]) -> None:
    if str(config.get("ALG_NAME", "")) not in ("pqn_ac", "pqn_playground"):
        raise NotImplementedError(f"ALG_NAME '{config.get('ALG_NAME')}' is not an actor-critic config")
    if config.get("NUM_SEEDS", 1) != 1:
        raise NotImplementedError("NUM_SEEDS > 1 is not ported yet: run one seed")
    if config.get("LOG_VIA_CALLBACK", False):
        raise NotImplementedError("LOG_VIA_CALLBACK is not ported yet")
    for key in ("NORMALIZE_OBS", "NORMALIZE_REWARD"):
        if config.get(key, False):
            raise NotImplementedError(f"{key} (the brax normalization wrappers) is not ported yet")
    if config["ENV_NAME"] not in _PORTED_ENVS:
        raise NotImplementedError(
            f"env '{config['ENV_NAME']}' is not ported yet for the actor-critic family "
            f"(ported: {', '.join(_PORTED_ENVS)})"
        )
    if config.get("FUSED_ROLLOUT", False) and not fused_ac_eligible(config):
        raise ValueError(
            "FUSED_ROLLOUT (AC family) supports Pendulum-v1 with layer_norm, relu, 2 hidden "
            "layers, NUM_CRITICS=2, no obs/reward normalization, NORM_INPUT=False, and no "
            "ENV_KWARGS but max_steps_in_episode (the kernel keeps the physics built in): "
            "ops/pendulum_rollout.py"
        )
    if (config["NUM_ENVS"] * config["NUM_STEPS"]) % config["NUM_MINIBATCHES"]:
        raise ValueError("NUM_MINIBATCHES must divide NUM_STEPS*NUM_ENVS")


def build_ac_env(config: Dict[str, Any]):
    """The wrapped env (pqn_ac.py:85-101): ScrubNaN (unless SCRUB_NAN is
    False), LogVec, ClipAction to the action box. Returns (wrapped env, env,
    env params, action low, action high)."""
    env, env_params = make_env(config["ENV_NAME"], **(config.get("ENV_KWARGS") or {}))
    space = env.action_space(env_params)
    low, high = float(space.low), float(space.high)
    wrapped = wrappers.ScrubNaN(env) if config.get("SCRUB_NAN", True) else env
    wrapped = wrappers.ClipAction(wrappers.LogVec(wrapped), low=low, high=high)
    return wrapped, env, env_params, low, high


def fused_pendulum_rollout(seed, noise_std, weights, env_state, num_steps, max_steps, linspace_noise):
    """A whole ``num_steps`` AC rollout in one launch of the Pendulum kernel
    (pqn_ac.py:62-82): the (obs, u, greedy, value, reward, done) streams,
    the final obs and the final env state. Shared by the training rollout
    and the greedy eval."""
    stf, sti = state_matrix_from_pendulum(env_state)
    *streams, stf, sti = pendulum_ac_rollout(
        seed, noise_std, *weights, stf, sti, num_steps, max_steps=max_steps,
        linspace_noise=linspace_noise,
    )
    return (*streams, pendulum_from_state_matrix(stf, sti))


def log_vec_replay(state: wrappers.LogVecState, rew: torch.Tensor, done: torch.Tensor):
    """LogVec's infos and end state over a (T, E) stream of raw rewards and
    0/1 float done flags from the fused rollout (pqn_ac.py:323-381): the
    running sums in step order, the last *returned* values held between
    episode ends, the scalar step counter broadcast to (T, E)."""
    ner, nel, ep_r, ep_l = running_episode_sums(
        rew, done, state.episode_returns, state.episode_lengths
    )
    ended = done.bool()
    rr, rl = state.returned_episode_returns, state.returned_episode_lengths
    held_r, held_l = [], []
    for t in range(rew.shape[0]):
        rr = torch.where(ended[t], ner[t], rr)
        rl = torch.where(ended[t], nel[t], rl)
        held_r.append(rr)
        held_l.append(rl)
    T = rew.shape[0]
    steps = torch.arange(1, T + 1, dtype=torch.int32, device=rew.device)
    infos = {
        "returned_episode_returns": torch.stack(held_r),
        "returned_episode_lengths": torch.stack(held_l),
        "returned_episode": ended,
        "timestep": (state.timestep + steps)[:, None].expand(rew.shape),
        "original_reward": rew,
    }
    new_state = wrappers.LogVecState(
        env_state=state.env_state, episode_returns=ep_r, episode_lengths=ep_l,
        returned_episode_returns=rr, returned_episode_lengths=rl, timestep=state.timestep + T,
    )
    return new_state, infos


def actor_step(
    actor: Actor,
    critics: CriticEnsemble,
    optimizer: ClipRAdam,
    obs: torch.Tensor,
    behavior_action: torch.Tensor,
    action_scale: float,
    action_bias: float,
    threshold: float,
    penalty_coeff: float,
) -> torch.Tensor:
    """The actor's minibatch step (pqn_ac.py:467-503, 521-535): a train-mode
    actor pass (its batch norms' statistics move), the critic ensemble in
    eval mode at the new actions, -meanQ plus PENALTY_COEFF * smooth-L1 to
    the behavior (greedy) action where the normalized distance reaches
    THRESHOLD, and clip + RAdam on the actor's parameters alone. Returns the
    loss, detached."""
    action = actor(obs, train=True)
    q = critics(obs, action, train=False).mean(0)
    norm_diff = ((action - behavior_action - action_bias) / action_scale).abs().mean(-1)
    pen = smooth_l1_loss(action, behavior_action).mean(-1)
    penalty = torch.where(norm_diff < threshold, 0.0, penalty_coeff * pen)
    loss = (-q + penalty).mean()
    grads = torch.autograd.grad(loss, optimizer.params, allow_unused=True, materialize_grads=True)
    optimizer.step(grads)
    return loss.detach()


def critic_step(
    critics: CriticEnsemble,
    optimizer: ClipRAdam,
    minibatch: ACTransition,
    target: Optional[torch.Tensor],
    gamma: float,
) -> torch.Tensor:
    """The critic's minibatch step (pqn_ac.py:420-465, 505-519): a train-mode
    ensemble pass, the smooth-L1 loss of each member to the stop-gradient
    target, averaged over the minibatch and summed over the members, and
    clip + RAdam on the critics' parameters. With ``target`` None the 1-step
    TD target is r + (1 - d) gamma meanQ(next_obs, next_action), both halves
    in one double-batch pass. Returns the loss, detached."""
    mb = minibatch
    if target is not None:
        values = critics(mb.obs, mb.action, train=True)
    else:
        all_q = critics(
            torch.cat([mb.obs, mb.next_obs]), torch.cat([mb.action, mb.next_action]), train=True
        )
        values, next_values = all_q.chunk(2, dim=1)
        target = mb.reward + (1 - mb.done) * gamma * next_values.detach().mean(0)
    loss = smooth_l1_loss(values, target.detach()).mean(1).sum()
    grads = torch.autograd.grad(loss, optimizer.params, allow_unused=True, materialize_grads=True)
    optimizer.step(grads)
    return loss.detach()


def learn_minibatch(
    actor: Actor,
    critics: CriticEnsemble,
    actor_optimizer: ClipRAdam,
    critic_optimizer: ClipRAdam,
    minibatch: ACTransition,
    target: Optional[torch.Tensor],
    config: Dict[str, Any],
    action_scale: float,
    action_bias: float,
):
    """One minibatch step of both networks (pqn_ac.py:417-542). The actor
    steps first, so that its loss reads the critics as they were before this
    minibatch (as the JAX step, whose critic update lands only at :537); the
    critic step reads nothing the actor step writes. ``target`` None takes
    the 1-step TD path. Returns (critic loss, actor loss), detached."""
    actor_loss = actor_step(
        actor, critics, actor_optimizer, minibatch.obs, minibatch.original_action,
        action_scale, action_bias, config["THRESHOLD"], config["PENALTY_COEFF"],
    )
    critic_loss = critic_step(critics, critic_optimizer, minibatch, target, config["GAMMA"])
    return critic_loss, actor_loss


def make_train(
    config: Dict[str, Any], device: Optional[str] = None
) -> Callable[..., Dict[str, Any]]:
    """Build ``train(seed=None) -> {"runner_state", "metrics"}``.

    ``device`` defaults to the config's DEVICE key, else ``cuda``; a missing
    GPU raises. ``metrics`` maps each metric name to a tensor of shape
    (NUM_UPDATES,); ``runner_state`` is ({"actor": PQNTrainState, "critic":
    PQNTrainState}, (obs, env_state), test_metrics), the counters on the
    actor's state.
    """
    config = apply_eval_subsample(dict(config))
    config["TOTAL_TIMESTEPS"] = int(float(config["TOTAL_TIMESTEPS"]))
    n_envs, n_steps = config["NUM_ENVS"], config["NUM_STEPS"]
    n_minibatches, n_epochs = config["NUM_MINIBATCHES"], config["NUM_EPOCHS"]
    config["NUM_UPDATES"] = config["TOTAL_TIMESTEPS"] // n_steps // n_envs
    _check_supported(config)
    device = resolve_device(device if device is not None else config.get("DEVICE"))

    env, base_env, env_params, act_low, act_high = build_ac_env(config)
    obs_dim = base_env.observation_space(env_params).shape[0]
    action_dim = base_env.action_space(env_params).shape[0]
    config.setdefault("TEST_NUM_STEPS", env_params.max_steps_in_episode)
    if config.get("TEST_NUM_ENVS") is None:
        config["TEST_NUM_ENVS"] = n_envs

    lr = config["LR_START"]
    if config.get("ANNEAL_LR", False):
        lr = linear_schedule(
            config["LR_START"], config["LR_END"],
            config["NUM_UPDATES"] * config["LR_DECAY"] * n_minibatches * n_epochs,
        )
    noise_scheduler = linear_schedule(
        config["NOISE_START"], config["NOISE_FINISH"], config["NOISE_DECAY"] * config["NUM_UPDATES"]
    )
    use_fused = config.get("FUSED_ROLLOUT", False)
    use_qlambda = config.get("USE_QLAMBDA", True)
    gamma = config["GAMMA"]
    rew_scale = config.get("REW_SCALE", 1.0)
    timestep_scale = config.get("TIMESTEP_SCALE", 1)
    test_during_training = config.get("TEST_DURING_TRAINING", False)
    max_steps = env_params.max_steps_in_episode
    action_scale = (act_high - act_low) / 2.0
    action_bias = (act_high + act_low) / 2.0

    def train(seed: Optional[int] = None) -> Dict[str, Any]:
        host_gen = torch.Generator().manual_seed(config["SEED"] if seed is None else seed)
        actor = Actor(
            obs_dim, action_dim, action_scale, action_bias, config["ACTOR_HIDDEN_SIZES"],
            activation=config.get("ACTIVATION", "relu"), norm_type=config["NORM_TYPE"],
            init_scale=config.get("ACTOR_INIT_SCALE", 1.0), generator=host_gen,
        ).to(device)
        critics = CriticEnsemble(
            config.get("NUM_CRITICS", 2), obs_dim, action_dim, config["CRITIC_HIDDEN_SIZES"],
            norm_type=config["NORM_TYPE"], init_scale=config.get("CRITIC_INIT_SCALE", 1.0),
            generator=host_gen,
        ).to(device)
        dev_gen = torch.Generator(device=device).manual_seed(_draw_seed(host_gen))
        train_state = {
            "actor": PQNTrainState(actor, make_optimizer(actor.parameters(), config["MAX_GRAD_NORM"], lr)),
            "critic": PQNTrainState(
                critics, make_optimizer(critics.parameters(), config["MAX_GRAD_NORM"], lr)
            ),
        }
        actor_state, critic_state = train_state["actor"], train_state["critic"]

        @torch.no_grad()
        def policy_step(obs, noise_std, linspace):
            """Greedy action, its noise-ladder exploration and the
            ensemble-mean value of the explored action (pqn_ac.py:229-250)."""
            greedy = actor(obs, train=False)
            explored = gaussian_noise_ladder(
                dev_gen, greedy, noise_std, act_low, act_high, scale=action_scale, linspace=linspace
            )
            return greedy, explored, critics(obs, explored, train=False).mean(0)

        def rollout(obs, env_state):
            noise_std = noise_scheduler(actor_state.n_updates)
            if use_fused:
                obs_seq, u, greedy, value, rew, done, final_obs, raw_state = fused_pendulum_rollout(
                    _draw_seed(host_gen), noise_std, pendulum_ac_weights(actor, critics),
                    env_state.env_state, n_steps, max_steps, config.get("LINSPACE_NOISE", True),
                )
                transitions = ACTransition(
                    done=done, original_action=greedy, action=u, next_action=u, value=value,
                    reward=rew_scale * rew, obs=obs_seq,
                    next_obs=torch.cat([obs_seq[1:], final_obs[None]]),
                )
                env_state, infos = log_vec_replay(env_state, rew, done)
                env_state.env_state = raw_state
                return final_obs, env_state, transitions, infos

            steps, infos = [], []
            for _ in range(n_steps):
                greedy, action, value = policy_step(obs, noise_std, config.get("LINSPACE_NOISE", False))
                new_obs, env_state, reward, done, info = env.step(dev_gen, env_state, action, env_params)
                steps.append((done.float(), greedy, action, action, value, rew_scale * reward, obs, new_obs))
                infos.append(info)
                obs = new_obs
            transitions = ACTransition(*(torch.stack(f) for f in zip(*steps)))
            return obs, env_state, transitions, {k: torch.stack([i[k] for i in infos]) for k in infos[0]}

        def learn(transitions: ACTransition, targets: torch.Tensor):
            n = n_steps * n_envs
            flat = {
                f.name: (x := getattr(transitions, f.name)).reshape(n, *x.shape[2:])
                for f in fields(ACTransition)
            }
            targets = targets.reshape(n)
            critic_losses, actor_losses = [], []
            for _ in range(n_epochs):
                # one permutation per epoch, shared by every field and the targets
                perm = torch.randperm(n, generator=dev_gen, device=device)
                for idx in perm.reshape(n_minibatches, -1):
                    mb = ACTransition(**{k: v[idx] for k, v in flat.items()})
                    critic_loss, actor_loss = learn_minibatch(
                        actor, critics, actor_state.optimizer, critic_state.optimizer, mb,
                        targets[idx] if use_qlambda else None, config, action_scale, action_bias,
                    )
                    critic_losses.append(critic_loss)
                    actor_losses.append(actor_loss)
                    actor_state.grad_steps += 1
                    critic_state.grad_steps += 1
            return torch.stack(critic_losses).mean(), torch.stack(actor_losses).mean()

        @torch.no_grad()
        def get_test_metrics() -> Dict[str, torch.Tensor]:
            n_test, n_test_steps = config["TEST_NUM_ENVS"], config["TEST_NUM_STEPS"]
            if use_fused:
                # the greedy rollout through the same kernel at noise 0, in
                # NUM_STEPS chunks (pqn_ac.py:617-669)
                n_chunks = -(-n_test_steps // n_steps)
                _, test_state = env.reset(dev_gen, n_test, env_params)
                raw_state = test_state.env_state
                seed0 = _draw_seed(host_gen)
                weights = pendulum_ac_weights(actor, critics)
                rews, dones = [], []
                for i in range(n_chunks):
                    _, _, _, _, rew, done, _, raw_state = fused_pendulum_rollout(
                        seed0 + i * n_steps, 0.0, weights, raw_state, n_steps, max_steps,
                        config.get("LINSPACE_NOISE", True),
                    )
                    rews.append(rew)
                    dones.append(done)
                return eval_episode_metrics(torch.cat(rews)[:n_test_steps], torch.cat(dones)[:n_test_steps])

            # each env's first episode, latched (pqn_ac.py:678-748)
            obs, state = env.reset(dev_gen, n_test, env_params)
            ret = torch.zeros(n_test, device=device)
            length = torch.zeros(n_test, device=device)
            ended = torch.zeros(n_test, dtype=torch.bool, device=device)
            for _ in range(n_test_steps):
                obs, state, _, done, info = env.step(dev_gen, state, actor(obs, train=False), env_params)
                ret = torch.where(ended, ret, ret + info["original_reward"])
                length = torch.where(ended, length, length + 1)
                ended = ended | done
            n_done = ended.sum()
            return {
                "returned_episode_returns": ret.sum() / n_done,
                "returned_episode_lengths": length.sum() / n_done,
                "done_episodes": n_done / n_test,
            }

        test_metrics = get_test_metrics() if test_during_training else {}
        obs, env_state = env.reset(dev_gen, n_envs, env_params)
        history = []
        for _ in range(config["NUM_UPDATES"]):
            obs, env_state, transitions, infos = rollout(obs, env_state)
            noise_std = noise_scheduler(actor_state.n_updates)
            _, last_action, last_val = policy_step(obs, noise_std, config.get("LINSPACE_NOISE", False))
            transitions = replace(
                transitions, next_action=torch.cat([transitions.next_action[1:], last_action[None]])
            )
            # Q(lambda) over the ensemble-mean values, standing in for max-Q
            targets = lambda_returns(
                last_val, transitions.reward, transitions.done, transitions.value,
                gamma, config["LAMBDA"],
            )
            value_loss, actor_loss = learn(transitions, targets)
            actor_state.n_updates += 1
            actor_state.timesteps = actor_state.n_updates * n_envs * n_steps * timestep_scale

            metrics = {
                "env_step": actor_state.timesteps,
                "update_steps": actor_state.n_updates,
                "grad_steps_actor": actor_state.grad_steps,
                "grad_steps_critic": critic_state.grad_steps,
                "noise": noise_scheduler(actor_state.n_updates),
                "value_loss": value_loss,
                "loss_actor": actor_loss,
            }
            metrics.update({k: v.float().mean() for k, v in infos.items()})
            if test_during_training:
                if actor_state.n_updates % test_interval_updates(config) == 0:
                    test_metrics = get_test_metrics()
                metrics.update({f"test/{k}": v for k, v in test_metrics.items()})
            history.append(metrics)

        return {
            "runner_state": (train_state, (obs, env_state), test_metrics),
            "metrics": stack_metrics(history),
        }

    return train
