"""RNN-PQN: the trainer for recurrent Q-networks (GRU).

Port of purejaxql_tpu/algo/pqn_rnn.py `make_train` for GRU cells on a
layer_norm trunk (``+alg=pqn_rnn_memory_chain``, ``+alg=pqn_rnn_cartpole``).
Line references ``pqn_rnn.py:N`` are to that module.

- Before training, a random-policy prefill of MEMORY_WINDOW + NUM_STEPS
  steps fills the memory (:468-476).
- Each update: a NUM_STEPS rollout, one env step at a time, each step
  running the network on a length-1 time slice in eval mode and storing the
  *incoming* hidden state, done flag and action (:154-200); the memory drops
  its oldest NUM_STEPS steps and appends the rollout (:224-229).
- NUM_EPOCHS epochs, each with one permutation of the env axis (time stays
  major, so sequences stay whole) cut into NUM_MINIBATCHES minibatches
  (:344-350). A minibatch step replays the whole window from its first
  stored hidden state (truncated BPTT) and takes its lambda targets, closure
  form, from the stop-gradient of the same forward (:275-330), through
  ``ops/lambda_returns.py:lambda_returns_closure`` (on ``cuda`` one launch
  of the returns kernel a minibatch step, on the CPU its plain twin).
- With FAST_BPTT the forward is ``ops/fast_rnn.py:fast_rnn_train_forward``,
  and with PALLAS_BPTT its GRU recurrence runs through the two CUDA kernels
  (``ops/gru_scan.py``); on ``cuda`` the config policy turns both on.
- The update metrics (:369-387) and, every TEST_INTERVAL of the run, a
  greedy eval over TEST_NUM_STEPS steps from a zero carry (:415-452).

As in the FF trainer, counters and schedules are host numbers and metrics
stay device tensors until the end, so the update loop makes no host sync;
with COLLECT_METRICS=False (:118, :413) no metrics are returned, and the
losses' means and the per-update dicts are skipped (the eval still runs).
ARCH defaults to ``mlp`` (:72), so an image observation is flattened
(``algo/pqn.py:build_env``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from purejaxql_torch.algo.exploration import draw_seed, eps_greedy_batch
from purejaxql_torch.algo.metrics import (
    apply_eval_subsample,
    episode_mean_metrics,
    test_interval_updates,
)
from purejaxql_torch.algo.pqn import _NOT_PORTED, build_env, stack_metrics
from purejaxql_torch.algo.types import RNNTransition
from purejaxql_torch.core.config import derive_pqn_schedule_keys
from purejaxql_torch.core.optim import ClipRAdam, make_optimizer
from purejaxql_torch.core.schedules import epsilon_schedule, lr_schedule
from purejaxql_torch.core.train_state import PQNTrainState
from purejaxql_torch.models.factory import check_rnn_q_network, make_rnn_q_network
from purejaxql_torch.models.rnn import RNNQNetwork
from purejaxql_torch.ops.fast_rnn import fast_rnn_train_forward, supports_fast_bptt
from purejaxql_torch.ops.lambda_returns import lambda_returns_closure
from purejaxql_torch.utils.platform import resolve_device

# the FF trainer's batched modes (the reset bank among them), done-masked
# metrics and the epsilon-greedy kernel are not wired into the recurrent
# trainer yet
_NOT_PORTED_RNN = {
    **_NOT_PORTED,
    "BATCH_ENV": "BATCH_ENV",
    "USE_OPTIMISTIC_RESETS": "optimistic resets",
    "RESET_BANK": "RESET_BANK in the recurrent trainer",
    "DONE_MASKED_INFO_METRICS": "DONE_MASKED_INFO_METRICS",
    "EXPLORATION_KERNEL": "EXPLORATION_KERNEL in the recurrent rollout",
}


def _check_supported(config: Dict[str, Any]) -> None:
    if not str(config.get("ALG_NAME", "")).startswith("pqn_rnn"):
        raise NotImplementedError(f"ALG_NAME '{config.get('ALG_NAME')}' is not a pqn_rnn config")
    if config.get("NUM_SEEDS", 1) != 1:
        raise NotImplementedError("NUM_SEEDS > 1 is not ported yet: run one seed")
    for key, what in _NOT_PORTED_RNN.items():
        if config.get(key, False):
            raise NotImplementedError(f"{what} is not ported yet")
    if config["NUM_ENVS"] % config["NUM_MINIBATCHES"] != 0:
        raise ValueError("NUM_MINIBATCHES must divide NUM_ENVS (env-axis minibatching)")
    if config.get("FAST_BPTT", False) and not supports_fast_bptt(config):
        raise ValueError(
            "FAST_BPTT supports the GRU + layer_norm trunk family (RNN_CELL=gru, "
            "NORM_TYPE=layer_norm, no dueling): see ops/fast_rnn.py"
        )


def map_transitions(fn: Callable, *transitions):
    """``fn`` over each field of one or more transition records of one type
    (``RNNTransition``, ``MARLTransition``), layer by layer for the hidden
    states (a tree map)."""
    fields = {}
    for f in dataclasses.fields(transitions[0]):
        values = [getattr(t, f.name) for t in transitions]
        if isinstance(values[0], tuple):
            fields[f.name] = tuple(fn(*layer) for layer in zip(*values))
        else:
            fields[f.name] = fn(*values)
    return type(transitions[0])(**fields)


@torch.no_grad()
def rnn_rollout(network, log_env, env_params, generator, carry, eps, length, rew_scale=1.0):
    """``length`` env steps (pqn_rnn.py:169-200) from ``carry`` = (hidden,
    obs, done, last_action, log_state): the network on a length-1 time
    slice in eval mode, epsilon-greedy, the Log-wrapped env step. Returns the
    new carry, the transitions and the Log infos, stacked over time."""
    steps, infos = [], []
    for _ in range(length):
        hs, obs, done, last_action, log_state = carry
        new_hs, q_vals = network(hs, obs[None], done[None], last_action[None], train=False)
        q_vals = q_vals[0]
        action = eps_greedy_batch(generator, q_vals, eps)
        new_obs, log_state, reward, new_done, info = log_env.step(
            generator, log_state, action, env_params
        )
        steps.append((obs, action, rew_scale * reward, new_done, tuple(hs), done, last_action, q_vals))
        infos.append(info)
        carry = (new_hs, new_obs, new_done, action, log_state)
    f = list(zip(*steps))
    transitions = RNNTransition(
        obs=torch.stack(f[0]),
        action=torch.stack(f[1]),
        reward=torch.stack(f[2]),
        done=torch.stack(f[3]),
        last_hs=tuple(torch.stack(layer) for layer in zip(*f[4])),
        last_done=torch.stack(f[5]),
        last_action=torch.stack(f[6]),
        q_val=torch.stack(f[7]),
    )
    return carry, transitions, {k: torch.stack([i[k] for i in infos]) for k in infos[0]}


def rnn_train_q_values(
    network: RNNQNetwork,
    hidden,
    obs: torch.Tensor,
    done: torch.Tensor,
    last_action: torch.Tensor,
    fast_bptt: bool = False,
    pallas: bool = False,
) -> torch.Tensor:
    """The train-mode Q-values (T, B, A) of a window, from the network's
    module forward or from ``fast_rnn_train_forward``; both leave the input
    BatchNorm's running statistics updated (pqn_rnn.py:276-314)."""
    if not fast_bptt:
        return network(hidden, obs, done, last_action, train=True)[1]
    buffers = dict(network.named_buffers())
    _, q_vals, new_stats = fast_rnn_train_forward(
        dict(network.named_parameters()), buffers, hidden, obs, done, last_action,
        num_layers=network.num_layers, num_rnn_layers=network.num_rnn_layers,
        action_dim=network.action_dim, add_last_action=network.add_last_action,
        norm_input=network.norm_input, pallas=pallas,
    )
    with torch.no_grad():
        for name, value in new_stats.items():
            buffers[name].copy_(value)
    return q_vals


def learn_minibatch(
    network: RNNQNetwork,
    optimizer: ClipRAdam,
    minibatch: RNNTransition,
    gamma: float,
    lam: float,
    fast_bptt: bool = False,
    pallas: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One minibatch step (pqn_rnn.py:234-342): the window's train-mode
    forward from its first stored hidden state, closure-form lambda targets
    from the stop-gradient of the same Q-values (the window's last step only
    bootstraps), 0.5 * MSE on the taken actions of the first T - 1 steps,
    and clip + RAdam on every parameter. Returns the loss and the chosen
    Q-values, detached."""
    hs0 = [h[0] for h in minibatch.last_hs]
    q_vals = rnn_train_q_values(
        network, hs0, minibatch.obs, minibatch.last_done, minibatch.last_action,
        fast_bptt, pallas,
    )
    target_q = q_vals.detach()
    last_q = target_q[-1].max(-1).values
    target = lambda_returns_closure(
        last_q,
        minibatch.reward[:-1],
        minibatch.done[:-1],
        target_q[:-1].max(-1).values,
        gamma,
        lam,
    ).reshape(-1)
    chosen = q_vals.gather(-1, minibatch.action[..., None]).squeeze(-1)[:-1].reshape(-1)
    loss = 0.5 * torch.square(chosen - target).mean()
    grads = torch.autograd.grad(loss, optimizer.params, allow_unused=True, materialize_grads=True)
    optimizer.step(grads)
    return loss.detach(), chosen.detach()


def make_train(
    config: Dict[str, Any], device: Optional[str] = None
) -> Callable[..., Dict[str, Any]]:
    """Build ``train(seed=None) -> {"runner_state", "metrics"}``.

    ``device`` defaults to the config's DEVICE key, else ``cuda``; a missing
    GPU raises. ``metrics`` maps each metric name to a tensor of shape
    (NUM_UPDATES,), and is empty with COLLECT_METRICS=False;
    ``runner_state`` is (train_state, memory, (hidden, obs, done,
    last_action, log_state), test_metrics).
    """
    config = derive_pqn_schedule_keys(apply_eval_subsample(dict(config)))
    _check_supported(config)
    device = resolve_device(device if device is not None else config.get("DEVICE"))

    config.setdefault("ARCH", "mlp")  # the recurrent trunk is dense: flatten the observations
    log_env, _, env, env_params = build_env(config)
    config.setdefault("TEST_NUM_STEPS", env_params.max_steps_in_episode)
    action_dim = env.action_space(env_params).n
    obs_shape = env.observation_space(env_params).shape
    check_rnn_q_network(config, obs_shape)

    n_envs, n_steps = config["NUM_ENVS"], config["NUM_STEPS"]
    n_minibatches, n_epochs = config["NUM_MINIBATCHES"], config["NUM_EPOCHS"]
    memory_len = config.get("MEMORY_WINDOW", 0) + n_steps
    gamma, lam = config["GAMMA"], config["LAMBDA"]
    fast_bptt = config.get("FAST_BPTT", False)
    pallas = fast_bptt and config.get("PALLAS_BPTT", False)
    rew_scale = config.get("REW_SCALE", 1.0)
    timestep_scale = config.get("TIMESTEP_SCALE", 1)
    test_during_training = config.get("TEST_DURING_TRAINING", False)
    collect_metrics = config.get("COLLECT_METRICS", True)
    eps_scheduler = epsilon_schedule(
        config["EPS_START"],
        config["EPS_FINISH"],
        config["EPS_DECAY"] * config["NUM_UPDATES_DECAY"],
    )

    def train(seed: Optional[int] = None) -> Dict[str, Any]:
        host_gen = torch.Generator().manual_seed(config["SEED"] if seed is None else seed)
        network = make_rnn_q_network(config, action_dim, obs_shape, generator=host_gen).to(device)
        dev_gen = torch.Generator(device=device).manual_seed(draw_seed(host_gen))
        optimizer = make_optimizer(
            network.parameters(), config["MAX_GRAD_NORM"], lr_schedule(config)
        )
        train_state = PQNTrainState(network, optimizer)

        def start(n: int):
            obs, log_state = log_env.reset(dev_gen, n, env_params)
            done = torch.zeros(n, dtype=torch.bool, device=device)
            action = torch.zeros(n, dtype=torch.long, device=device)
            return (network.initialize_carry(n, device), obs, done, action, log_state)

        def learn(memory: RNNTransition):
            losses, qvals = [], []
            for _ in range(n_epochs):
                perm = torch.randperm(n_envs, generator=dev_gen, device=device)
                for idx in perm.reshape(n_minibatches, -1):
                    minibatch = map_transitions(lambda x: x[:, idx], memory)
                    loss, chosen = learn_minibatch(
                        network, optimizer, minibatch, gamma, lam, fast_bptt, pallas
                    )
                    train_state.grad_steps += 1
                    losses.append(loss)
                    qvals.append(chosen)
            if not collect_metrics:
                return None, None
            return torch.stack(losses).mean(), torch.stack(qvals).mean()

        def get_test_metrics() -> Dict[str, torch.Tensor]:
            carry = start(config["TEST_NUM_ENVS"])
            _, _, infos = rnn_rollout(
                network, log_env, env_params, dev_gen, carry, config["EPS_TEST"],
                config["TEST_NUM_STEPS"], rew_scale,
            )
            return episode_mean_metrics(infos)

        test_metrics = get_test_metrics() if test_during_training else {}
        carry, memory, _ = rnn_rollout(
            network, log_env, env_params, dev_gen, start(n_envs), 1.0, memory_len, rew_scale
        )
        history = []
        for _ in range(config["NUM_UPDATES"]):
            eps = eps_scheduler(train_state.n_updates)
            carry, transitions, infos = rnn_rollout(
                network, log_env, env_params, dev_gen, carry, eps, n_steps, rew_scale
            )
            train_state.timesteps += n_steps * n_envs * timestep_scale
            memory = map_transitions(
                lambda old, new: torch.cat([old[n_steps:], new]), memory, transitions
            )
            td_loss, qvals = learn(memory)
            train_state.n_updates += 1
            if test_during_training and train_state.n_updates % test_interval_updates(config) == 0:
                test_metrics = get_test_metrics()
            if not collect_metrics:
                continue

            metrics = {
                "env_step": train_state.timesteps,
                "update_steps": train_state.n_updates,
                "grad_steps": train_state.grad_steps,
                "td_loss": td_loss,
                "qvals": qvals,
            }
            metrics.update({k: v.float().mean() for k, v in infos.items()})
            if test_during_training:
                metrics.update({f"test/{k}": v for k, v in test_metrics.items()})
            history.append(metrics)

        return {
            "runner_state": (train_state, memory, carry, test_metrics),
            "metrics": stack_metrics(history),
        }

    return train
