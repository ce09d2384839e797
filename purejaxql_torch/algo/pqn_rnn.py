"""RNN-PQN: the trainer for recurrent Q-networks (GRU or LSTM).

Port of purejaxql_tpu/algo/pqn_rnn.py `make_train` for GRU and LSTM cells
on a trunk of any NORM_TYPE (``+alg=pqn_rnn_memory_chain``,
``+alg=pqn_rnn_cartpole``, ``+alg=pqn_rnn_craftax``; the norms of
``models/factory.py:resolve_norms``). Line references ``pqn_rnn.py:N`` are
to that module.

- The envs come from ``algo/pqn.py:build_env``, as in the FF trainer: the
  Log-wrapped env, or in the batched modes (BATCH_ENV, optimistic resets,
  with RESET_BANK the reset bank) the training env and the eval's own.
- Before training, a random-policy prefill of MEMORY_WINDOW + NUM_STEPS
  steps fills the memory (:468-476).
- Each update: a NUM_STEPS rollout, one env step at a time, each step
  running the network on a length-1 time slice in eval mode and storing the
  *incoming* hidden state, done flag and action (:154-200); the memory drops
  its oldest NUM_STEPS steps and appends the rollout (:224-229). The actions
  of the rollouts and the prefill come from ``algo/exploration.py:
  make_eps_greedy`` (EXPLORATION_KERNEL="pallas": the epsilon-greedy kernel,
  on ``cuda`` by the config policy), the eval's from ``eps_greedy_batch``.
  An LSTM layer's carry is a (c, h) pair, so the hidden states are trees
  (``tree_map``).
- NUM_EPOCHS epochs, each with one permutation of the env axis (time stays
  major, so sequences stay whole) cut into NUM_MINIBATCHES minibatches
  (:344-350). A minibatch step replays the whole window from its first
  stored hidden state (truncated BPTT) and takes its lambda targets, closure
  form, from the stop-gradient of the same forward (:275-330), through
  ``ops/lambda_returns.py:lambda_returns_closure`` (on ``cuda`` one launch
  of the returns kernel a minibatch step, on the CPU its plain twin).
- A batch_norm or batch_renorm trunk runs the module path (FAST_BPTT takes
  a layer_norm trunk only, as in JAX): its statistics over all T x B rows
  of the window's train-mode forward, the rollout's length-1 steps on the
  running statistics.
- With FAST_BPTT the forward is ``ops/fast_rnn.py:fast_rnn_train_forward``
  (BF16_COMPUTE: its products with bfloat16 operands, :296-300; the module
  path ignores the flag, as the JAX trainer does), and with PALLAS_BPTT its
  GRU recurrence runs through the two CUDA kernels (``ops/gru_scan.py``); on
  ``cuda`` the config policy turns on FAST_BPTT, and PALLAS_BPTT for a GRU
  stack.
- The update metrics (:369-387; DONE_MASKED_INFO_METRICS averages the infos
  over the steps that end an episode, :376-385) and, every TEST_INTERVAL of
  the run, a greedy eval on the eval env over TEST_NUM_STEPS steps from a
  zero carry (:415-452).

As in the FF trainer, counters and schedules are host numbers and metrics
stay device tensors until the end, so the update loop makes no host sync;
with COLLECT_METRICS=False (:118, :413) no metrics are returned, and the
losses' means and the per-update dicts are skipped (the eval still runs).
ARCH defaults to ``mlp`` (:72), so an image observation is flattened
(``algo/pqn.py:build_env``).

NUM_SEEDS = S > 1 trains S seeds as one program (``algo/seeds.py``): the
stacked network, S * NUM_ENVS seed-major envs and carries, each seed's own
env permutation (minibatch m of every seed in one grad step), the loss the
sum of each seed's mean, the closure targets over (T, S * B) columns, on
FAST_BPTT with PALLAS_BPTT each GRU layer's scan one launch of each kernel
for all seeds, and (S, NUM_UPDATES) metrics. ``pqn_rnn_craftax`` runs so
too, in the strict and the fast program: each seed's reset pool or bank
(``algo/pqn.py:build_env``), the stacked input BatchRenorm (each seed's
statistics and step count) and BF16_COMPUTE in the FAST_BPTT forward.

With a process ``group`` (pqn_rnn.py:55's ``pmap_axis``) the trainer is one
rank of a sharded run (parallel/spmd.py), as the FF trainer's
(``algo/pqn.py``): the rank's generators after the shared network, the
gradients, the input and trunk norms' statistics (the FAST_BPTT forward's
too) and the update's metrics meaned over the group, the eval's episodes
summed over it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from purejaxql_torch.algo.exploration import eps_greedy_batch, make_eps_greedy
from purejaxql_torch.algo.metrics import (
    apply_eval_subsample,
    emit_metric_rows,
    episode_mean_metrics,
    group_mean_metrics,
    metric_callback,
    test_interval_updates,
)
from purejaxql_torch.algo.pqn import build_env, stack_metrics
from purejaxql_torch.algo.seeds import (
    check_group_seeds,
    check_seeds,
    run_generators,
    seed_column_minibatches,
    seed_generators,
    seed_mean,
    seed_sum,
)
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

def _check_supported(config: Dict[str, Any]) -> None:
    if not str(config.get("ALG_NAME", "")).startswith("pqn_rnn"):
        raise NotImplementedError(f"ALG_NAME '{config.get('ALG_NAME')}' is not a pqn_rnn config")
    check_seeds(config)
    if config["NUM_ENVS"] % config["NUM_MINIBATCHES"] != 0:
        raise ValueError("NUM_MINIBATCHES must divide NUM_ENVS (env-axis minibatching)")
    if config.get("FAST_BPTT", False) and not supports_fast_bptt(config):
        raise ValueError(
            "FAST_BPTT supports the GRU + layer_norm trunk family (RNN_CELL=gru, "
            "NORM_TYPE=layer_norm, no dueling): see ops/fast_rnn.py"
        )


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of one or more trees of one structure, the
    nodes lists and tuples (the hidden states: a list of layers, an LSTM
    layer's (c, h) pair); the result keeps the first tree's node types."""
    if isinstance(trees[0], (list, tuple)):
        return type(trees[0])(tree_map(fn, *nodes) for nodes in zip(*trees))
    return fn(*trees)


def map_transitions(fn: Callable, *transitions):
    """``fn`` over each field of one or more transition records of one type
    (``RNNTransition``, ``MARLTransition``), leaf by leaf for the hidden
    states (``tree_map``)."""
    fields = {
        f.name: tree_map(fn, *(getattr(t, f.name) for t in transitions))
        for f in dataclasses.fields(transitions[0])
    }
    return type(transitions[0])(**fields)


@torch.no_grad()
def rnn_rollout(network, env, env_params, generator, carry, eps, length, rew_scale=1.0, explore=None):
    """``length`` env steps (pqn_rnn.py:169-200) from ``carry`` = (hidden,
    obs, done, last_action, env_state): the network on a length-1 time
    slice in eval mode, epsilon-greedy (``explore(q_vals, eps)``, by default
    ``eps_greedy_batch`` on ``generator``), the env step (the Log-wrapped
    env or a batched mode of it). Returns the new carry, the transitions and
    the Log infos, stacked over time."""
    if explore is None:
        explore = lambda q_vals, e: eps_greedy_batch(generator, q_vals, e)  # noqa: E731
    steps, infos = [], []
    for _ in range(length):
        hs, obs, done, last_action, env_state = carry
        new_hs, q_vals = network(hs, obs[None], done[None], last_action[None], train=False)
        q_vals = q_vals[0]
        action = explore(q_vals, eps)
        new_obs, env_state, reward, new_done, info = env.step(generator, env_state, action, env_params)
        steps.append((obs, action, rew_scale * reward, new_done, tuple(hs), done, last_action, q_vals))
        infos.append(info)
        carry = (new_hs, new_obs, new_done, action, env_state)
    f = list(zip(*steps))
    transitions = RNNTransition(
        obs=torch.stack(f[0]),
        action=torch.stack(f[1]),
        reward=torch.stack(f[2]),
        done=torch.stack(f[3]),
        last_hs=tree_map(lambda *xs: torch.stack(xs), *f[4]),
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
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The train-mode Q-values (T, B, A) of a window, from the network's
    module forward or from ``fast_rnn_train_forward`` (in
    ``compute_dtype``); both leave the input norm's running statistics
    updated (pqn_rnn.py:276-314). A network with seeds takes and gives
    seed-major rows. The FAST_BPTT forward takes the input norm's process
    group (``models/qnet.py:share_statistics``)."""
    if not fast_bptt:
        return network(hidden, obs, done, last_action, train=True)[1]
    input_norm = network.BatchRenorm_0 if network.input_norm_type == "batch_renorm" else network.BatchNorm_0
    buffers = dict(network.named_buffers())
    _, q_vals, new_stats = fast_rnn_train_forward(
        dict(network.named_parameters()), buffers, hidden, obs, done, last_action,
        num_layers=network.num_layers, num_rnn_layers=network.num_rnn_layers,
        action_dim=network.action_dim, add_last_action=network.add_last_action,
        norm_input=network.norm_input, cell_type=network.cell_type,
        input_norm_type=network.input_norm_type, pallas=pallas, compute_dtype=compute_dtype,
        seeds=network.seeds, group=input_norm.group,
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
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One minibatch step (pqn_rnn.py:234-342): the window's train-mode
    forward from its first stored hidden state, closure-form lambda targets
    from the stop-gradient of the same Q-values (the window's last step only
    bootstraps), 0.5 * MSE on the taken actions of the first T - 1 steps,
    and clip + RAdam on every parameter; with seeds (the optimizer's) over
    seed-major columns, the loss the sum over seeds of each seed's mean.
    Returns the loss, (S,) with seeds, and the chosen Q-values (flattened
    time-major), detached."""
    hs0 = list(tree_map(lambda x: x[0], minibatch.last_hs))
    q_vals = rnn_train_q_values(
        network, hs0, minibatch.obs, minibatch.last_done, minibatch.last_action,
        fast_bptt, pallas, compute_dtype,
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
    chosen = q_vals.gather(-1, minibatch.action[..., None]).squeeze(-1)[:-1]
    loss = seed_mean(0.5 * torch.square(chosen - target.reshape(chosen.shape)), optimizer.seeds, 1)
    grads = torch.autograd.grad(loss.sum(), optimizer.params, allow_unused=True, materialize_grads=True)
    optimizer.step(grads)
    return loss.detach(), chosen.detach().reshape(-1)


def make_train(
    config: Dict[str, Any], device: Optional[str] = None, logger=None, group=None
) -> Callable[..., Dict[str, Any]]:
    """Build ``train(seed=None, runner_state=None) -> {"runner_state",
    "metrics"}``; with a process ``group``, one rank's trainer of a sharded
    run (the module's docstring).

    ``device`` defaults to the config's DEVICE key, else ``cuda``; a missing
    GPU raises. ``metrics`` maps each metric name to a tensor of shape
    (NUM_UPDATES,), (NUM_SEEDS, NUM_UPDATES) with seeds, and is empty with
    COLLECT_METRICS=False; ``runner_state`` is (train_state, memory,
    (hidden, obs, done, last_action, env_state), test_metrics, (host
    generator, device generator)), the envs seed-major with seeds. Given a
    ``runner_state``, ``train`` continues that run (pqn_rnn.py:120-125,
    454-483): no new network, reset, prefill or first eval.

    With LOG_VIA_CALLBACK and a ``logger``, every update whose count is a
    multiple of LOG_INTERVAL hands its metrics, once a seed, to
    ``logger.make_callback()`` (pqn_rnn.py:403-404, which calls it every
    update), COLLECT_METRICS=False or not.
    """
    config = derive_pqn_schedule_keys(apply_eval_subsample(dict(config)))
    _check_supported(config)
    check_group_seeds(config, group)
    seeds = config.get("NUM_SEEDS", 1)
    device = resolve_device(device if device is not None else config.get("DEVICE"))

    config.setdefault("ARCH", "mlp")  # the recurrent trunk is dense: flatten the observations
    train_env, test_env, env, env_params = build_env(config)
    config.setdefault("TEST_NUM_STEPS", env_params.max_steps_in_episode)
    action_dim = env.action_space(env_params).n
    obs_shape = env.observation_space(env_params).shape
    check_rnn_q_network(obs_shape)

    n_envs, n_steps = config["NUM_ENVS"], config["NUM_STEPS"]
    n_minibatches, n_epochs = config["NUM_MINIBATCHES"], config["NUM_EPOCHS"]
    memory_len = config.get("MEMORY_WINDOW", 0) + n_steps
    gamma, lam = config["GAMMA"], config["LAMBDA"]
    fast_bptt = config.get("FAST_BPTT", False)
    pallas = fast_bptt and config.get("PALLAS_BPTT", False)
    compute_dtype = torch.bfloat16 if config.get("BF16_COMPUTE", False) else torch.float32
    done_masked = config.get("DONE_MASKED_INFO_METRICS", False)
    rew_scale = config.get("REW_SCALE", 1.0)
    timestep_scale = config.get("TIMESTEP_SCALE", 1)
    test_during_training = config.get("TEST_DURING_TRAINING", False)
    collect_metrics = config.get("COLLECT_METRICS", True)
    callback = metric_callback(config, logger)
    log_interval = config.get("LOG_INTERVAL", 1)
    need_metrics = collect_metrics or callback is not None
    eps_scheduler = epsilon_schedule(
        config["EPS_START"],
        config["EPS_FINISH"],
        config["EPS_DECAY"] * config["NUM_UPDATES_DECAY"],
    )

    def train(seed: Optional[int] = None, runner_state=None) -> Dict[str, Any]:
        if runner_state is None:
            gens = seed_generators(config["SEED"] if seed is None else seed, seeds)
            host_gen = gens[0]
            network = make_rnn_q_network(
                config, action_dim, obs_shape, generator=gens if seeds > 1 else host_gen, seeds=seeds, group=group
            ).to(device)
            host_gen, dev_gen = run_generators(host_gen, device, group)
            optimizer = make_optimizer(
                network.parameters(), config["MAX_GRAD_NORM"], lr_schedule(config), seeds, group
            )
            train_state = PQNTrainState(network, optimizer)
        else:
            train_state, memory, carry, test_metrics, (host_gen, dev_gen) = runner_state
            network, optimizer = train_state.network, train_state.optimizer
        explore = make_eps_greedy(config, dev_gen, host_gen)

        def start(env_, n: int):
            obs, env_state = env_.reset(dev_gen, n, env_params)
            done = torch.zeros(n, dtype=torch.bool, device=device)
            action = torch.zeros(n, dtype=torch.long, device=device)
            return (network.initialize_carry(n, device), obs, done, action, env_state)

        def learn(memory: RNNTransition):
            losses, qvals = [], []
            for _ in range(n_epochs):
                # each seed's envs permuted, as columns of the seed-major
                # memory; minibatch m takes block m of every seed's
                for idx in seed_column_minibatches(dev_gen, seeds, n_envs, n_minibatches, device):
                    minibatch = map_transitions(lambda x: x[:, idx], memory)
                    loss, chosen = learn_minibatch(
                        network, optimizer, minibatch, gamma, lam, fast_bptt, pallas, compute_dtype
                    )
                    train_state.grad_steps += 1
                    losses.append(loss)
                    qvals.append(chosen)
            if not need_metrics:
                return None, None
            qvals = torch.stack(qvals).unflatten(1, (memory_len - 1, -1))  # (steps, T - 1, S * B)
            return seed_mean(torch.stack(losses), seeds, -1), seed_mean(qvals, seeds, 2)

        def get_test_metrics() -> Dict[str, torch.Tensor]:
            carry = start(test_env, seeds * config["TEST_NUM_ENVS"])
            _, _, infos = rnn_rollout(
                network, test_env, env_params, dev_gen, carry, config["EPS_TEST"],
                config["TEST_NUM_STEPS"], rew_scale,
            )
            return episode_mean_metrics(infos, seeds, group)

        if runner_state is None:
            test_metrics = get_test_metrics() if test_during_training else {}
            carry, memory, _ = rnn_rollout(
                network, train_env, env_params, dev_gen, start(train_env, seeds * n_envs), 1.0, memory_len,
                rew_scale, explore,
            )
        history = []
        for _ in range(config["NUM_UPDATES"]):
            eps = eps_scheduler(train_state.n_updates)
            carry, transitions, infos = rnn_rollout(
                network, train_env, env_params, dev_gen, carry, eps, n_steps, rew_scale, explore
            )
            train_state.timesteps += n_steps * n_envs * timestep_scale
            memory = map_transitions(
                lambda old, new: torch.cat([old[n_steps:], new]), memory, transitions
            )
            td_loss, qvals = learn(memory)
            train_state.n_updates += 1
            if test_during_training and train_state.n_updates % test_interval_updates(config) == 0:
                test_metrics = get_test_metrics()
            if not need_metrics:
                continue

            metrics = {
                "env_step": train_state.timesteps,
                "update_steps": train_state.n_updates,
                "grad_steps": train_state.grad_steps,
                "td_loss": td_loss,
                "qvals": qvals,
            }
            if done_masked:
                # the infos at episode ends only, a mean weighted by returned_episode
                ended = infos["returned_episode"].float()
                denom = seed_sum(ended, seeds, 1).clamp(min=1.0)
                metrics.update({k: seed_sum(v.float() * ended, seeds, 1) / denom for k, v in infos.items()})
            else:
                metrics.update({k: seed_mean(v.float(), seeds, 1) for k, v in infos.items()})
            metrics = group_mean_metrics(metrics, group)
            if test_during_training:
                metrics.update({f"test/{k}": v for k, v in test_metrics.items()})
            if callback is not None and train_state.n_updates % log_interval == 0:
                emit_metric_rows(callback, metrics, seeds, last_seed_first=True)
            if collect_metrics:
                history.append(metrics)

        return {
            "runner_state": (train_state, memory, carry, test_metrics, (host_gen, dev_gen)),
            "metrics": stack_metrics(history, seeds),
        }

    return train
