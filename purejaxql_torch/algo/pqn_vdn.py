"""VDN-RNN-PQN: cooperative multi-agent Q-learning with value decomposition.

Port of purejaxql_tpu/algo/pqn_vdn.py `make_train` (``+alg=pqn_vdn_*``).
Line references ``pqn_vdn.py:N`` are to that module.

- One recurrent Q-network with parameters shared by every agent, built as
  the JAX trainer builds it (:93-104): without the last action as an input
  whatever the config says, HIDDEN_SIZE 256 by default, NORM_TYPE as given
  and the BatchNorm input norm whatever INPUT_NORM_TYPE says (no per-family
  mapping). RNN_CELL gru or lstm (an LSTM layer's carry is a (c, h) pair
  through the rollout, the memory and the minibatch's first hidden state).
  An LSTM trains on the module path only: the JAX trainer's FAST_BPTT
  forward takes no cell type (:322-341) and raises ``KeyError:
  'GRUCell_0'`` on an LSTM's parameters, so the port raises the same
  KeyError, and its cuda policy leaves FAST_BPTT off for it. Where the JAX
  trainer ``vmap``s the network over the agents during the rollout
  (:177-195), the port runs one forward over the A x E rows: exact, since
  in eval mode no norm reads batch statistics and the LayerNorm works per
  row. A BatchNorm or BatchRenorm trunk (NORM_TYPE) trains on the module
  path too, its train-mode statistics over all T x A x B rows of the
  minibatch window, as JAX's one forward over the agents-major rows.
- Epsilon-greedy over legal actions only, greedy and random branch alike
  (``algo/exploration.py:masked_eps_greedy``, :41-66).
- Before training, a random-policy prefill of MEMORY_WINDOW + NUM_STEPS
  steps fills the memory, its rewards unscaled (:515-520); the training
  rollout scales them by REW_SCALE. Each update, a NUM_STEPS rollout slides
  the memory: ``cat([memory[NUM_STEPS:], rollout])`` (:264-270).
- NUM_EPOCHS epochs, each one permutation of the env axis, the same for
  every agent, cut into NUM_MINIBATCHES minibatches (:396-403). A minibatch
  step replays the window from its first stored hidden state as one forward
  over the agents-major rows ``a * B + b`` (:278-285), through the network
  or, with FAST_BPTT, through ``ops/fast_rnn.py:fast_rnn_train_forward``
  (with PALLAS_BPTT its GRU recurrence through the CUDA scan kernels; on
  ``cuda`` the config policy turns both on; BF16_COMPUTE its products with
  bfloat16 operands, :337-341, ignored on the module path as in JAX). The
  target is the closure-form
  lambda return (``ops/lambda_returns.py:lambda_returns_closure``, one
  launch of the returns kernel a step on ``cuda``) of the team reward,
  bootstrapping from the sum over agents of each agent's largest legal Q of
  the stop-gradient forward (``q - (1 - avail) * 1e10``), regressed by MSE
  against the sum over agents of the chosen Q (:287-385).
- VDN's own schedules: epsilon decays over EPS_DECAY * NUM_UPDATES updates
  (:132-136), the LR linearly to 1e-10 over every grad step (:148-160).
- The update metrics are means over every step and env of the rollout
  (:421-428); every TEST_INTERVAL of the run a greedy eval on its own
  TEST_NUM_ENVS envs from a zero carry (:458-505). COLLECT_METRICS=False
  returns no metrics (:456).

Counters and schedules are host numbers and metrics stay device tensors
until the end, as in the other trainers: the update loop makes no host sync.

NUM_SEEDS = S > 1 trains S seeds as one program (``algo/seeds.py``): the
stacked network, S * NUM_ENVS seed-major envs (the env axis of every (A,
S * E) tensor), each seed's own env permutation (minibatch m takes block m
of every seed's), the loss the sum of each seed's mean, the closure targets
over (T - 1, S * B) columns in one returns launch, and (S, NUM_UPDATES)
metrics and evals. The network reads its rows (S, A, E) seed-major, agents
within each seed (``agent_rows``): each seed's A x B rows stay one block, so
on FAST_BPTT with PALLAS_BPTT each GRU layer's scan is one launch of each
kernel for all seeds, no cluster straddling two seeds.

With a process ``group`` (pqn_vdn.py:71's ``pmap_axis``) the trainer is one
rank of a sharded run (parallel/spmd.py), as the FF trainer's: the rank's
generators after the shared network, the gradients, the norms' statistics
and the update's metrics meaned over the group, the eval's episodes summed
over it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from purejaxql_torch.algo.exploration import greedy_legal_actions, masked_eps_greedy
from purejaxql_torch.algo.metrics import (
    apply_eval_subsample,
    emit_metric_rows,
    episode_mean_metrics,
    group_mean_metrics,
    metric_callback,
    test_interval_updates,
)
from purejaxql_torch.algo.pqn import stack_metrics
from purejaxql_torch.algo.pqn_rnn import map_transitions, rnn_train_q_values, tree_map
from purejaxql_torch.algo.seeds import (
    check_group_seeds,
    check_seeds,
    run_generators,
    seed_column_minibatches,
    seed_generators,
    seed_mean,
)
from purejaxql_torch.algo.types import MARLTransition
from purejaxql_torch.core.optim import ClipRAdam, make_optimizer
from purejaxql_torch.core.schedules import epsilon_schedule, linear_schedule
from purejaxql_torch.core.train_state import PQNTrainState
from purejaxql_torch.envs.marl import make_marl
from purejaxql_torch.envs.marl.base import CTRolloutManager, MARLLogWrapper
from purejaxql_torch.models.factory import make_rnn_q_network
from purejaxql_torch.models.rnn import RNNQNetwork
from purejaxql_torch.ops.fast_rnn import supports_fast_bptt
from purejaxql_torch.ops.lambda_returns import lambda_returns_closure
from purejaxql_torch.utils.platform import resolve_device

def _check_supported(config: Dict[str, Any]) -> None:
    if not str(config.get("ALG_NAME", "")).startswith("pqn_vdn"):
        raise NotImplementedError(f"ALG_NAME '{config.get('ALG_NAME')}' is not a pqn_vdn config")
    check_seeds(config)
    if config["NUM_ENVS"] % config["NUM_MINIBATCHES"] != 0:
        raise ValueError("NUM_MINIBATCHES must divide NUM_ENVS (env-axis minibatching)")
    if config.get("FAST_BPTT", False) and not supports_fast_bptt(config):
        raise ValueError(
            "FAST_BPTT supports the GRU + layer_norm trunk family (RNN_CELL=gru, "
            "NORM_TYPE=layer_norm, no dueling): see ops/fast_rnn.py"
        )
    if config.get("FAST_BPTT", False) and config.get("RNN_CELL", "gru") != "gru":
        # supports_fast_bptt takes an LSTM, but the JAX trainer's FAST_BPTT
        # forward gets no cell type (pqn_vdn.py:322-341) and reads a GRU
        # cell that the LSTM network lacks: JAX raises this KeyError
        raise KeyError(
            "GRUCell_0: the VDN trainer's FAST_BPTT forward reads a GRU cell (pqn_vdn.py:322-341); "
            "RNN_CELL=lstm trains on the module path, FAST_BPTT=False"
        )


def agent_rows(x: torch.Tensor, seeds: int, dim: int = 0) -> torch.Tensor:
    """x with an agent axis at ``dim`` and S * E seed-major envs after it ->
    the network's A * S * E rows at ``dim``, laid out (S, A, E): each seed's
    agents-major rows ``a * E + e`` one block, seed-major."""
    return x.unflatten(dim + 1, (seeds, -1)).transpose(dim, dim + 1).flatten(dim, dim + 2)


def from_agent_rows(y: torch.Tensor, seeds: int, n_agents: int, dim: int = 0) -> torch.Tensor:
    """The inverse of ``agent_rows``: rows (S, A, E) at ``dim`` -> (A,
    S * E) there."""
    return y.unflatten(dim, (seeds, n_agents, -1)).transpose(dim, dim + 1).flatten(dim + 1, dim + 2)


def agents_forward(network: RNNQNetwork, hidden, obs: torch.Tensor, done: torch.Tensor):
    """The shared network on one step of every agent at once, in eval mode:
    hidden a list of (A, E, H), obs (A, E, D), done (A, E) 0/1 -> (new
    hidden, q (A, E, n)). One forward over the A x E rows in place of the
    JAX trainer's vmap over agents (pqn_vdn.py:177-195); with seeds, E holds
    S * E seed-major envs, each seed's rows its lane's (``agent_rows``)."""
    n_agents, seeds = done.shape[0], network.seeds
    rows = lambda x: agent_rows(x, seeds)  # noqa: E731
    flat_hidden = tree_map(rows, list(hidden))
    r = rows(done)
    zeros = torch.zeros(1, *r.shape, dtype=torch.long, device=done.device)
    new_hidden, q = network(flat_hidden, rows(obs)[None], r[None], zeros, train=False)
    back = lambda y: from_agent_rows(y, seeds, n_agents)  # noqa: E731
    return tree_map(back, new_hidden), back(q[0])


def stack_agents(manager: CTRolloutManager, values: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A dict keyed by agent as one tensor, agent axis first (``batchify``)."""
    return torch.stack([values[a] for a in manager.agents])


@torch.no_grad()
def vdn_rollout(network, manager, generator, carry, eps, length, rew_scale=1.0, greedy=False):
    """``length`` steps of every env from ``carry`` = (hidden, obs, dones,
    env_state) (pqn_vdn.py:204-239): the shared network on the step, masked
    epsilon-greedy (with ``greedy`` the greedy legal action,
    :462-477), the batched env step. Returns the new carry, the transitions
    (rewards scaled by ``rew_scale``; none with ``greedy``) and the Log
    infos, stacked over time."""
    steps, infos = [], []
    for _ in range(length):
        hidden, obs, dones, env_state = carry
        obs_b = stack_agents(manager, obs)
        done_b = stack_agents(manager, dones).float()
        new_hidden, q_vals = agents_forward(network, hidden, obs_b, done_b)
        avail = stack_agents(manager, manager.get_valid_actions(env_state))
        if greedy:
            action = greedy_legal_actions(q_vals, avail)
        else:
            action = masked_eps_greedy(generator, q_vals, eps, avail)
        new_obs, env_state, reward, new_dones, info = manager.batch_step(
            generator, env_state, {a: action[i] for i, a in enumerate(manager.agents)}
        )
        if not greedy:
            team_done = new_dones["__all__"][None].float()
            steps.append(
                (obs_b, action, rew_scale * reward["__all__"][None], team_done, tuple(hidden), done_b, avail, q_vals)
            )
        infos.append(info)
        carry = (new_hidden, new_obs, new_dones, env_state)
    infos = {k: torch.stack([i[k] for i in infos]) for k in infos[0]}
    if greedy:
        return carry, None, infos
    f = list(zip(*steps))
    actions = torch.stack(f[1])
    transitions = MARLTransition(
        obs=torch.stack(f[0]),
        action=actions,
        reward=torch.stack(f[2]),
        done=torch.stack(f[3]),
        last_hs=tree_map(lambda *xs: torch.stack(xs), *f[4]),
        last_done=torch.stack(f[5]),
        last_action=actions,
        avail_actions=torch.stack(f[6]),
        q_val=torch.stack(f[7]),
    )
    return carry, transitions, infos


def vdn_targets(q_vals: torch.Tensor, avail: torch.Tensor, reward: torch.Tensor, done: torch.Tensor,
                gamma: float, lam: float) -> torch.Tensor:
    """The VDN lambda targets (T - 1, B) of a window (pqn_vdn.py:287-371):
    q_vals (T, A, B, n) detached, avail (T, A, B, n), reward and done (T, B).
    Each agent's largest legal Q (``q - (1 - avail) * 1e10``), summed over
    the agents, bootstraps the closure-form returns."""
    valid_q = q_vals - (1 - avail) * 1e10
    team_max = valid_q.max(-1).values.sum(1)  # (T, B)
    return lambda_returns_closure(
        team_max[-1], reward[:-1].contiguous(), done[:-1].contiguous(), team_max[:-1].contiguous(), gamma, lam
    )


def learn_minibatch(
    network: RNNQNetwork,
    optimizer: ClipRAdam,
    minibatch: MARLTransition,
    gamma: float,
    lam: float,
    fast_bptt: bool = False,
    pallas: bool = False,
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One minibatch step (pqn_vdn.py:275-394): the window's train-mode
    forward over the agents-major rows from its first stored hidden state,
    the VDN targets from the stop-gradient of the same Q-values, the MSE of
    the team's chosen Q on the first T - 1 steps, and clip + RAdam on every
    parameter. With seeds (the optimizer's) B holds S * B seed-major
    columns, the network reads them as ``agent_rows`` and the loss is the
    sum over seeds of each seed's mean. Returns the loss, (S,) with seeds,
    and the chosen Q-values (T, A, B), detached."""
    n_agents, seeds = minibatch.action.shape[1], optimizer.seeds
    hs0 = list(tree_map(lambda h: agent_rows(h[0], seeds), minibatch.last_hs))
    last_done = agent_rows(minibatch.last_done, seeds, 1)
    q_vals = from_agent_rows(rnn_train_q_values(
        network, hs0, agent_rows(minibatch.obs, seeds, 1), last_done,
        torch.zeros_like(last_done, dtype=torch.long), fast_bptt, pallas, compute_dtype,
    ), seeds, n_agents, 1)
    target = vdn_targets(
        q_vals.detach(), minibatch.avail_actions, minibatch.reward[:, 0], minibatch.done[:, 0], gamma, lam
    )
    chosen = q_vals.gather(-1, minibatch.action[..., None]).squeeze(-1)  # (T, A, B)
    vdn_chosen = chosen.sum(1)[:-1]
    loss = seed_mean(torch.square(vdn_chosen - target), seeds, 1)
    grads = torch.autograd.grad(loss.sum(), optimizer.params, allow_unused=True, materialize_grads=True)
    optimizer.step(grads)
    return loss.detach(), chosen.detach()


def vdn_lr(config: Dict[str, Any]):
    """The VDN trainer's LR (pqn_vdn.py:148-160): with LR_LINEAR_DECAY a
    linear decay to 1e-10 over NUM_EPOCHS * NUM_MINIBATCHES * NUM_UPDATES
    grad steps, else constant."""
    if not config.get("LR_LINEAR_DECAY", False):
        return config["LR"]
    return linear_schedule(
        config["LR"], 1e-10, config["NUM_EPOCHS"] * config["NUM_MINIBATCHES"] * config["NUM_UPDATES"]
    )


def make_train(
    config: Dict[str, Any], device: Optional[str] = None, logger=None, group=None
) -> Callable[..., Dict[str, Any]]:
    """Build ``train(seed=None) -> {"runner_state", "metrics"}``; with a
    process ``group``, one rank's trainer of a sharded run (the module's
    docstring).

    ``device`` defaults to the config's DEVICE key, else ``cuda``; a missing
    GPU raises. ``metrics`` maps each metric name to a tensor of shape
    (NUM_UPDATES,), (NUM_SEEDS, NUM_UPDATES) with seeds, and is empty with
    COLLECT_METRICS=False; ``runner_state`` is (train_state, memory,
    (hidden, obs, dones, env_state), test_metrics), the envs seed-major
    with seeds. With LOG_VIA_CALLBACK and a ``logger``, every update whose
    count is a multiple of LOG_INTERVAL hands its metrics, once a seed, to
    ``logger.make_callback()`` (pqn_vdn.py:446-447, which calls it every
    update), COLLECT_METRICS=False or not.
    """
    config = apply_eval_subsample(dict(config))
    config["TOTAL_TIMESTEPS"] = int(float(config["TOTAL_TIMESTEPS"]))
    config["NUM_UPDATES"] = config["TOTAL_TIMESTEPS"] // config["NUM_STEPS"] // config["NUM_ENVS"]
    _check_supported(config)
    check_group_seeds(config, group)
    seeds = config.get("NUM_SEEDS", 1)
    device = resolve_device(device if device is not None else config.get("DEVICE"))

    env = MARLLogWrapper(make_marl(config["ENV_NAME"], **(config.get("ENV_KWARGS") or {})))
    manager = CTRolloutManager(env, seeds * config["NUM_ENVS"])
    action_dim, obs_size = manager.max_action_space, manager.obs_size
    net_config = {**config, "ADD_LAST_ACTION": False}  # pqn_vdn.py:102

    n_envs, n_steps = config["NUM_ENVS"], config["NUM_STEPS"]
    n_minibatches, n_epochs = config["NUM_MINIBATCHES"], config["NUM_EPOCHS"]
    memory_len = config.get("MEMORY_WINDOW", 0) + n_steps
    gamma, lam = config["GAMMA"], config["LAMBDA"]
    fast_bptt = config.get("FAST_BPTT", False)
    pallas = fast_bptt and config.get("PALLAS_BPTT", False)
    compute_dtype = torch.bfloat16 if config.get("BF16_COMPUTE", False) else torch.float32
    rew_scale = config.get("REW_SCALE", 1.0)
    timestep_scale = config.get("TIMESTEP_SCALE", 1)
    test_during_training = config.get("TEST_DURING_TRAINING", False)
    collect_metrics = config.get("COLLECT_METRICS", True)
    callback = metric_callback(config, logger)
    log_interval = config.get("LOG_INTERVAL", 1)
    need_metrics = collect_metrics or callback is not None
    test_manager = CTRolloutManager(env, seeds * config["TEST_NUM_ENVS"]) if test_during_training else None
    eps_scheduler = epsilon_schedule(
        config["EPS_START"], config["EPS_FINISH"], config["EPS_DECAY"] * config["NUM_UPDATES"]
    )

    def train(seed: Optional[int] = None) -> Dict[str, Any]:
        gens = seed_generators(config["SEED"] if seed is None else seed, seeds)
        host_gen = gens[0]
        network = make_rnn_q_network(
            net_config, action_dim, (obs_size,), generator=gens if seeds > 1 else host_gen,
            norms=(config["NORM_TYPE"], "batch_norm"), hidden_size=256, seeds=seeds, group=group,
        ).to(device)
        host_gen, dev_gen = run_generators(host_gen, device, group)
        optimizer = make_optimizer(network.parameters(), config["MAX_GRAD_NORM"], vdn_lr(config), seeds, group)
        train_state = PQNTrainState(network, optimizer)

        def start(mgr: CTRolloutManager):
            obs, env_state = mgr.batch_reset(dev_gen)
            n = mgr.batch_size
            dones = {a: torch.zeros(n, dtype=torch.bool, device=device) for a in env.agents + ["__all__"]}
            hidden = tree_map(lambda h: h.expand(env.num_agents, -1, -1).clone(), network.initialize_carry(n, device))
            return hidden, obs, dones, env_state

        def learn(memory: MARLTransition):
            losses, qvals = [], []
            for _ in range(n_epochs):
                # each seed's envs permuted; minibatch m takes block m of every seed's
                for idx in seed_column_minibatches(dev_gen, seeds, n_envs, n_minibatches, device):
                    minibatch = map_transitions(lambda x: x[:, :, idx], memory)
                    loss, chosen = learn_minibatch(
                        network, optimizer, minibatch, gamma, lam, fast_bptt, pallas, compute_dtype
                    )
                    train_state.grad_steps += 1
                    losses.append(loss)
                    qvals.append(chosen)
            if not need_metrics:
                return None, None
            return seed_mean(torch.stack(losses), seeds, -1), seed_mean(torch.stack(qvals), seeds, 3)

        def get_test_metrics() -> Dict[str, torch.Tensor]:
            _, _, infos = vdn_rollout(
                network, test_manager, dev_gen, start(test_manager), 0.0, config["TEST_NUM_STEPS"], greedy=True
            )
            return episode_mean_metrics(infos, seeds, group)

        test_metrics = get_test_metrics() if test_during_training else {}
        # the random-policy prefill stores its rewards unscaled (pqn_vdn.py:515-520)
        carry, memory, _ = vdn_rollout(network, manager, dev_gen, start(manager), 1.0, memory_len, 1.0)
        history = []
        for _ in range(config["NUM_UPDATES"]):
            eps = eps_scheduler(train_state.n_updates)
            carry, transitions, infos = vdn_rollout(network, manager, dev_gen, carry, eps, n_steps, rew_scale)
            train_state.timesteps += n_steps * n_envs * timestep_scale
            memory = map_transitions(lambda old, new: torch.cat([old[n_steps:], new]), memory, transitions)
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
            metrics.update({k: seed_mean(v.float(), seeds, 1) for k, v in infos.items()})
            metrics = group_mean_metrics(metrics, group)
            if test_during_training:
                metrics.update({f"test/{k}": v for k, v in test_metrics.items()})
            if callback is not None and train_state.n_updates % log_interval == 0:
                emit_metric_rows(callback, metrics, seeds, last_seed_first=True)
            if collect_metrics:
                history.append(metrics)

        return {
            "runner_state": (train_state, memory, carry, test_metrics),
            "metrics": stack_metrics(history, seeds),
        }

    return train
