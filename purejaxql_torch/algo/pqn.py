"""FF-PQN trainer for feedforward Q-networks.

Port of purejaxql_tpu/algo/pqn.py `make_train` for the MLP QNetwork
(CartPole-v1, and the craftax family's ``pqn_craftax`` on Forager) and the
MinAtar CNN (Asterix-, Breakout-, Freeway-, Seaquest- and
SpaceInvaders-MinAtar). Each update: a NUM_STEPS rollout over NUM_ENVS envs
(epsilon-greedy on the current params), Q(lambda) targets, NUM_EPOCHS epochs
of NUM_MINIBATCHES minibatch steps of clip + RAdam on the 0.5 * MSE TD loss,
the update metrics, and every TEST_INTERVAL of the run a greedy eval.

With Q_LAMBDA=False (the craftax family) the targets are 1-step TD,
computed inside each minibatch step, in one of two forms:

- the concat form (pqn.py:515-534): one train-mode forward on
  cat(obs, next_obs), so the batch norms' statistics (and a BatchRenorm's
  step count) run once over both halves (``learn_minibatch_td``);
- FAST_TARGETS (pqn.py:459-503, NORM_TYPE layer_norm only): first a
  no-grad train-mode forward on next_obs with the pre-step statistics,
  its statistics update discarded, for the targets; then the loss's
  train-mode forward on obs alone, whose update is kept
  (``learn_minibatch_fast_td``).

No returns kernel runs. SKIP_NOOP_PERMUTE (default FAST_TARGETS's value)
leaves the rows of a single minibatch in rollout order (pqn.py:556-566):
the permutation is still drawn, so every other random number of the run is
the one it would be, and only the gradients' summation order changes.
DONE_MASKED_INFO_METRICS averages the env infos over the steps that end an
episode (pqn.py:601-610).

Envs (``build_env``, pqn.py:50-107): the Log-wrapped env ("split" mode), or
in the batched modes that env inside ``OptimisticResetVecEnv``
(USE_OPTIMISTIC_RESETS, with OPTIMISTIC_RESET_RATIO; with RESET_BANK > 0
the training env is ``BankedResetVecEnv``, its fresh worlds served from a
bank refreshed every RESET_BANK_REFRESH_EVERY steps) or ``BatchEnv``
(BATCH_ENV); with ARCH ``mlp`` (or FLATTEN_OBS) an image observation is
flattened under Log (``FlattenObservation``, pqn.py:64-68). BF16_COMPUTE
gives the network a bfloat16 trunk over float32 parameters
(``models/factory.py``); a fused rollout kernel reads the float32
parameters, as the JAX package's does.

Where the JAX package scans, this trainer loops in Python; it keeps host
syncs out of the update loop: counters and schedules are host integers and
floats, metrics stay device tensors and are stacked once at the end. The
only sync is the fused eval's early-exit test, once per chunk (and with
LOG_VIA_CALLBACK one copy to the host a logged update). With
COLLECT_METRICS=False (pqn.py:260, 638) no metrics are returned and the
work that only feeds them is skipped (the fused rollout's Log replay, the
unfused rollout's info stacks, the losses' means, the per-update dicts)
unless LOG_VIA_CALLBACK asks for them; the eval still runs, as its draws
and the runner state's test metrics follow the JAX trainer, so the params
are those of the same run with the metrics on.

Two rollout paths:

- unfused (pqn.py:321-340): network forward, epsilon-greedy and the env
  step, one env step at a time; EXPLORATION_KERNEL="pallas" takes the
  actions from the epsilon-greedy kernel (``algo/exploration.py:
  make_eps_greedy``, ``ops/eps_greedy.py``), else from `eps_greedy_batch`;
- FUSED_ROLLOUT (pqn.py:342-406): the whole rollout in one launch of the
  game's kernel (`fused_game_rollout`: ops/cartpole_rollout.py and the
  MinAtar games' ops/<game>_rollout.py), with the Log wrapper's episode
  statistics replayed from the (reward, done) streams afterwards, summed in
  step order as the JAX trainer sums them (Seaquest's rewards are not
  integers).

The lambda targets always go through `ops.lambda_returns.lambda_returns`,
the CUDA kernel on the GPU; PALLAS_RETURNS is accepted and changes nothing.
The eval's epsilon-greedy is `eps_greedy_batch`, as the JAX trainer's.

Line references ``pqn.py:N`` in this module are to purejaxql_tpu/algo/pqn.py.

Randomness comes from two generators seeded from SEED: a host generator
(parameter init, kernel seeds) and one on the run's device (env resets,
exploration, minibatch permutations). Parameters are initialised on the
host, so a CPU and a GPU run start from the same weights.

NUM_SEEDS = S > 1 trains S seeds as one program on the unfused rollout
(``algo/seeds.py``: the stacked network, seed-major folded envs, each
seed's own loss mean, clip, row permutation and metrics), what
``jax.vmap(make_train(config))`` computes; every metric is then (S,
NUM_UPDATES). The craftax family runs so too: each seed's reset pool or
bank (``build_env``), its stacked BatchRenorm (FAST_TARGETS' bootstrap
under its frozen statistics), SKIP_NOOP_PERMUTE and the done-masked metrics
per seed, every action of the S x NUM_ENVS rows from one epsilon-greedy
launch; BF16_COMPUTE too. FUSED_ROLLOUT is refused with seeds, as by the
JAX CLI.

With a process ``group`` (``make_train(group=...)``, pqn.py:174-198's
``pmap_axis``) the trainer is one rank of a sharded run
(parallel/spmd.py): NUM_ENVS is the rank's envs; every rank builds the
same network from SEED, then draws from generators of its own
(``algo/seeds.py:run_generators``, pqn.py:298-303); the gradients
(``core/optim.py``), the batch norms' statistics (``models/factory.py``)
and the update's metrics (``algo/metrics.py:group_mean_metrics``) are
meaned over the group and the eval's episodes summed over it, one
all-reduce each; the rollouts, targets and shuffles stay rank-local.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from purejaxql_torch.algo.exploration import draw_seed, eps_greedy_batch, make_eps_greedy
from purejaxql_torch.algo.seeds import (
    check_group_seeds,
    check_seeds,
    run_generators,
    seed_generators,
    seed_mean,
    seed_minibatches,
    seed_permutations,
    seed_rows,
    seed_sum,
    take_rows,
)
from purejaxql_torch.algo.metrics import (
    apply_eval_subsample,
    emit_metric_rows,
    episode_mean_metrics,
    eval_episode_metrics,
    group_mean_metrics,
    metric_callback,
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
from purejaxql_torch.models.qnet import frozen_statistics
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

# games whose kernel, as its TPU kernel, keeps its env params built in but
# max_steps: the CartPole physics, Asterix's cadences and `ramping`,
# SpaceInvaders' cooldowns and reset march interval, Seaquest's six
# (pallas_rollout.py:469-472, 860, 1473-1474, 2031-2037); the Breakout and
# Freeway kernels take all of their env's params
_BUILT_IN_PARAMS = ("CartPole-v1", "Asterix-MinAtar", "SpaceInvaders-MinAtar", "Seaquest-MinAtar")


def fused_ff_eligible(config: Dict[str, Any]) -> bool:
    """The configs the FF trainer's fused rollout runs, which the cuda
    policy (core/config.py) fuses and ``_check_supported`` accepts: the
    split env mode (no USE_OPTIMISTIC_RESETS, so no RESET_BANK, and no
    BATCH_ENV: pqn.py:249), a game
    with a rollout kernel, layer_norm and NORM_INPUT=False, CartPole with a
    2-layer MLP, a MinAtar game with the MinAtar CNN on its planes (ARCH
    unset or ``cnn``, no FLATTEN_OBS), and for a game whose kernel keeps its
    env params built in, no ENV_KWARGS but max_steps_in_episode, which every
    kernel takes."""
    env_name = config.get("ENV_NAME")
    return (
        env_name in FUSED_GAMES
        and not config.get("USE_OPTIMISTIC_RESETS", False)
        and not config.get("BATCH_ENV", False)
        and config.get("NORM_TYPE") == "layer_norm"
        and not config.get("NORM_INPUT", False)
        and (env_name != "CartPole-v1" or config.get("NUM_LAYERS", 2) == 2)
        and (env_name == "CartPole-v1"
             or (config.get("ARCH") in (None, "cnn") and not config.get("FLATTEN_OBS", False)))
        and (env_name not in _BUILT_IN_PARAMS
             or set(config.get("ENV_KWARGS") or {}) <= {"max_steps_in_episode"})
    )


def _check_supported(config: Dict[str, Any]) -> None:
    if str(config.get("ALG_NAME", "pqn")) not in ("pqn", "pqn_craftax"):
        raise NotImplementedError(f"ALG_NAME '{config.get('ALG_NAME')}' is not an FF-PQN config")
    check_seeds(config)
    if config.get("FAST_TARGETS", False) and config.get("NORM_TYPE") != "layer_norm":
        raise ValueError(
            "FAST_TARGETS requires NORM_TYPE=layer_norm (the out-of-grad target forward "
            "cannot replicate the batch-stats update of the concat forward)"
        )
    if config.get("FUSED_ROLLOUT", False) and not fused_ff_eligible(config):
        raise ValueError(
            "FUSED_ROLLOUT supports the split env mode (no USE_OPTIMISTIC_RESETS or "
            "BATCH_ENV) with CartPole-v1 with a 2-layer MLP and the MinAtar "
            "games Asterix, Breakout, Freeway, Seaquest and SpaceInvaders with the MinAtar "
            "CNN on their planes (ARCH unset or cnn, no FLATTEN_OBS), all with layer_norm and NORM_INPUT=False; for CartPole, Asterix, "
            "Seaquest and SpaceInvaders no ENV_KWARGS but max_steps_in_episode (their "
            "kernels keep the other env params built in): ops/cartpole_rollout.py, "
            "ops/<game>_rollout.py"
        )


def build_env(config: Dict[str, Any]):
    """``(train_env, test_env, env, env_params)`` (pqn.py:50-107): the env
    of the config, inside ``FlattenObservation`` where FLATTEN_OBS asks for
    it (by default for an MLP, ARCH ``mlp``) and its observations are not
    flat already (pqn.py:64-68), wrapped in Log ("split"
    mode), or that inside ``OptimisticResetVecEnv``
    (USE_OPTIMISTIC_RESETS) or ``BatchEnv`` (BATCH_ENV) at NUM_ENVS for
    training and TEST_NUM_ENVS for the eval; with RESET_BANK > 0 the
    training env is ``BankedResetVecEnv`` (pqn.py:72-86) and the eval's
    stays optimistic. ``env`` is the env under Log. With NUM_SEEDS = S > 1
    the batched modes hold S seed-major blocks of envs, each with its own
    reset pool or bank (``seeds=S``), and BATCH_ENV S times the envs.
    Shared with the recurrent trainer."""
    env_kwargs = dict(config.get("ENV_KWARGS") or {})
    if config.get("LOG_ACHIEVEMENTS", False):
        env_kwargs["log_achievements"] = True
    env, env_params = make_env(config["ENV_NAME"], **env_kwargs)
    obs_shape = env.observation_space(env_params).shape
    if config.get("FLATTEN_OBS", config.get("ARCH") == "mlp") and len(obs_shape) > 1:
        env = wrappers.FlattenObservation(env)
    log_env = wrappers.Log(env)
    n_train, n_test = config["NUM_ENVS"], config["TEST_NUM_ENVS"]
    seeds = config.get("NUM_SEEDS", 1)
    if config.get("USE_OPTIMISTIC_RESETS", False):
        ratio = config["OPTIMISTIC_RESET_RATIO"]
        test_env = wrappers.OptimisticResetVecEnv(log_env, n_test, min(ratio, n_test), seeds)
        if config.get("RESET_BANK", 0):
            train_env = wrappers.BankedResetVecEnv(
                log_env, n_train, min(ratio, n_train), int(config["RESET_BANK"]),
                int(config.get("RESET_BANK_REFRESH_EVERY", 16)), seeds,
            )
        else:
            train_env = wrappers.OptimisticResetVecEnv(log_env, n_train, min(ratio, n_train), seeds)
        return train_env, test_env, env, env_params
    if config.get("BATCH_ENV", False):
        return (wrappers.BatchEnv(log_env, seeds * n_train), wrappers.BatchEnv(log_env, seeds * n_test), env,
                env_params)
    return log_env, log_env, env, env_params


def stack_metrics(history, seeds: int = 1):
    """The per-update metric dicts as one tensor per metric, (NUM_UPDATES,),
    or with seeds (S, NUM_UPDATES) from (S,) values, the host counters
    repeated for every seed: device tensors stack on the device, host
    counters on the host."""
    stacked = {}
    for k in history[0] if history else {}:
        values = [m[k] for m in history]
        if torch.is_tensor(values[0]):
            stacked[k] = torch.stack(values, -1)
        else:
            stacked[k] = torch.tensor(values) if seeds == 1 else torch.tensor(values).repeat(seeds, 1)
    return stacked


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


def _td_step(optimizer: ClipRAdam, q_vals: torch.Tensor, action: torch.Tensor, target: torch.Tensor):
    """The 0.5 * MSE TD loss on the taken actions and clip + RAdam on every
    parameter (zero gradients for the unused ones, as jax.grad gives); with
    seeds (the optimizer's) the sum over seeds of each seed's mean over its
    seed-major rows. Returns the loss, (S,) with seeds, and the chosen
    Q-values, detached."""
    chosen = q_vals.gather(1, action[:, None]).squeeze(1)
    loss = seed_mean(0.5 * torch.square(chosen - target), optimizer.seeds)
    grads = torch.autograd.grad(
        loss.sum(), optimizer.params, allow_unused=True, materialize_grads=True
    )
    optimizer.step(grads)
    return loss.detach(), chosen.detach()


def learn_minibatch(
    network: torch.nn.Module,
    optimizer: ClipRAdam,
    obs: torch.Tensor,
    action: torch.Tensor,
    target: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One minibatch step on given targets (pqn.py:492-553): a train-mode
    forward (the batch norms update their running statistics, even the
    unused input norm), then ``_td_step``."""
    return _td_step(optimizer, network(obs, train=True), action, target)


def learn_minibatch_td(
    network: torch.nn.Module,
    optimizer: ClipRAdam,
    obs: torch.Tensor,
    action: torch.Tensor,
    next_obs: torch.Tensor,
    reward: torch.Tensor,
    done: torch.Tensor,
    gamma: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One minibatch step of 1-step TD (pqn.py:515-534): one train-mode
    forward on cat(obs, next_obs), so the batch norms' statistics (and a
    BatchRenorm's step count) run once over both halves; the target
    r + (1 - done) * gamma * max_a Q(s', a) with Q(s') detached; then
    ``_td_step``. With seeds each seed's forward rows are its obs, then
    its next_obs."""
    S = optimizer.seeds
    both = torch.cat([obs.unflatten(0, (S, -1)), next_obs.unflatten(0, (S, -1))], 1).flatten(0, 1)
    q_vals, q_next = (q.flatten(0, 1) for q in network(both, train=True).unflatten(0, (S, -1)).chunk(2, 1))
    target = reward + (1 - done.float()) * gamma * q_next.detach().max(-1).values
    return _td_step(optimizer, q_vals, action, target)


def learn_minibatch_fast_td(
    network: torch.nn.Module,
    optimizer: ClipRAdam,
    obs: torch.Tensor,
    action: torch.Tensor,
    next_obs: torch.Tensor,
    reward: torch.Tensor,
    done: torch.Tensor,
    gamma: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One minibatch step of 1-step TD with FAST_TARGETS (pqn.py:459-503):
    the target r + (1 - done) * gamma * max_a Q(s', a) from a no-grad
    train-mode forward on next_obs alone, with the statistics as they were
    before the step and their update discarded (so an input norm
    normalizes next_obs by its own batch moments); then ``_td_step`` on a
    train-mode forward on obs alone, whose statistics update is kept: one
    update of the statistics (one BatchRenorm step) a grad step."""
    with torch.no_grad(), frozen_statistics(network):
        q_next = network(next_obs, train=True).max(-1).values
    target = reward + (1 - done.float()) * gamma * q_next
    return _td_step(optimizer, network(obs, train=True), action, target)


def make_train(
    config: Dict[str, Any], device: Optional[str] = None, logger=None, group=None
) -> Callable[..., Dict[str, Any]]:
    """Build ``train(seed=None, runner_state=None) -> {"runner_state",
    "metrics"}``; with a process ``group``, one rank's trainer of a sharded
    run (the module's docstring), one seed a rank.

    ``device`` defaults to the config's DEVICE key, else ``cuda``; a missing
    GPU raises. ``metrics`` maps each metric name to a tensor of shape
    (NUM_UPDATES,), (NUM_SEEDS, NUM_UPDATES) with seeds, and is empty with
    COLLECT_METRICS=False; ``runner_state`` is (train_state, (obs,
    env_state), test_metrics, (host generator, device generator)), the envs
    seed-major with seeds. Given a ``runner_state`` from an earlier call,
    ``train`` continues that run for NUM_UPDATES more updates (pqn.py:
    271-278, 767-780): no new network, reset or first eval, and the
    schedules follow the carried counters, so that segments of a run
    (algo/segmented.py) draw what the whole run draws.

    With LOG_VIA_CALLBACK and a ``logger`` (utils/logging.py), every update
    whose count is a multiple of LOG_INTERVAL hands its metrics, once a seed,
    to ``logger.make_callback()`` (pqn.py:627-634), COLLECT_METRICS=False
    or not.
    """
    config = derive_pqn_schedule_keys(apply_eval_subsample(dict(config)))
    _check_supported(config)
    check_group_seeds(config, group)
    seeds = config.get("NUM_SEEDS", 1)
    device = resolve_device(device if device is not None else config.get("DEVICE"))

    train_env, test_env, env, env_params = build_env(config)
    config.setdefault("TEST_NUM_STEPS", env_params.max_steps_in_episode)
    action_dim = env.action_space(env_params).n
    obs_shape = env.observation_space(env_params).shape

    n_envs, n_steps = config["NUM_ENVS"], config["NUM_STEPS"]
    n_minibatches, n_epochs = config["NUM_MINIBATCHES"], config["NUM_EPOCHS"]
    rew_scale = config.get("REW_SCALE", 1.0)
    timestep_scale = config.get("TIMESTEP_SCALE", 1)
    use_fused = config.get("FUSED_ROLLOUT", False)
    use_q_lambda = config.get("Q_LAMBDA", True)
    fast_targets = config.get("FAST_TARGETS", False)
    # one minibatch: its rows in rollout order (pqn.py:564-566)
    skip_permute = n_minibatches == 1 and config.get("SKIP_NOOP_PERMUTE", fast_targets)
    done_masked = config.get("DONE_MASKED_INFO_METRICS", False)
    collect_metrics = config.get("COLLECT_METRICS", True)
    callback = metric_callback(config, logger)
    log_interval = config.get("LOG_INTERVAL", 1)
    # the metrics are computed for the callback too, as JAX computes them
    # regardless and only drops them from the output (pqn.py:626-638)
    need_metrics = collect_metrics or callback is not None
    test_during_training = config.get("TEST_DURING_TRAINING", False)
    eps_scheduler = epsilon_schedule(
        config["EPS_START"],
        config["EPS_FINISH"],
        config["EPS_DECAY"] * config["NUM_UPDATES_DECAY"],
    )

    def train(seed: Optional[int] = None, runner_state=None) -> Dict[str, Any]:
        if runner_state is None:
            gens = seed_generators(config["SEED"] if seed is None else seed, seeds)
            host_gen = gens[0]
            network = make_q_network(config, action_dim, obs_shape, generator=gens if seeds > 1 else host_gen,
                                     seeds=seeds, group=group)
            network = network.to(device)
            host_gen, dev_gen = run_generators(host_gen, device, group)
            optimizer = make_optimizer(
                network.parameters(), config["MAX_GRAD_NORM"], lr_schedule(config), seeds, group
            )
            train_state = PQNTrainState(network, optimizer)
        else:
            train_state, (obs, log_state), test_metrics, (host_gen, dev_gen) = runner_state
            network, optimizer = train_state.network, train_state.optimizer
        env_name = config["ENV_NAME"]
        explore = make_eps_greedy(config, dev_gen, host_gen)

        def rollout(obs, log_state):
            eps = eps_scheduler(train_state.n_updates)
            if use_fused:
                obs_seq, act, rew, done_i, q_seq, final_obs, env_state = fused_game_rollout(
                    env_name, draw_seed(host_gen), eps, fused_weights(env_name, network),
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
                infos = None
                if need_metrics:
                    log_state, infos = log_replay(log_state, rew, done)
                log_state.env_state = env_state
                return final_obs, log_state, transitions, infos

            steps = []
            with torch.no_grad():
                for _ in range(n_steps):
                    q_vals = network(obs, train=False)
                    action = explore(q_vals, eps)
                    new_obs, log_state, reward, done, info = train_env.step(
                        dev_gen, log_state, action, env_params
                    )
                    steps.append((obs, action, rew_scale * reward, done, new_obs, q_vals, info))
                    obs = new_obs
            fields = list(zip(*steps))
            transitions = Transition(*(torch.stack(f) for f in fields[:6]))
            infos = {k: torch.stack([i[k] for i in fields[6]]) for k in fields[6][0]} if need_metrics else None
            return obs, log_state, transitions, infos

        def learn(transitions, targets):
            # the lambda targets, or for 1-step TD the fields its targets come from
            n = n_steps * n_envs
            leaves = (
                (transitions.obs, transitions.action, targets) if use_q_lambda else
                (transitions.obs, transitions.action, transitions.next_obs, transitions.reward, transitions.done)
            )
            leaves = [seed_rows(x, seeds) for x in leaves]  # each seed's n rows, (S, n, ...)
            losses, qvals = [], []
            for _ in range(n_epochs):
                # one permutation per epoch and seed, shared by every leaf;
                # with skip_permute it is drawn all the same, so the device
                # generator moves as without the flag
                perm = seed_permutations(dev_gen, seeds, n, device)
                batches = zip(*(
                    seed_minibatches(x if skip_permute else take_rows(x, perm), n_minibatches) for x in leaves
                ))
                for mb in batches:
                    if use_q_lambda:
                        loss, chosen = learn_minibatch(network, optimizer, *mb)
                    elif fast_targets:
                        loss, chosen = learn_minibatch_fast_td(network, optimizer, *mb, config["GAMMA"])
                    else:
                        loss, chosen = learn_minibatch_td(network, optimizer, *mb, config["GAMMA"])
                    train_state.grad_steps += 1
                    losses.append(loss)
                    qvals.append(chosen)
            if not need_metrics:
                return None, None
            return seed_mean(torch.stack(losses), seeds, -1), seed_mean(torch.stack(qvals), seeds, 1)

        @torch.no_grad()
        def get_test_metrics() -> Dict[str, torch.Tensor]:
            n_test = seeds * config["TEST_NUM_ENVS"]
            n_test_steps = config["TEST_NUM_STEPS"]
            _, test_state = test_env.reset(dev_gen, n_test, env_params)
            if use_fused:
                # the greedy rollout through the same kernel in NUM_STEPS
                # chunks; with EVAL_EARLY_EXIT it stops once every env has
                # finished an episode, and unexecuted steps count as not done
                chunk = n_steps
                n_chunks = -(-n_test_steps // chunk)
                seed0 = draw_seed(host_gen)
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
                return eval_episode_metrics(rews, dones.float(), group)

            obs, state = test_env.reset(dev_gen, n_test, env_params)
            infos = []
            for _ in range(n_test_steps):
                q_vals = network(obs, train=False)
                action = eps_greedy_batch(dev_gen, q_vals, config["EPS_TEST"])
                obs, state, _, _, info = test_env.step(dev_gen, state, action, env_params)
                infos.append(info)
            return episode_mean_metrics(
                {k: torch.stack([i[k] for i in infos]) for k in infos[0]}, seeds, group
            )

        if runner_state is None:
            test_metrics = get_test_metrics() if test_during_training else {}
            obs, log_state = train_env.reset(dev_gen, seeds * n_envs, env_params)
        history = []
        for _ in range(config["NUM_UPDATES"]):
            obs, log_state, transitions, infos = rollout(obs, log_state)
            train_state.timesteps += n_steps * n_envs * timestep_scale

            targets = None
            if use_q_lambda:
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
                emit_metric_rows(callback, metrics, seeds)
            if collect_metrics:
                history.append(metrics)

        return {
            "runner_state": (train_state, (obs, log_state), test_metrics, (host_gen, dev_gen)),
            "metrics": stack_metrics(history, seeds),
        }

    return train
