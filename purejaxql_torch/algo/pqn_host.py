"""FF-PQN over host (C++) environments: the EnvPool/Atari-style path.

Port of purejaxql_tpu/algo/pqn_host.py (``make_train``, the synchronous
trainer, and ``make_train_async``, ASYNC_ENVS). The envs are the C++ pool
of ``envs/hostpool.py`` (CartPole-v1, Acrobot-v1, the five MinAtar games
natively, Pong-EH / PongRam-EH / Breakout-EH / BreakoutRam-EH as plug-ins),
stepped on the host CPU; the network, the epsilon-greedy kernel, the
closure lambda-returns kernel and the learn phase run on the device.
Line references ``pqn_host.py:N`` are to the JAX module.

One update (pqn_host.py:119-303):

- a NUM_STEPS rollout of NUM_ENVS + TEST_ENVS envs (``host_rollout``):
  each step the policy forward on the device, the actions of the NUM_ENVS
  training rows from ``algo/exploration.py:make_eps_greedy`` (on the GPU
  the epsilon-greedy kernel, by the cuda policy) and those of the
  TEST_ENVS greedy rows an argmax (the JAX trainer gives them eps 0,
  pqn_host.py:133-141, and at eps 0 the kernel's coin never falls below
  eps: its action is the argmax); the actions to the host through a pinned
  buffer, ``pool.step_into`` into pinned buffers, the obs back to the
  device with a non-blocking copy; rewards and dones once a rollout;
- the episode statistics of every env on the host (``EpisodeStats``,
  pqn_host.py:150-158; ``ret_l`` an integer), from the raw rewards;
- ``learn_update``: the closure lambda targets
  (``ops/lambda_returns.py:lambda_returns_closure``, the kernel on the GPU)
  from the REW_SCALE-scaled rewards and the recorded max-Q of the training
  rows, bootstrapped from ``last_q`` of the training envs' last obs
  (pqn_host.py:196-203); then NUM_EPOCHS x NUM_MINIBATCHES TD steps, one
  permutation an epoch shared by obs, actions and targets
  (pqn_host.py:238-249). The test envs are stripped from the learn batch
  and ``timesteps`` counts the training envs only.

The network is ``models/factory.py:make_q_network``'s: the MinAtar CNN, or
with CNN_TRUNK=nature the Nature CNN, with any NORM_TYPE (a batch-stat
trunk's statistics move in the learn phase's train-mode forwards; the
rollout reads them in eval mode) and BF16_COMPUTE.

Only the training rows' obs stream is kept on the device, not JAX's
``next_obs`` copy of it: the closure targets need the last obs alone.

``make_train_async`` is the lag-1 double-buffered trainer
(pqn_host.py:306-597): a worker thread steps the pool for batch u + 1 while
the main thread learns on batch u. The worker acts through a network of
its own whose parameters and buffers (the running statistics,
pqn_host.py:374-376) are a snapshot of the learner's after exactly u
updates, copied on the learner's stream before batch u's learn
launches (PyTorch steps parameters in place, so acting through the
learner's module would read them half updated); on the GPU its forwards
run on a stream of their own, ordered after that copy by an event, and it
draws from generators of its own. Buffers alternate between two sets; a
set is refilled only after the learn phase that read it was launched. A
worker that dies raises in the main thread (pqn_host.py:528-535).

Randomness: the parameters from a host generator seeded SEED, then a
device generator (exploration without the kernel, permutations) and, in
the async trainer, the worker's own host and device generators, all seeded
from it. Single-seed: NUM_SEEDS > 1 is refused (``algo/seeds.py``), as the
JAX CLI refuses it.
"""

from __future__ import annotations

import contextlib
import copy
import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from purejaxql_torch.algo.exploration import draw_seed, make_eps_greedy
from purejaxql_torch.algo.pqn import learn_minibatch, stack_metrics
from purejaxql_torch.algo.seeds import check_seeds
from purejaxql_torch.core.config import derive_pqn_schedule_keys
from purejaxql_torch.core.optim import make_optimizer
from purejaxql_torch.core.schedules import epsilon_schedule, lr_schedule
from purejaxql_torch.core.train_state import PQNTrainState
from purejaxql_torch.envs.hostpool import HostEnvPool
from purejaxql_torch.models.factory import make_q_network
from purejaxql_torch.ops.lambda_returns import lambda_returns_closure
from purejaxql_torch.utils.atari_scores import ATARI_SCORES
from purejaxql_torch.utils.platform import resolve_device


@dataclass
class HostBuffers:
    """One rollout's buffers. Host (pinned on the GPU): ``obs_pin`` the
    pool's obs (E_total, obs_dim), ``act_pin`` its actions (E_total,) int32,
    ``rew_pin`` and ``done_pin`` (T, E_total) float32 and uint8. Device:
    ``cur`` the obs the policy acts on, after the rollout the last obs;
    ``obs`` the training rows' obs stream (T, E, obs_dim); ``action`` their
    actions (T, E); ``q_val`` every row's Q-values (T, E_total, A);
    ``reward`` and ``done`` (T, E_total), raw."""

    obs_pin: torch.Tensor
    act_pin: torch.Tensor
    rew_pin: torch.Tensor
    done_pin: torch.Tensor
    cur: torch.Tensor
    obs: torch.Tensor
    action: torch.Tensor
    q_val: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor

    @classmethod
    def allocate(cls, pool: HostEnvPool, n_steps: int, n_train: int, device: torch.device) -> "HostBuffers":
        pin = device.type == "cuda"
        n, d = pool.num_envs, pool.obs_dim

        def host(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, pin_memory=pin)

        def dev(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device=device)

        return cls(
            obs_pin=host(n, d), act_pin=host(n, dtype=torch.int32), rew_pin=host(n_steps, n),
            done_pin=host(n_steps, n, dtype=torch.uint8), cur=dev(n, d), obs=dev(n_steps, n_train, d),
            action=dev(n_steps, n_train, dtype=torch.int64), q_val=dev(n_steps, n, pool.num_actions),
            reward=dev(n_steps, n), done=dev(n_steps, n, dtype=torch.uint8),
        )


class EpisodeStats:
    """Every env's running episode return and length and those of its last
    finished episode, on the host (pqn_host.py:150-158, 478-486): float32
    returns, int32 lengths."""

    def __init__(self, n_envs: int):
        self.ep_r = np.zeros(n_envs, np.float32)
        self.ep_l = np.zeros(n_envs, np.int32)
        self.ret_r = np.zeros(n_envs, np.float32)
        self.ret_l = np.zeros(n_envs, np.int32)

    def update(self, rewards: np.ndarray, dones: np.ndarray) -> None:
        """Replay a rollout's (T, E_total) raw rewards and 0/1 dones in step order."""
        for reward, done in zip(rewards, dones.astype(bool)):
            ner, nel = self.ep_r + reward, self.ep_l + 1
            self.ret_r = np.where(done, ner, self.ret_r)
            self.ret_l = np.where(done, nel, self.ret_l)
            self.ep_r = np.where(done, np.float32(0), ner)
            self.ep_l = np.where(done, 0, nel).astype(np.int32)


class _Setup:
    """What both trainers derive from the config and the pool."""

    def __init__(self, config: Dict[str, Any], pool: Optional[HostEnvPool], device):
        self.config = config = derive_pqn_schedule_keys(dict(config))
        check_seeds(config)
        self.device = resolve_device(device if device is not None else config.get("DEVICE"))
        self.test_envs = int(config.get("TEST_ENVS", 0)) if config.get("TEST_DURING_TRAINING", False) else 0
        self.n_train = config["NUM_ENVS"]
        total = self.n_train + self.test_envs
        self.pool = pool if pool is not None else HostEnvPool(config["ENV_NAME"], num_envs=total,
                                                              seed=config.get("SEED", 0))
        if self.pool.num_envs != total:
            raise ValueError(f"the pool has {self.pool.num_envs} envs, the config NUM_ENVS + TEST_ENVS = {total}")
        # human-normalized scores when the game is in the published table
        # (pqn_host.py:75-80)
        self.norm_scores = ATARI_SCORES.get(config.get("SCORE_GAME", config["ENV_NAME"]))
        self.obs_shape = self.pool.obs_shape
        self.eps_scheduler = epsilon_schedule(
            config["EPS_START"], config["EPS_FINISH"], config["EPS_DECAY"] * config["NUM_UPDATES_DECAY"]
        )

    def agent(self, seed: Optional[int]):
        """(train state, host generator, device generator): the network
        drawn on the host from SEED (or ``seed``) and moved to the device."""
        config = self.config
        host_gen = torch.Generator().manual_seed(config["SEED"] if seed is None else seed)
        network = make_q_network(config, self.pool.num_actions, self.obs_shape, generator=host_gen).to(self.device)
        dev_gen = torch.Generator(device=self.device).manual_seed(draw_seed(host_gen))
        optimizer = make_optimizer(network.parameters(), config["MAX_GRAD_NORM"], lr_schedule(config))
        return PQNTrainState(network, optimizer), host_gen, dev_gen

    def test_metrics(self, stats: EpisodeStats) -> Dict[str, float]:
        """The TEST_ENVS rows' returns and lengths and the human-normalized
        score (pqn_host.py:275-286)."""
        if not self.test_envs:
            return {}
        test_ret = float(stats.ret_r[self.n_train:].mean())
        out = {
            "test/returned_episode_returns": test_ret,
            "test/returned_episode_lengths": float(stats.ret_l[self.n_train:].astype(np.float32).mean()),
        }
        if self.norm_scores is not None:
            rand_s, human_s = self.norm_scores
            out["test/human_normalized_score"] = (test_ret - rand_s) / (human_s - rand_s)
        return out


def reset_pool(pool: HostEnvPool, bufs: HostBuffers) -> None:
    """Reset every env, outside the update loop (pqn_host.py:110-111), into
    ``bufs.cur``."""
    pool.reset_into(bufs.obs_pin.numpy())
    bufs.cur.copy_(bufs.obs_pin, non_blocking=True)


def _wait(device: torch.device) -> None:
    """Wait for the current stream's work so far (a device-to-host copy)."""
    if device.type == "cuda":
        event = torch.cuda.Event()
        event.record()
        event.synchronize()


@torch.no_grad()
def host_rollout(
    pool: HostEnvPool,
    network: torch.nn.Module,
    explore: Callable[[torch.Tensor, float], torch.Tensor],
    eps: float,
    bufs: HostBuffers,
    n_train: int,
) -> None:
    """NUM_STEPS steps of every env of the pool from the obs in ``bufs.cur``
    under ``network``, on the current stream: the first ``n_train`` rows
    epsilon-greedy at ``eps`` (``explore``), the rest greedy. Fills
    ``bufs``; the host buffers are final on return, the device ones once
    the stream's work is done."""
    obs_shape = pool.obs_shape
    act_np, obs_np = bufs.act_pin.numpy(), bufs.obs_pin.numpy()
    rew_np, done_np = bufs.rew_pin.numpy(), bufs.done_pin.numpy()
    for t in range(bufs.reward.shape[0]):
        q_vals = network(bufs.cur.view(-1, *obs_shape), train=False)
        bufs.q_val[t] = q_vals
        bufs.obs[t] = bufs.cur[:n_train]
        train_actions = explore(q_vals[:n_train], eps)
        bufs.action[t] = train_actions
        actions = torch.cat([train_actions, q_vals[n_train:].argmax(-1)]).to(torch.int32)
        bufs.act_pin.copy_(actions, non_blocking=True)
        _wait(bufs.cur.device)  # the actions are on the host; so is every earlier copy from obs_pin done
        pool.step_into(act_np, obs_np, rew_np[t], done_np[t])
        bufs.cur.copy_(bufs.obs_pin, non_blocking=True)
    bufs.reward.copy_(bufs.rew_pin, non_blocking=True)
    bufs.done.copy_(bufs.done_pin, non_blocking=True)


def learn_update(
    train_state: PQNTrainState,
    bufs: HostBuffers,
    n_train: int,
    obs_shape,
    config: Dict[str, Any],
    generator: torch.Generator,
) -> torch.Tensor:
    """One update's learn phase on a rollout's buffers (pqn_host.py:186-262,
    410-491): the closure lambda targets of the training rows, bootstrapped
    with the learner's own network from their last obs, then NUM_EPOCHS x
    NUM_MINIBATCHES TD steps. Returns the mean loss (a device scalar)."""
    network, optimizer = train_state.network, train_state.optimizer
    n_steps = bufs.reward.shape[0]
    with torch.no_grad():
        last_q = network(bufs.cur[:n_train].view(n_train, *obs_shape), train=False).max(-1).values
        targets = lambda_returns_closure(
            last_q,
            config.get("REW_SCALE", 1.0) * bufs.reward[:, :n_train],
            bufs.done[:, :n_train].float(),
            bufs.q_val[:, :n_train].max(-1).values,
            config["GAMMA"],
            config["LAMBDA"],
        )
    obs = bufs.obs.view(n_steps * n_train, *obs_shape)
    action, targets = bufs.action.view(-1), targets.view(-1)
    n = obs.shape[0]
    size = n // config["NUM_MINIBATCHES"]
    losses = []
    for _ in range(config["NUM_EPOCHS"]):
        perm = torch.randperm(n, generator=generator, device=obs.device)
        for m in range(config["NUM_MINIBATCHES"]):
            idx = perm[m * size:(m + 1) * size]
            loss, _ = learn_minibatch(network, optimizer, obs[idx], action[idx], targets[idx])
            train_state.grad_steps += 1
            losses.append(loss)
    return torch.stack(losses).mean()


def make_train(config: Dict[str, Any], pool: Optional[HostEnvPool] = None, device=None):
    """Build the synchronous ``train(seed=None) -> {"runner_state",
    "metrics"}`` over a host pool (pqn_host.py:36-303). ``device`` defaults
    to the config's DEVICE key, else ``cuda``. ``metrics`` maps each of
    pqn_host.py:264-286's keys to a (NUM_UPDATES,) tensor; ``runner_state``
    is (train_state, last obs on the device, EpisodeStats)."""
    setup = _Setup(config, pool, device)
    config, pool, n_train = setup.config, setup.pool, setup.n_train
    rew_scale = config.get("REW_SCALE", 1.0)

    def train(seed: Optional[int] = None) -> Dict[str, Any]:
        train_state, host_gen, dev_gen = setup.agent(seed)
        explore = make_eps_greedy(config, dev_gen, host_gen)
        bufs = HostBuffers.allocate(pool, config["NUM_STEPS"], n_train, setup.device)
        stats = EpisodeStats(pool.num_envs)
        reset_pool(pool, bufs)
        history = []
        for _ in range(config["NUM_UPDATES"]):
            host_rollout(pool, train_state.network, explore, setup.eps_scheduler(train_state.n_updates), bufs,
                         n_train)
            rew_np, done_np = bufs.rew_pin.numpy(), bufs.done_pin.numpy()
            stats.update(rew_np, done_np)
            train_state.timesteps += config["NUM_STEPS"] * n_train
            td_loss = learn_update(train_state, bufs, n_train, setup.obs_shape, config, dev_gen)
            train_state.n_updates += 1
            history.append({
                "env_step": train_state.timesteps,
                "td_loss": td_loss,
                "reward_per_step": float((rew_scale * rew_np[:, :n_train]).mean()),
                # 1 / mean episode length: falls as the policy improves
                "done_rate": float(done_np[:, :n_train].astype(np.float32).mean()),
                "returned_episode_returns": float(stats.ret_r[:n_train].mean()),
                "returned_episode_lengths": float(stats.ret_l[:n_train].mean()),
                **setup.test_metrics(stats),
            })
        return {"runner_state": (train_state, bufs.cur, stats), "metrics": stack_metrics(history)}

    return train


def make_train_async(config: Dict[str, Any], pool: Optional[HostEnvPool] = None, device=None):
    """Build the lag-1 double-buffered ``train(seed=None)`` (ASYNC_ENVS,
    pqn_host.py:306-597): the rollout of batch u + 1 under a snapshot of
    the weights after u updates overlaps the learn phase of batch u.
    ``metrics`` holds pqn_host.py:570-586's row keys, each (NUM_UPDATES,);
    ``runner_state`` is (train_state,)."""
    setup = _Setup(config, pool, device)
    config, pool, n_train, device = setup.config, setup.pool, setup.n_train, setup.device
    n_updates = config["NUM_UPDATES"]

    def train(seed: Optional[int] = None) -> Dict[str, Any]:
        train_state, host_gen, dev_gen = setup.agent(seed)
        network = train_state.network
        actor = copy.deepcopy(network).requires_grad_(False)
        explore = make_eps_greedy(config, torch.Generator(device=device).manual_seed(draw_seed(host_gen)),
                                  torch.Generator().manual_seed(draw_seed(host_gen)))
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        bufs = [HostBuffers.allocate(pool, config["NUM_STEPS"], n_train, device) for _ in range(2)]
        stats = EpisodeStats(pool.num_envs)
        reset_pool(pool, bufs[0])
        results: "queue.Queue" = queue.Queue(maxsize=1)

        def worker(ready, start, dst, eps):
            try:
                with contextlib.ExitStack() as on_stream:
                    if stream is not None:
                        on_stream.enter_context(torch.cuda.device(device))
                        on_stream.enter_context(torch.cuda.stream(stream))
                        stream.wait_event(ready)
                    if start is not dst:
                        dst.cur.copy_(start.cur)
                    host_rollout(pool, actor, explore, eps, dst, n_train)
                    results.put((dst, stream.record_event() if stream is not None else None))
            except BaseException as e:  # noqa: BLE001 - raised again in the main thread
                results.put(e)

        def start_rollout(u: int) -> threading.Thread:
            # the snapshot of the weights after u updates, on the learner's
            # stream before batch u's learn phase is launched; the event
            # also orders the rollout after the learn phase that last read
            # the buffers it fills
            with torch.no_grad():
                for a, b in zip(actor.parameters(), network.parameters()):
                    a.copy_(b)
                for a, b in zip(actor.buffers(), network.buffers()):
                    a.copy_(b)
            ready = torch.cuda.current_stream(device).record_event() if stream is not None else None
            thread = threading.Thread(
                target=worker,
                args=(ready, bufs[max(u - 1, 0) % 2], bufs[u % 2], setup.eps_scheduler(u)),
                daemon=True,
            )
            thread.start()
            return thread

        history = []
        thread = start_rollout(0)
        for u in range(n_updates):
            got = results.get()
            thread.join()
            if isinstance(got, BaseException):
                raise RuntimeError("the host rollout worker died") from got
            batch, done_event = got
            if done_event is not None:
                torch.cuda.current_stream(device).wait_event(done_event)
            stats.update(batch.rew_pin.numpy(), batch.done_pin.numpy())
            if u + 1 < n_updates:
                thread = start_rollout(u + 1)
            td_loss = learn_update(train_state, batch, n_train, setup.obs_shape, config, dev_gen)
            train_state.timesteps += config["NUM_STEPS"] * n_train
            train_state.n_updates += 1
            test = setup.test_metrics(stats)
            test.pop("test/returned_episode_lengths", None)  # the async rows have none (pqn_host.py:570-586)
            history.append({
                "update": u,
                "td_loss": td_loss,
                "returned_episode_returns": float(stats.ret_r[:n_train].mean()),
                **test,
            })
        return {"runner_state": (train_state,), "metrics": stack_metrics(history)}

    return train
