"""Environment wrappers. Port of purejaxql_tpu/envs/wrappers.py for the
wrappers the ported trainers use:

- ``FlattenObservation`` (wrappers.py:36-55): each env's observation as one
  flat vector, for an MLP over an image-observation env;
- ``Log`` (wrappers.py:68-101): per-episode return and length accounting,
  reported in ``info`` on the step that ends an episode;
- ``ScrubNaN`` (:488-524): non-finite rewards and observations become 0,
  counted per env in ``info["nan_events"]``;
- ``LogVec`` (:691-742): ``Log`` for the continuous-control stack, with a
  scalar step counter and the raw reward as ``info["original_reward"]``;
- ``ClipAction`` (:527-537): clip continuous actions to the box;
- ``NormalizeVecObservation`` and ``NormalizeVecReward`` (:575-690): running
  statistics of the observations and of the discounted return over the env
  batch, for the continuous-control stack;
- ``BatchEnv`` (:139-158): the env at a fixed number of envs;
- ``OptimisticResetVecEnv`` (:214-280): auto-reset that makes only
  num_envs / reset_ratio fresh states a step and routes them to the done
  envs, for an env whose reset is expensive (Forager's worldgen);
- ``BankedResetVecEnv`` (:354-487): the same routing, its candidates
  served from a bank of packed reset states (``pack_rows``,
  ``unpack_rows``, :281-351) that a burst refreshes every
  ``refresh_every`` steps, and scattered onto the done envs
  (``scatter_resets``, :185-212).

``VecEnv`` has no counterpart: an env here already steps a whole batch. The
other wrappers come with the slices that need them.

Seeds (NUM_SEEDS = S > 1, algo/seeds.py): the trainers fold S seeds' envs
into seed-major rows, seed s's E envs the s-th block. A wrapper that couples
envs takes ``seeds=S`` and keeps the coupling inside each block, as each
``jax.vmap`` lane of the JAX package owns its own wrapper state: the
optimistic resets draw E / reset_ratio resets a seed among that seed's done
envs, the bank holds ``bank_size`` rows a seed, and the normalizers keep one
statistics state a seed, each updated from that seed's envs alone. With
``seeds=1`` every wrapper is the single-seed one, draw for draw.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Iterator, List, Tuple

import numpy as np
import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Wrapper, map_state, select_env, select_state


class FlattenObservation(Wrapper):
    """Each env's observation flattened to a vector (E, prod(shape)), in the
    row-major order of ``obs.reshape(-1)`` under the JAX package's vmap."""

    @staticmethod
    def _flat(obs):
        return obs.reshape(obs.shape[0], -1)

    def reset(self, generator, num_envs, params=None):
        obs, state = self._env.reset(generator, num_envs, params)
        return self._flat(obs), state

    def reset_env(self, generator, num_envs, params):
        obs, state = self._env.reset_env(generator, num_envs, params)
        return self._flat(obs), state

    def step(self, generator, state, action, params=None):
        obs, state, reward, done, info = self._env.step(generator, state, action, params)
        return self._flat(obs), state, reward, done, info

    def step_env(self, state, action, params, draws):
        obs, state, reward, done, info = self._env.step_env(state, action, params, draws)
        return self._flat(obs), state, reward, done, info

    def observation_space(self, params):
        space = self._env.observation_space(params)
        flat = lambda bound: np.asarray(bound).reshape(-1) if np.ndim(bound) else bound  # noqa: E731
        return spaces.Box(flat(space.low), flat(space.high), (int(np.prod(space.shape)),), space.dtype)


@dataclass
class LogEnvState:
    env_state: Any
    episode_returns: torch.Tensor  # (E,) f32
    episode_lengths: torch.Tensor  # (E,) int32
    returned_episode_returns: torch.Tensor
    returned_episode_lengths: torch.Tensor
    timestep: torch.Tensor  # (E,) int32


class Log(Wrapper):
    """Accumulate per-episode return/length; emit them in `info` on done.

    ``reset``/``step`` wrap the env's auto-resetting pair; ``reset_env``/
    ``step_env`` wrap its raw pair (wrappers.py:106-136), so that
    ``OptimisticResetVecEnv`` can manage the resets of a Log-wrapped env.
    """

    @staticmethod
    def _start(obs, env_state):
        num_envs = obs.shape[0]
        zero_f = torch.zeros(num_envs, device=obs.device)
        zero_i = torch.zeros(num_envs, dtype=torch.int32, device=obs.device)
        return obs, LogEnvState(env_state, zero_f, zero_i, zero_f, zero_i, zero_i)

    def reset(self, generator, num_envs, params=None):
        return self._start(*self._env.reset(generator, num_envs, params))

    def reset_env(self, generator, num_envs, params):
        return self._start(*self._env.reset_env(generator, num_envs, params))

    def step(self, generator, state, action, params=None):
        return self._account(state, *self._env.step(generator, state.env_state, action, params))

    def step_env(self, state, action, params, draws):
        return self._account(state, *self._env.step_env(state.env_state, action, params, draws))

    @staticmethod
    def _account(state, obs, env_state, reward, done, info):
        new_episode_return = state.episode_returns + reward
        new_episode_length = state.episode_lengths + 1
        done_f = done.to(new_episode_return.dtype)
        done_i = done.to(torch.int32)
        not_done = 1 - done_f
        not_done_i = 1 - done_i
        state = LogEnvState(
            env_state=env_state,
            episode_returns=new_episode_return * not_done,
            episode_lengths=new_episode_length * not_done_i,
            returned_episode_returns=state.returned_episode_returns * not_done
            + new_episode_return * done_f,
            returned_episode_lengths=state.returned_episode_lengths * not_done_i
            + new_episode_length * done_i,
            timestep=state.timestep + 1,
        )
        info = dict(info)
        info["returned_episode_returns"] = state.returned_episode_returns
        info["returned_episode_lengths"] = state.returned_episode_lengths
        info["timestep"] = state.timestep
        info["returned_episode"] = done
        return obs, state, reward, done, info


class BatchEnv(Wrapper):
    """The env at a fixed ``num_envs`` (wrappers.py:139-158). An env here
    already steps a batch, so this only pins its size for the trainer's
    batched mode; reset and step auto-reset as the env does."""

    def __init__(self, env, num_envs: int):
        super().__init__(env)
        self.num_envs = num_envs

    def reset(self, generator, num_envs=None, params=None):
        if num_envs not in (None, self.num_envs):
            raise ValueError(f"BatchEnv holds {self.num_envs} envs, asked for {num_envs}")
        return self._env.reset(generator, self.num_envs, params)


def reset_slot_map(being_reset: torch.Tensor, num_envs: int, reset_ratio: int) -> torch.Tensor:
    """Which of the num_envs / reset_ratio fresh states each env takes
    (wrappers.py:254-262): env i the slot i // reset_ratio, and the sampled
    envs ``being_reset`` (num_resets of them) slots 0, 1, ... of their own.
    With seeds, num_envs is all S * E rows and ``being_reset`` seed-major
    (``sample_being_reset``): seed s's envs take only slots of its own block
    s * E / reset_ratio, ..., the slots seed s's fresh states fill."""
    num_resets = num_envs // reset_ratio
    slots = torch.arange(num_resets, device=being_reset.device)
    index = slots.repeat_interleave(reset_ratio)
    index[being_reset] = slots
    return index


def sample_being_reset(generator: torch.Generator, done: torch.Tensor, num_resets: int, seeds: int = 1) -> torch.Tensor:
    """num_resets distinct envs, done ones first, by Gumbel top-k over
    log(done): the sampling without replacement weighted by ``done`` of the
    JAX wrapper's ``jax.random.choice(p=done, replace=False)``. Every done env
    is taken when at most num_resets are done, and only done ones when more
    are; ``torch.multinomial`` would raise on both of those cases' edges (too
    few nonzero weights, all weights zero). With ``seeds`` > 1, ``done``
    holds S seed-major blocks of E envs and num_resets are drawn in each
    block: (S * num_resets,) row indices, seed-major, seed s's in its block."""
    u = torch.rand(done.shape, generator=generator, device=done.device).clamp_(min=torch.finfo(torch.float32).tiny)
    scores = torch.log(done.float()) - torch.log(-torch.log(u))
    lanes = scores.reshape(seeds, -1)
    local = torch.topk(lanes, num_resets, dim=1).indices
    return (local + lanes.shape[1] * torch.arange(seeds, device=done.device)[:, None]).reshape(-1)


class OptimisticResetVecEnv(Wrapper):
    """Auto-reset with shared resets (wrappers.py:214-280): a step makes only
    num_envs / reset_ratio fresh states and routes them to the done envs, so
    an expensive reset (Forager's worldgen) costs 1 / reset_ratio of one per
    env. Every env gets slot i // reset_ratio, and up to num_resets sampled
    done envs a slot of their own; every done env is reset, those beyond
    num_resets on a shared slot. Wraps an env's raw ``reset_env``/
    ``step_env`` (a Log-wrapped env's). With ``seeds`` > 1 it holds S
    seed-major blocks of num_envs and each block draws its own num_resets
    fresh states and routes them to its own done envs."""

    def __init__(self, env, num_envs: int, reset_ratio: int, seeds: int = 1):
        super().__init__(env)
        if num_envs % reset_ratio != 0:
            raise ValueError("reset_ratio must divide num_envs")
        self.num_envs = num_envs
        self.reset_ratio = reset_ratio
        self.num_resets = num_envs // reset_ratio
        self.seeds = seeds
        self.total = seeds * num_envs

    def reset(self, generator, num_envs=None, params=None):
        if num_envs not in (None, self.total):
            raise ValueError(f"OptimisticResetVecEnv holds {self.total} envs, asked for {num_envs}")
        params = self.default_params if params is None else params
        return self._env.reset_env(generator, self.total, params)

    def step(self, generator, state, action, params=None):
        params = self.default_params if params is None else params
        draws = self._env.step_draws(generator, self.total)
        obs_st, state_st, reward, done, info = self._env.step_env(state, action, params, draws)
        obs_re, state_re = self._env.reset_env(generator, self.seeds * self.num_resets, params)
        being_reset = sample_being_reset(generator, done, self.num_resets, self.seeds)
        index = reset_slot_map(being_reset, self.total, self.reset_ratio)
        obs = select_env(done, obs_re[index], obs_st)
        state = select_state(done, map_state(lambda x: x[index], state_re), state_st)
        return obs, state, reward, done, info


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a state tree in the order ``jax.tree_util.tree_leaves``
    gives the JAX package's: tuple items in order, dataclass fields in
    declaration order, recursively (a Log state's env state first)."""
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    if dataclasses.is_dataclass(tree):
        return [leaf for f in dataclasses.fields(tree) for leaf in tree_leaves(getattr(tree, f.name))]
    return [tree]


def _rebuild(like, leaves: Iterator[torch.Tensor]):
    """``like``'s tree with its tensors taken in turn from ``leaves``."""
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(item, leaves) for item in like)
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(
            like, **{f.name: _rebuild(getattr(like, f.name), leaves) for f in dataclasses.fields(like)}
        )
    return next(leaves)


def pack_rows(tree) -> Tuple[torch.Tensor, torch.Tensor]:
    """A tree of (N, ...) tensors as two row-major buffers (wrappers.py:
    281-318): (N, n8) int8 for the 1-byte leaves (bool as 0 / 1, int8 and
    uint8 bit-cast) and (N, n32) int32 for the 4-byte ones (float32 bit-cast,
    so the round trip is exact: NaN payloads and -0.0 included), each leaf's
    columns in ``tree_leaves`` order."""
    leaves = tree_leaves(tree)
    n, dev = leaves[0].shape[0], leaves[0].device
    g8, g32 = [], []
    for x in leaves:
        flat = x.reshape(n, -1)
        if x.dtype == torch.bool:
            g8.append(flat.to(torch.int8))
        elif x.element_size() == 1:
            g8.append(flat.view(torch.int8))
        elif x.element_size() == 4:
            g32.append(flat if x.dtype == torch.int32 else flat.view(torch.int32))
        else:
            raise NotImplementedError(f"packed rows hold 1- and 4-byte leaves, got {x.dtype}")
    w8 = torch.cat(g8, 1) if g8 else torch.zeros((n, 0), dtype=torch.int8, device=dev)
    w32 = torch.cat(g32, 1) if g32 else torch.zeros((n, 0), dtype=torch.int32, device=dev)
    return w8, w32


def unpack_rows(w8: torch.Tensor, w32: torch.Tensor, like):
    """The inverse of ``pack_rows`` (wrappers.py:321-351): ``like``'s tree,
    leaf shapes past the first and dtypes, with the buffers' row count."""
    n = w8.shape[0]
    o8 = o32 = 0
    out = []
    for x in tree_leaves(like):
        tail = tuple(x.shape[1:])
        size = math.prod(tail)
        if x.dtype == torch.bool or x.element_size() == 1:
            seg = w8[:, o8 : o8 + size]
            o8 += size
            seg = seg.to(torch.bool) if x.dtype == torch.bool else seg.view(x.dtype)
        else:
            seg = w32[:, o32 : o32 + size]
            o32 += size
            if x.dtype != torch.int32:
                seg = seg.view(x.dtype)
        out.append(seg.reshape((n,) + tail))
    return _rebuild(like, iter(out))


def scatter_resets(done: torch.Tensor, being_reset: torch.Tensor, resets, live):
    """``live`` with candidate k of ``resets`` written onto env
    ``being_reset[k]`` where that env is done (wrappers.py:185-212). The
    sampled envs that are not done (``sample_being_reset`` fills num_resets
    slots whatever the number of dones) take their own stepped row back,
    where the JAX package drops their writes out of range. When more envs
    are done than there are candidates, the extras are not reset: they end
    again on the next step and are routed then. O(num_resets) rows gathered
    and written per leaf, no host sync."""
    take = done[being_reset]

    def put(st, re):
        return st.index_copy(0, being_reset, select_env(take, re, st[being_reset]))

    return _rebuild(live, iter([put(st, re) for st, re in zip(tree_leaves(live), tree_leaves(resets))]))


def serve_resets(done, being_reset, cand, bank, stepped):
    """The bank's deterministic serve (wrappers.py:470-476): rows ``cand`` of
    the packed bank ``(w8, w32)``, one gather a buffer, unpacked to the tree
    of ``stepped`` (the step's (obs, state)) and scattered onto its done
    envs among ``being_reset``."""
    w8, w32 = bank
    return scatter_resets(done, being_reset, unpack_rows(w8[cand], w32[cand], stepped), stepped)


@dataclass
class BankedResetState:
    env_state: Any  # (num_envs, ...) live env states
    bank_w8: torch.Tensor  # (bank_size, n8) packed 1-byte columns of the bank's (obs, state) rows
    bank_w32: torch.Tensor  # (bank_size, n32) packed 4-byte columns
    cursor: int  # where the next refresh burst writes, a host integer
    tick: int  # steps taken, a host integer: it gates the bursts without a device sync


class BankedResetVecEnv(Wrapper):
    """``OptimisticResetVecEnv`` with its fresh states served from a bank
    (wrappers.py:354-487, config RESET_BANK > 0): reset makes the num_envs
    live states and ``bank_size`` reset states, packed; each step steps the
    env, every ``refresh_every`` steps regenerates num_resets bank rows at a
    rotating cursor (a burst: one reset of num_resets envs), draws
    num_resets candidate rows uniformly and routes them to the done envs by
    the optimistic wrapper's sampling (``sample_being_reset``, the
    ``p=done`` weighted draw), deferring the dones beyond num_resets to a
    later step (``scatter_resets``). A bank row is at most ~bank_size /
    num_resets * refresh_every steps old. ``refreshes`` counts the bursts
    of every instance (reset's bank not included).

    With ``seeds`` > 1 it holds S seed-major blocks of num_envs and a bank
    of S * bank_size rows, seed s's bank the s-th block with a cursor of its
    own (the S cursors move in step, so one host integer holds them); a
    burst regenerates num_resets rows of every seed's bank in one reset of
    S * num_resets envs, and each seed draws its candidates from its own
    bank and routes them to its own done envs."""

    refreshes = 0

    def __init__(self, env, num_envs: int, reset_ratio: int, bank_size: int = 256, refresh_every: int = 16,
                 seeds: int = 1):
        super().__init__(env)
        if num_envs % reset_ratio != 0:
            raise ValueError("reset_ratio must divide num_envs")
        self.num_envs = num_envs
        self.num_resets = num_envs // reset_ratio
        self.bank_size = bank_size
        self.refresh_every = refresh_every
        self.seeds = seeds
        self.total = seeds * num_envs

    def reset(self, generator, num_envs=None, params=None):
        if num_envs not in (None, self.total):
            raise ValueError(f"BankedResetVecEnv holds {self.total} envs, asked for {num_envs}")
        params = self.default_params if params is None else params
        obs, env_state = self._env.reset_env(generator, self.total, params)
        w8, w32 = pack_rows(self._env.reset_env(generator, self.seeds * self.bank_size, params))
        return obs, BankedResetState(env_state, w8, w32, cursor=0, tick=0)

    def _bank_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """(S, n) rows of each seed's bank -> (S * n,) rows of the whole bank."""
        return (rows + self.bank_size * torch.arange(self.seeds, device=rows.device)[:, None]).reshape(-1)

    def refresh(self, generator, state: BankedResetState, params):
        """A burst: num_resets fresh (obs, state) rows a seed written over
        its bank from the cursor on. Returns (bank_w8, bank_w32, cursor)."""
        f8, f32 = pack_rows(self._env.reset_env(generator, self.seeds * self.num_resets, params))
        rows = (state.cursor + torch.arange(self.num_resets, device=f8.device)) % self.bank_size
        rows = self._bank_rows(rows.expand(self.seeds, -1))
        BankedResetVecEnv.refreshes += 1
        return (
            state.bank_w8.index_copy(0, rows, f8),
            state.bank_w32.index_copy(0, rows, f32),
            state.cursor + self.num_resets,
        )

    def step(self, generator, state: BankedResetState, action, params=None):
        params = self.default_params if params is None else params
        draws = self._env.step_draws(generator, self.total)
        obs_st, env_st, reward, done, info = self._env.step_env(state.env_state, action, params, draws)
        w8, w32, cursor = state.bank_w8, state.bank_w32, state.cursor
        if state.tick % self.refresh_every == 0:
            w8, w32, cursor = self.refresh(generator, state, params)
        cand = torch.randint(0, self.bank_size, (self.seeds, self.num_resets), generator=generator, device=done.device)
        cand = self._bank_rows(cand)
        being_reset = sample_being_reset(generator, done, self.num_resets, self.seeds)
        obs, env_state = serve_resets(done, being_reset, cand, (w8, w32), (obs_st, env_st))
        new_state = BankedResetState(env_state, w8, w32, cursor % self.bank_size, state.tick + 1)
        return obs, new_state, reward, done, info


class ScrubNaN(Wrapper):
    """Zero non-finite rewards and observations at the env boundary, and
    count what was scrubbed per env in ``info["nan_events"]`` (int32, zero on
    a healthy env)."""

    def reset(self, generator, num_envs, params=None):
        obs, state = self._env.reset(generator, num_envs, params)
        return torch.where(torch.isfinite(obs), obs, 0.0), state

    def step(self, generator, state, action, params=None):
        obs, state, reward, done, info = self._env.step(generator, state, action, params)
        bad_r = ~torch.isfinite(reward)
        bad_o = (~torch.isfinite(obs)).reshape(reward.shape[0], -1).sum(-1)
        info = dict(info)
        info["nan_events"] = (bad_r.to(torch.int32) + bad_o).to(torch.int32)
        reward = torch.where(bad_r, 0.0, reward)
        obs = torch.where(torch.isfinite(obs), obs, 0.0)
        return obs, state, reward, done, info


class ClipAction(Wrapper):
    """Clip continuous actions to [low, high]."""

    def __init__(self, env, low: float = -1.0, high: float = 1.0):
        super().__init__(env)
        self.low, self.high = low, high

    def step(self, generator, state, action, params=None):
        return self._env.step(generator, state, action.clamp(self.low, self.high), params)


@dataclass
class LogVecState:
    env_state: Any
    episode_returns: torch.Tensor  # (E,) f32
    episode_lengths: torch.Tensor  # (E,) int32
    returned_episode_returns: torch.Tensor
    returned_episode_lengths: torch.Tensor
    timestep: torch.Tensor  # () int32, one counter for the batch


class LogVec(Wrapper):
    """Batched episode accounting for the continuous-control stack; also
    reports the reward it saw as ``original_reward`` and the scalar step
    counter broadcast to (E,)."""

    def reset(self, generator, num_envs, params=None):
        obs, env_state = self._env.reset(generator, num_envs, params)
        zero_f = torch.zeros(num_envs, device=obs.device)
        zero_i = torch.zeros(num_envs, dtype=torch.int32, device=obs.device)
        timestep = torch.zeros((), dtype=torch.int32, device=obs.device)
        return obs, LogVecState(env_state, zero_f, zero_i, zero_f, zero_i, timestep)

    def step(self, generator, state, action, params=None):
        obs, env_state, reward, done, info = self._env.step(
            generator, state.env_state, action, params
        )
        new_episode_return = state.episode_returns + reward
        new_episode_length = state.episode_lengths + 1
        done_f = done.to(new_episode_return.dtype)
        done_i = done.to(torch.int32)
        state = LogVecState(
            env_state=env_state,
            episode_returns=new_episode_return * (1 - done_f),
            episode_lengths=new_episode_length * (1 - done_i),
            returned_episode_returns=state.returned_episode_returns * (1 - done_f)
            + new_episode_return * done_f,
            returned_episode_lengths=state.returned_episode_lengths * (1 - done_i)
            + new_episode_length * done_i,
            timestep=state.timestep + 1,
        )
        info = dict(info)
        info["returned_episode_returns"] = state.returned_episode_returns
        info["returned_episode_lengths"] = state.returned_episode_lengths
        info["returned_episode"] = done
        info["timestep"] = state.timestep.expand(done.shape)
        info["original_reward"] = reward
        return obs, state, reward, done, info


@dataclass
class NormalizeVecObsState:
    mean: torch.Tensor  # (obs_dim,) f32; (S, obs_dim) with seeds
    var: torch.Tensor  # (obs_dim,) f32; (S, obs_dim) with seeds
    count: torch.Tensor  # () f32, 1e-4 plus every observation row seen; (S,) with seeds
    env_state: Any


def _merge_moments(mean, var, count, batch_mean, batch_var, batch_count: int):
    """The parallel-variance update of running (mean, var, count) with a
    batch's population moments (wrappers.py:625-636), operation for
    operation. Returns new tensors: the old ones are never written."""
    delta = batch_mean - mean
    tot_count = count + batch_count
    new_mean = mean + delta * batch_count / tot_count
    m_a = var * count
    m_b = batch_var * batch_count
    m2 = m_a + m_b + torch.square(delta) * count * batch_count / tot_count
    return new_mean, m2 / tot_count, tot_count


def _lane_moments(x: torch.Tensor, seeds: int):
    """The population mean and variance of x's rows, (S, ...) each seed's
    over its block of seed-major rows; with one seed over all rows."""
    if seeds == 1:
        return x.mean(0), torch.var(x, 0, correction=0)
    lanes = x.reshape(seeds, -1, *x.shape[1:])
    return lanes.mean(1), torch.var(lanes, 1, correction=0)


class NormalizeVecObservation(Wrapper):
    """Running mean/var normalization of the observations over the env batch
    (wrappers.py:575-637): every reset and step batch updates the statistics
    (population variance over the envs) and the observations come out as
    (obs - mean) / sqrt(var + 1e-8) with the updated ones. The count starts
    at 1e-4 in float32, as JAX's. ``eval_step`` normalizes with the
    statistics frozen. States are replaced, never written in place, so a
    copy of the training statistics can be stepped on its own (the eval).
    With ``seeds`` > 1 the state holds each seed's statistics, (S, obs_dim)
    and a count (S,), each moved by its own block of E envs alone."""

    def __init__(self, env, seeds: int = 1):
        super().__init__(env)
        self.seeds = seeds

    def reset(self, generator, num_envs, params=None):
        obs, env_state = self._env.reset(generator, num_envs, params)
        lead = () if self.seeds == 1 else (self.seeds,)
        state = NormalizeVecObsState(
            mean=obs.new_zeros(*lead, *obs.shape[1:]), var=obs.new_ones(*lead, *obs.shape[1:]),
            count=torch.full(lead, 1e-4, dtype=torch.float32, device=obs.device), env_state=env_state,
        )
        return self._update_and_normalize(state, obs)

    def step(self, generator, state, action, params=None):
        obs, env_state, reward, done, info = self._env.step(generator, state.env_state, action, params)
        norm_obs, state = self._update_and_normalize(dataclasses.replace(state, env_state=env_state), obs)
        return norm_obs, state, reward, done, info

    def eval_step(self, generator, state, action, params=None):
        """A step normalized with the statistics frozen (wrappers.py:600-609)."""
        obs, env_state, reward, done, info = self._env.step(generator, state.env_state, action, params)
        state = dataclasses.replace(state, env_state=env_state)
        return normalize_obs(obs, state.mean, state.var), state, reward, done, info

    def _update_and_normalize(self, state, obs):
        batch_mean, batch_var = _lane_moments(obs, self.seeds)
        count = state.count if self.seeds == 1 else state.count[:, None]
        mean, var, count = _merge_moments(
            state.mean, state.var, count, batch_mean, batch_var, obs.shape[0] // self.seeds
        )
        state = dataclasses.replace(state, mean=mean, var=var, count=count if self.seeds == 1 else count[:, 0])
        return normalize_obs(obs, mean, var), state


def normalize_obs(obs: torch.Tensor, mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """(obs - mean) / sqrt(var + 1e-8); seeds' statistics (S, obs_dim) each
    on its block of seed-major rows of obs (S * E, obs_dim)."""
    if mean.dim() == obs.dim():
        lanes = obs.reshape(mean.shape[0], -1, *obs.shape[1:])
        return ((lanes - mean[:, None]) / torch.sqrt(var[:, None] + 1e-8)).reshape(obs.shape)
    return (obs - mean) / torch.sqrt(var + 1e-8)


@dataclass
class NormalizeVecRewState:
    mean: torch.Tensor  # () f32; (S,) with seeds
    var: torch.Tensor  # () f32; (S,) with seeds
    count: torch.Tensor  # () f32; (S,) with seeds
    return_val: torch.Tensor  # (E,) the running discounted return; (S * E,) with seeds
    env_state: Any


class NormalizeVecReward(Wrapper):
    """Rewards scaled by the running std of the discounted return
    (wrappers.py:648-690): each step the return (reset only through
    1 - done) updates running moments over the env batch, and the reward
    comes out as reward / sqrt(var + 1e-8), no mean subtracted. The
    observations pass through. With ``seeds`` > 1 the moments are each
    seed's, (S,), over its block of E envs."""

    def __init__(self, env, gamma: float, seeds: int = 1):
        super().__init__(env)
        self.gamma = gamma
        self.seeds = seeds

    def reset(self, generator, num_envs, params=None):
        obs, env_state = self._env.reset(generator, num_envs, params)
        f32 = dict(dtype=torch.float32, device=obs.device)
        lead = () if self.seeds == 1 else (self.seeds,)
        state = NormalizeVecRewState(
            mean=torch.zeros(lead, **f32), var=torch.ones(lead, **f32), count=torch.full(lead, 1e-4, **f32),
            return_val=torch.zeros(num_envs, **f32), env_state=env_state,
        )
        return obs, state

    def step(self, generator, state, action, params=None):
        obs, env_state, reward, done, info = self._env.step(generator, state.env_state, action, params)
        return_val = state.return_val * self.gamma * (1 - done.float()) + reward
        batch_mean, batch_var = _lane_moments(return_val, self.seeds)
        mean, var, count = _merge_moments(
            state.mean, state.var, state.count, batch_mean, batch_var, return_val.shape[0] // self.seeds,
        )
        state = NormalizeVecRewState(mean=mean, var=var, count=count, return_val=return_val, env_state=env_state)
        scale = torch.sqrt(var + 1e-8)
        if self.seeds > 1:
            scale = scale.repeat_interleave(return_val.shape[0] // self.seeds)
        return obs, state, reward / scale, done, info
