"""Seaquest-MinAtar, batched over E envs.

Port of purejaxql_tpu/envs/minatar/seaquest.py: a submarine on a 10x10 grid
(row 0 the surface, rows 1-8 the lanes) shoots fish and enemy subs (+1
each), picks up divers and must surface before its oxygen runs out.
Surfacing with no diver on board ends the episode; with six, they are cashed
in for oxygen / 10 (computed as the compiled JAX env computes it, see
``TENTH``), a reward that is not an integer. Enemy subs shoot back.
Each kind lives in a fixed pool of slots: 8 fish, 4 subs, 4 friendly and 4
enemy bullets, 4 divers. Actions [noop, left, up, right, down, fire];
observations (E, 10, 10, 10) float32, channels [sub front, sub back,
friendly bullet, its trail, enemy sub, enemy bullet, fish, diver, oxygen
gauge, diver gauge]. The step applies the rules in the order of
seaquest.py:153-353: player and shot, bullets, lane moves, the enemy shot,
hits, spawns, player collisions, oxygen and surfacing.

The step's randomness comes in ``SeaquestDraws``: a score per slot of each
pool (a spawn takes the free slot with the highest score, the first on
ties: a Gumbel-max choice over the free slots), the lane, the direction and
whether an enemy spawn is a sub. The JAX env shares keys between draws (fish
and subs score from one key, the lane and the diver slot from another,
seaquest.py:259-263,286); ``step_draws`` here draws every field on its own,
which changes only their joint statistics. The reset is deterministic.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment

N_FISH = 8
N_SUBS = 4
N_FBULLETS = 4
N_EBULLETS = 4
N_DIVERS = 4
# The cash-in pays oxygen / 10 (seaquest.py:319-321). Compiled, XLA turns the
# division by the constant into a product with its float32 reciprocal, so the
# JAX trainer and the TPU kernel (pallas_rollout.py:1938-1940, interpret mode
# included) pay oxygen * 0.1f, which differs from the quotient in the last bit
# for some oxygen values; the port pays the product as they do.
TENTH = 0.1


@dataclass
class SeaquestState:
    sub_x: torch.Tensor  # (E,) int32
    sub_y: torch.Tensor
    sub_or: torch.Tensor  # facing: 0 left, 1 right
    oxygen: torch.Tensor
    divers: torch.Tensor  # divers on board (0..6)
    shot_timer: torch.Tensor
    f_exists: torch.Tensor  # (E, 8) bool
    f_x: torch.Tensor  # (E, 8) int32
    f_y: torch.Tensor
    f_dir: torch.Tensor  # +1 right, -1 left
    f_timer: torch.Tensor
    s_exists: torch.Tensor  # (E, 4) bool
    s_x: torch.Tensor  # (E, 4) int32
    s_y: torch.Tensor
    s_dir: torch.Tensor
    s_timer: torch.Tensor
    s_shot_timer: torch.Tensor
    fb_exists: torch.Tensor  # friendly bullets
    fb_x: torch.Tensor
    fb_y: torch.Tensor
    fb_dir: torch.Tensor
    eb_exists: torch.Tensor  # enemy bullets
    eb_x: torch.Tensor
    eb_y: torch.Tensor
    eb_dir: torch.Tensor
    d_exists: torch.Tensor  # divers in the water
    d_x: torch.Tensor
    d_y: torch.Tensor
    d_dir: torch.Tensor
    d_timer: torch.Tensor
    spawn_timer: torch.Tensor  # (E,) int32
    diver_spawn_timer: torch.Tensor
    move_interval: torch.Tensor
    surfaced: torch.Tensor  # (E,) bool
    terminal: torch.Tensor
    time: torch.Tensor  # (E,) int32


@dataclass(frozen=True)
class SeaquestParams:
    max_oxygen: int = 200
    init_spawn_speed: int = 20
    diver_spawn_speed: int = 30
    init_move_interval: int = 5
    shot_cool_down: int = 5
    enemy_shot_interval: int = 10
    max_steps_in_episode: int = 1000


@dataclass
class SeaquestDraws:
    fb: torch.Tensor  # (E, 4) float32: the friendly-bullet slot scores
    eb: torch.Tensor  # (E, 4): the enemy-bullet slot scores
    fish: torch.Tensor  # (E, 8): the fish slot scores
    sub: torch.Tensor  # (E, 4): the enemy-sub slot scores
    diver: torch.Tensor  # (E, 4): the diver slot scores
    lane: torch.Tensor  # (E,) int32 in 1..8: the spawn's row
    lr: torch.Tensor  # (E,) bool: the spawn starts at the left edge, moving right
    is_sub: torch.Tensor  # (E,) bool: the enemy spawn is a sub, not a fish


def start_state(num_envs: int, params: SeaquestParams, device) -> SeaquestState:
    """The start of an episode (seaquest.py:114-150)."""
    full = lambda v: torch.full((num_envs,), v, dtype=torch.int32, device=device)  # noqa: E731
    pool = lambda n, v=0: torch.full((num_envs, n), v, dtype=torch.int32, device=device)  # noqa: E731
    none = lambda n: torch.zeros(num_envs, n, dtype=torch.bool, device=device)  # noqa: E731
    return SeaquestState(
        sub_x=full(5), sub_y=full(0), sub_or=full(1), oxygen=full(params.max_oxygen), divers=full(0),
        shot_timer=full(0),
        f_exists=none(N_FISH), f_x=pool(N_FISH), f_y=pool(N_FISH), f_dir=pool(N_FISH, 1), f_timer=pool(N_FISH),
        s_exists=none(N_SUBS), s_x=pool(N_SUBS), s_y=pool(N_SUBS), s_dir=pool(N_SUBS, 1),
        s_timer=pool(N_SUBS), s_shot_timer=pool(N_SUBS, params.enemy_shot_interval),
        fb_exists=none(N_FBULLETS), fb_x=pool(N_FBULLETS), fb_y=pool(N_FBULLETS), fb_dir=pool(N_FBULLETS, 1),
        eb_exists=none(N_EBULLETS), eb_x=pool(N_EBULLETS), eb_y=pool(N_EBULLETS), eb_dir=pool(N_EBULLETS, 1),
        d_exists=none(N_DIVERS), d_x=pool(N_DIVERS), d_y=pool(N_DIVERS), d_dir=pool(N_DIVERS, 1),
        d_timer=pool(N_DIVERS),
        spawn_timer=full(params.init_spawn_speed), diver_spawn_timer=full(params.diver_spawn_speed),
        move_interval=full(params.init_move_interval),
        surfaced=torch.ones(num_envs, dtype=torch.bool, device=device),
        terminal=torch.zeros(num_envs, dtype=torch.bool, device=device), time=full(0),
    )


def _i32(x) -> torch.Tensor:
    return x.to(torch.int32)


def pick_free_slot(free: torch.Tensor, score: torch.Tensor):
    """A spawn's slot, as the TPU kernel's ``_first_free``
    (pallas_rollout.py:1619-1628): the one-hot (E, n) of the free slot whose
    score is the highest of where(free, score, -1), the first on ties, and
    whether any slot is free. With scores above -1 (every random draw) this
    is the JAX env's argmax over the free slots; with the kernel's
    deterministic scores -index, a free slot scoring below an occupied one's
    -1 is never taken."""
    masked = torch.where(free, score, -1.0)
    sel = (masked == masked.max(1, keepdim=True).values) & free
    first = sel & (sel.cumsum(1) == 1)
    return first, free.any(1)


def _move_lane(exists, x, direction, timer, interval):
    """Lane entities step on their cadence and leave off the board
    (seaquest.py:88-96)."""
    do_move = timer <= 0
    nx = x + torch.where(do_move & exists, direction, 0)
    exists = exists & ~(do_move & ((nx < 0) | (nx > 9)))
    timer = torch.where(do_move, interval[:, None], timer - 1)
    return exists, _i32(nx.clamp(0, 9)), _i32(timer)


def _at_sub(exists, x, y, sub_x, sub_y):
    return exists & (x == sub_x[:, None]) & (y == sub_y[:, None])


class MinSeaquest(Environment):
    @property
    def default_params(self) -> SeaquestParams:
        return SeaquestParams()

    @property
    def name(self) -> str:
        return "Seaquest-MinAtar"

    def reset_env(self, generator, num_envs, params):
        state = start_state(num_envs, params, generator.device)
        return self.get_obs(state, params), state

    def step_draws(self, generator, num_envs):
        dev = generator.device
        u = torch.rand((num_envs, 26), generator=generator, device=dev)
        lane = torch.randint(1, 9, (num_envs,), generator=generator, device=dev, dtype=torch.int32)
        return SeaquestDraws(
            fb=u[:, 0:4], eb=u[:, 4:8], fish=u[:, 8:16], sub=u[:, 16:20], diver=u[:, 20:24],
            lane=lane, lr=u[:, 24] < 0.5, is_sub=u[:, 25] < 1.0 / 3.0,
        )

    def step_env(self, state, action, params, draws):
        action = action.to(torch.int32)

        # player
        sub_x = _i32((state.sub_x + _i32(action == 3) - _i32(action == 1)).clamp(0, 9))
        sub_y = _i32((state.sub_y + _i32(action == 4) - _i32(action == 2)).clamp(0, 8))
        sub_or = _i32(torch.where(action == 1, 0, torch.where(action == 3, 1, state.sub_or)))

        # fire: one friendly bullet from the sub's nose
        fire = (action == 5) & (state.shot_timer == 0)
        take, fb_free = pick_free_slot(~state.fb_exists, draws.fb)
        do_fire = fire & fb_free
        take = take & do_fire[:, None]
        fb_exists = state.fb_exists | take
        fb_x = torch.where(take, sub_x[:, None], state.fb_x)
        fb_y = torch.where(take, sub_y[:, None], state.fb_y)
        fb_dir = _i32(torch.where(take, torch.where(sub_or == 1, 1, -1)[:, None], state.fb_dir))
        shot_timer = _i32(torch.where(do_fire, params.shot_cool_down, (state.shot_timer - 1).clamp(min=0)))

        # bullets move every step
        fb_x = torch.where(fb_exists, fb_x + fb_dir, fb_x)
        fb_exists = fb_exists & (fb_x >= 0) & (fb_x <= 9)
        fb_x = _i32(fb_x.clamp(0, 9))
        eb_x = torch.where(state.eb_exists, state.eb_x + state.eb_dir, state.eb_x)
        eb_exists = state.eb_exists & (eb_x >= 0) & (eb_x <= 9)
        eb_x = _i32(eb_x.clamp(0, 9))

        # lane entities move on their cadence, the divers at half the pace
        mvi = state.move_interval
        f_exists, f_x, f_timer = _move_lane(state.f_exists, state.f_x, state.f_dir, state.f_timer, mvi)
        s_exists, s_x, s_timer = _move_lane(state.s_exists, state.s_x, state.s_dir, state.s_timer, mvi)
        d_exists, d_x, d_timer = _move_lane(state.d_exists, state.d_x, state.d_dir, state.d_timer, 2 * mvi)

        # the first sub whose shot timer ran out fires into a free bullet slot;
        # only the timers of subs that exist run down
        s_shot_timer = state.s_shot_timer - _i32(s_exists)
        wants = s_exists & (s_shot_timer <= 0)
        shooter = wants & (wants.cumsum(1) == 1)
        take, eb_free = pick_free_slot(~eb_exists, draws.eb)
        do_eshot = wants.any(1) & eb_free
        take = take & do_eshot[:, None]
        of_shooter = lambda v: (v * shooter).sum(1, keepdim=True)  # noqa: E731
        eb_exists = eb_exists | take
        eb_x = _i32(torch.where(take, of_shooter(s_x), eb_x))
        eb_y = _i32(torch.where(take, of_shooter(state.s_y), state.eb_y))
        eb_dir = _i32(torch.where(take, of_shooter(state.s_dir), state.eb_dir))
        s_shot_timer = _i32(torch.where(shooter & do_eshot[:, None], params.enemy_shot_interval, s_shot_timer))

        # friendly bullets hit fish and subs
        def hits(ex, ey, eexists):  # (E, bullets, enemies)
            return (
                fb_exists[:, :, None] & eexists[:, None, :]
                & (fb_x[:, :, None] == ex[:, None, :]) & (fb_y[:, :, None] == ey[:, None, :])
            )

        fh, sh = hits(f_x, state.f_y, f_exists), hits(s_x, state.s_y, s_exists)
        f_hit, s_hit = fh.any(1), sh.any(1)
        reward = (f_hit.sum(1) + s_hit.sum(1)).to(torch.float32)
        f_exists = f_exists & ~f_hit
        s_exists = s_exists & ~s_hit
        fb_exists = fb_exists & ~(fh.any(2) | sh.any(2))

        # spawns: an enemy on the spawn cadence, a diver on its own
        edge_x = _i32(torch.where(draws.lr, 0, 9))[:, None]
        edge_dir = _i32(torch.where(draws.lr, 1, -1))[:, None]
        lane = _i32(draws.lane)[:, None]
        spawn_timer = state.spawn_timer - 1
        do_spawn = spawn_timer <= 0
        take_f, f_free = pick_free_slot(~f_exists, draws.fish)
        take_s, s_free = pick_free_slot(~s_exists, draws.sub)
        take_f = take_f & (do_spawn & ~draws.is_sub & f_free)[:, None]
        take_s = take_s & (do_spawn & draws.is_sub & s_free)[:, None]
        f_exists = f_exists | take_f
        f_x = torch.where(take_f, edge_x, f_x)
        f_y = torch.where(take_f, lane, state.f_y)
        f_dir = torch.where(take_f, edge_dir, state.f_dir)
        s_exists = s_exists | take_s
        s_x = torch.where(take_s, edge_x, s_x)
        s_y = torch.where(take_s, lane, state.s_y)
        s_dir = torch.where(take_s, edge_dir, state.s_dir)
        spawn_timer = _i32(torch.where(do_spawn, params.init_spawn_speed, spawn_timer))

        diver_spawn_timer = state.diver_spawn_timer - 1
        do_dspawn = diver_spawn_timer <= 0
        take_d, d_free = pick_free_slot(~d_exists, draws.diver)
        take_d = take_d & (do_dspawn & d_free)[:, None]
        d_exists = d_exists | take_d
        d_x = torch.where(take_d, edge_x, d_x)
        d_y = torch.where(take_d, lane, state.d_y)
        d_dir = torch.where(take_d, edge_dir, state.d_dir)
        diver_spawn_timer = _i32(torch.where(do_dspawn, params.diver_spawn_speed, diver_spawn_timer))

        # the sub picks up divers and meets enemies and their bullets
        pick = _at_sub(d_exists, d_x, d_y, sub_x, sub_y)
        divers = _i32((state.divers + pick.sum(1)).clamp(max=6))
        d_exists = d_exists & ~pick
        hit_enemy = (
            _at_sub(f_exists, f_x, f_y, sub_x, sub_y).any(1)
            | _at_sub(s_exists, s_x, s_y, sub_x, sub_y).any(1)
            | _at_sub(eb_exists, eb_x, eb_y, sub_x, sub_y).any(1)
        )

        # oxygen and surfacing: with no diver fatal, with six a cash-in
        underwater = sub_y > 0
        oxygen = torch.where(underwater, state.oxygen - 1, state.oxygen)
        now_surfacing = ~underwater & ~state.surfaced
        fatal = now_surfacing & (divers == 0)
        cash_in = now_surfacing & (divers == 6)
        reward = reward + torch.where(cash_in, oxygen.to(torch.float32) * TENTH, 0.0)
        refill = now_surfacing & ~fatal
        divers = _i32(torch.where(refill, torch.where(cash_in, 0, divers - 1), divers))
        oxygen = _i32(torch.where(refill, params.max_oxygen, oxygen))

        new_state = SeaquestState(
            sub_x=sub_x, sub_y=sub_y, sub_or=sub_or, oxygen=oxygen, divers=divers, shot_timer=shot_timer,
            f_exists=f_exists, f_x=f_x, f_y=f_y, f_dir=f_dir, f_timer=f_timer,
            s_exists=s_exists, s_x=s_x, s_y=s_y, s_dir=s_dir, s_timer=s_timer, s_shot_timer=s_shot_timer,
            fb_exists=fb_exists, fb_x=fb_x, fb_y=fb_y, fb_dir=fb_dir,
            eb_exists=eb_exists, eb_x=eb_x, eb_y=eb_y, eb_dir=eb_dir,
            d_exists=d_exists, d_x=d_x, d_y=d_y, d_dir=d_dir, d_timer=d_timer,
            spawn_timer=spawn_timer, diver_spawn_timer=diver_spawn_timer, move_interval=state.move_interval,
            surfaced=~underwater, terminal=state.terminal | hit_enemy | fatal | (oxygen < 0),
            time=state.time + 1,
        )
        done = self.is_terminal(new_state, params)
        return self.get_obs(new_state, params), new_state, reward, done, {}

    def get_obs(self, state: SeaquestState, params: SeaquestParams = None) -> torch.Tensor:
        """The 10 planes (seaquest.py:356-385): the front and back cells of
        the sub, then each pool's entities added up and clamped to 1, and the
        gauges on row 9."""
        params = params or self.default_params
        dev = state.sub_x.device
        idx = torch.arange(10, device=dev)

        def cells(x, y, exists=None):  # (E, n) -> the (E, 10, 10) count board
            on = (idx[:, None] == y[..., None, None]) & (idx == x[..., None, None])
            if exists is None:
                return on.to(torch.float32)
            return (on & exists[..., None, None]).to(torch.float32).sum(1)

        back_x = (state.sub_x + torch.where(state.sub_or == 1, -1, 1)).clamp(0, 9)
        trail_x = (state.fb_x - state.fb_dir).clamp(0, 9)
        oxy_cells = torch.div(state.oxygen * 10, params.max_oxygen, rounding_mode="floor").clamp(0, 9)
        row9 = (idx == 9)[:, None]
        planes = [
            cells(state.sub_x, state.sub_y),
            cells(back_x, state.sub_y),
            cells(state.fb_x, state.fb_y, state.fb_exists),
            cells(trail_x, state.fb_y, state.fb_exists),
            cells(state.s_x, state.s_y, state.s_exists),
            cells(state.eb_x, state.eb_y, state.eb_exists),
            cells(state.f_x, state.f_y, state.f_exists),
            cells(state.d_x, state.d_y, state.d_exists),
            (row9 & (idx < oxy_cells[:, None, None])).to(torch.float32),
            (row9 & (idx < state.divers[:, None, None])).to(torch.float32),
        ]
        return torch.stack(planes, -1).clamp(max=1.0)

    def is_terminal(self, state: SeaquestState, params: SeaquestParams) -> torch.Tensor:
        return state.terminal | (state.time >= params.max_steps_in_episode)

    def observation_space(self, params) -> spaces.Box:
        return spaces.Box(0.0, 1.0, (10, 10, 10))

    def action_space(self, params=None) -> spaces.Discrete:
        return spaces.Discrete(6)
