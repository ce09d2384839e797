"""Kitchen: an Overcooked-class cooperative cooking env.

Port of purejaxql_tpu/envs/marl/kitchen.py, batched. Two agents in a walled
kitchen cook and deliver onion soup: three onions into a pot, the cook
timer, the soup fetched with a plate and delivered at the serving window for
+20 (shaped: +1 an onion in a pot, +3 a soup scooped). Both agents move at
once; same-target and swap moves are blocked; the agents interact in index
order. Items rest on counters (any wall tile) and can be passed over them.
Wall-blocked moves are masked out; noop and interact are always legal.
Fixed-length episodes reset at the horizon (kitchen.py:267-269); the reset
is deterministic and draws nothing.

Layouts are string maps (X wall/counter, P pot, O onion pile, D plate pile,
S serving window, 1/2 agent starts, space floor).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.marl.base import MultiAgentEnv

# tile types
FLOOR, WALL, POT, ONION_PILE, PLATE_PILE, SERVE = range(6)
# held items
H_NONE, H_ONION, H_PLATE, H_SOUP = range(4)
# actions
A_UP, A_DOWN, A_LEFT, A_RIGHT, A_NOOP, A_INTERACT = range(6)
NUM_ACTIONS = 6

_DIRS = ((-1, 0), (1, 0), (0, -1), (0, 1))  # up / down / left / right

LAYOUTS = {
    # the classic 5x4 cramped room: one pot, shared tight floor space
    "cramped_room": [
        "XXPXX",
        "O1 2O",
        "X   X",
        "XDXSX",
    ],
    # ring corridor: pots top-right, piles bottom-left, forced traffic
    "coord_ring": [
        "XXXPX",
        "X 1 P",
        "D X X",
        "O2  X",
        "XOSXX",
    ],
    # asymmetric: only agent 1 reaches the piles, only agent 2 the pots;
    # items must be passed over the middle counter row
    "asymmetric_pass": [
        "XXXXXXX",
        "O 1X2 P",
        "O  X  P",
        "X  X  S",
        "XDXXXXX",
    ],
}

MAX_POTS = 2
COOK_TIME = 20


@dataclass
class KitchenState:
    pos: torch.Tensor  # (E, 2, 2) int32 (y, x)
    facing: torch.Tensor  # (E, 2) int32 0..3
    held: torch.Tensor  # (E, 2) int32 H_*
    pot_onions: torch.Tensor  # (E, MAX_POTS) int32 0..3
    pot_timer: torch.Tensor  # (E, MAX_POTS) int32; > 0 cooking, 0 with 3 onions ready
    counter_items: torch.Tensor  # (E, H, W) int32 H_* items resting on counters
    time: torch.Tensor  # (E,) int32


def _parse_layout(rows: List[str]):
    """(grid (H, W) of tile types, agent starts (2, 2), pots (MAX_POTS, 2),
    the missing pots at (-9, -9))."""
    H, W = len(rows), len(rows[0])
    grid = np.zeros((H, W), np.int32)
    starts = [None, None]
    pots = []
    tiles = {"X": WALL, "P": POT, "O": ONION_PILE, "D": PLATE_PILE, "S": SERVE}
    for y, row in enumerate(rows):
        for x, ch in enumerate(row):
            grid[y, x] = tiles.get(ch, FLOOR)
            if ch == "P":
                pots.append((y, x))
            elif ch in "12":
                starts[int(ch) - 1] = (y, x)
    assert starts[0] and starts[1], "layout needs agent starts 1 and 2"
    assert 1 <= len(pots) <= MAX_POTS, "layout needs 1..MAX_POTS pots"
    while len(pots) < MAX_POTS:
        pots.append((-9, -9))  # unreachable padding slot
    return grid, np.array(starts, np.int32), np.array(pots, np.int32)


class Kitchen(MultiAgentEnv):
    def __init__(
        self,
        layout: str = "cramped_room",
        max_steps: int = 400,
        cook_time: int = COOK_TIME,
        shaped_rewards: bool = True,
    ):
        self.layout_name = layout
        self.grid, self._starts, self._pots = _parse_layout(LAYOUTS[layout])
        self.height, self.width = self.grid.shape
        self.max_steps = max_steps
        self.cook_time = cook_time
        self.shaped_rewards = shaped_rewards
        self.num_agents = 2
        self.agents = ["agent_0", "agent_1"]
        # obs channels: 6 tile types, self and other position, self and other
        # facing (4 each), held items at the agents (3 each), pot onions
        # (normalized), pot ready, pot cooking, counter items (3)
        self.obs_channels = 6 + 2 + 8 + 6 + 3 + 3
        self.obs_dim = self.height * self.width * self.obs_channels

    # ------------------------------------------------------------------
    def reset_draws(self, generator: torch.Generator, num_envs: int) -> torch.Tensor:
        """No randomness: an empty (E, 0) tensor that carries the batch size
        and the device."""
        return torch.empty(num_envs, 0, device=generator.device)

    def reset_env(self, draws: torch.Tensor) -> KitchenState:
        n_envs, dev = draws.shape[0], draws.device

        def zeros(*shape):
            return torch.zeros(n_envs, *shape, dtype=torch.int32, device=dev)

        return KitchenState(
            pos=self.constant("starts", self._starts, dev, torch.int32).expand(n_envs, -1, -1).clone(),
            facing=torch.ones(n_envs, 2, dtype=torch.int32, device=dev),  # face down
            held=zeros(2),
            pot_onions=zeros(MAX_POTS),
            pot_timer=zeros(MAX_POTS),
            counter_items=zeros(self.height, self.width),
            time=zeros(),
        )

    # ------------------------------------------------------------------
    def step_env(self, state: KitchenState, actions: Dict):
        acts = torch.stack([actions[a] for a in self.agents], 1).to(torch.int32)  # (E, 2)
        dev = acts.device
        grid = self.constant("grid", self.grid, dev, torch.long)
        pots = self.constant("pots", self._pots, dev, torch.int32)
        dirs = self.constant("dirs", _DIRS, dev, torch.int32)
        rows = torch.arange(acts.shape[0], device=dev)

        # -- movement (simultaneous, overcooked collision rules) -------------
        is_move = acts < 4
        move_dir = torch.where(is_move, acts, 0)
        facing = torch.where(is_move, move_dir, state.facing)
        prop = state.pos + torch.where(is_move[..., None], dirs[move_dir.long()], 0)
        blocked = grid[prop[..., 0].long(), prop[..., 1].long()] != FLOOR
        prop = torch.where(blocked[..., None], state.pos, prop)
        same_target = (prop[:, 0] == prop[:, 1]).all(1)
        swap = (prop[:, 0] == state.pos[:, 1]).all(1) & (prop[:, 1] == state.pos[:, 0]).all(1)
        pos = torch.where((same_target | swap)[:, None, None], state.pos, prop)

        # -- interact, agent_0 first ----------------------------------------
        held = state.held.clone()
        pot_onions = state.pot_onions.clone()
        pot_timer = state.pot_timer.clone()
        counter_items = state.counter_items.clone()
        reward = torch.zeros(acts.shape[0], device=dev)
        shaped = torch.zeros(acts.shape[0], device=dev)
        for i in range(2):
            do = acts[:, i] == A_INTERACT
            tgt = pos[:, i] + dirs[facing[:, i].long()]
            ty, tx = tgt[:, 0].long(), tgt[:, 1].long()
            tile = grid[ty, tx]
            h = held[:, i].clone()  # held is written below

            pot_here = (pots[:, 0] == ty[:, None]) & (pots[:, 1] == tx[:, None])  # (E, MAX_POTS)
            pot_idx = pot_here.to(torch.int32).argmax(1, keepdim=True)
            at_pot = do & pot_here.any(1)
            onions = pot_onions.gather(1, pot_idx)[:, 0]

            take_onion = do & (tile == ONION_PILE) & (h == H_NONE)
            take_plate = do & (tile == PLATE_PILE) & (h == H_NONE)
            drop_onion = at_pot & (h == H_ONION) & (onions < 3)
            ready = (onions == 3) & (pot_timer.gather(1, pot_idx)[:, 0] == 0)
            take_soup = at_pot & (h == H_PLATE) & ready
            deliver = do & (tile == SERVE) & (h == H_SOUP)
            c_item = counter_items[rows, ty, tx]
            place = do & (tile == WALL) & (h != H_NONE) & (c_item == H_NONE)
            pick = do & (tile == WALL) & (h == H_NONE) & (c_item != H_NONE)

            new_h = h
            new_h = torch.where(take_onion, H_ONION, new_h)
            new_h = torch.where(take_plate, H_PLATE, new_h)
            new_h = torch.where(drop_onion, H_NONE, new_h)
            new_h = torch.where(take_soup, H_SOUP, new_h)
            new_h = torch.where(deliver, H_NONE, new_h)
            new_h = torch.where(place, H_NONE, new_h)
            new_h = torch.where(pick, c_item, new_h)
            held[:, i] = new_h

            onions = onions + (at_pot & drop_onion).to(torch.int32)
            # cooking starts when the third onion lands
            start_cook = drop_onion & (onions == 3)
            timer = torch.where(start_cook, self.cook_time, pot_timer.gather(1, pot_idx)[:, 0])
            pot_timer.scatter_(1, pot_idx, timer[:, None].to(torch.int32))
            # scooping empties the pot
            onions = torch.where(take_soup, 0, onions)
            pot_onions.scatter_(1, pot_idx, onions[:, None].to(torch.int32))

            counter_items[rows, ty, tx] = torch.where(place, h, torch.where(pick, H_NONE, c_item))

            reward = reward + torch.where(deliver, 20.0, 0.0)
            shaped = shaped + torch.where(drop_onion, 1.0, 0.0)
            shaped = shaped + torch.where(take_soup, 3.0, 0.0)

        # pots cook down
        pot_timer = torch.clamp(pot_timer - (pot_onions == 3).to(torch.int32), min=0)
        if self.shaped_rewards:
            reward = reward + shaped

        t = state.time + 1
        stepped = KitchenState(
            pos=pos, facing=facing, held=held, pot_onions=pot_onions, pot_timer=pot_timer,
            counter_items=counter_items, time=t,
        )
        return stepped, reward, t >= self.max_steps, {}

    # ------------------------------------------------------------------
    def get_avail_actions(self, state: KitchenState) -> Dict[str, torch.Tensor]:
        """Wall-blocked moves are illegal; noop and interact always legal."""
        dev = state.pos.device
        grid = self.constant("grid", self.grid, dev, torch.long)
        tgts = (state.pos[:, :, None, :] + self.constant("dirs", _DIRS, dev, torch.int32)).long()  # (E, 2, 4, 2)
        ok = (grid[tgts[..., 0], tgts[..., 1]] == FLOOR).float()
        mask = torch.cat([ok, torch.ones(*ok.shape[:2], 2, device=dev)], 2)
        return {a: mask[:, i] for i, a in enumerate(self.agents)}

    # ------------------------------------------------------------------
    def get_obs(self, state: KitchenState) -> Dict[str, torch.Tensor]:
        dev = state.pos.device
        n_envs = state.pos.shape[0]
        H, W = self.height, self.width
        one_hot = torch.nn.functional.one_hot
        static = self.constant("static", np.eye(6, dtype=np.float32)[self.grid], dev).expand(n_envs, -1, -1, -1)

        pot_norm = torch.zeros(n_envs, H, W, device=dev)
        pot_ready = torch.zeros(n_envs, H, W, device=dev)
        pot_cooking = torch.zeros(n_envs, H, W, device=dev)
        for p, (py, px) in enumerate(self._pots.tolist()):
            if py < 0:  # a padding slot: nothing to show
                continue
            onions, timer = state.pot_onions[:, p], state.pot_timer[:, p]
            pot_norm[:, py, px] = onions / 3.0
            pot_ready[:, py, px] = ((onions == 3) & (timer == 0)).float()
            pot_cooking[:, py, px] = (timer > 0).float()
        counter = one_hot(state.counter_items.long(), 4)[..., 1:].float()  # (E, H, W, 3)

        rows = torch.arange(n_envs, device=dev)
        at = []
        for i in range(2):
            plane = torch.zeros(n_envs, H, W, device=dev)
            plane[rows, state.pos[:, i, 0].long(), state.pos[:, i, 1].long()] = 1.0
            at.append(plane[..., None])
        face = [at[i] * one_hot(state.facing[:, i].long(), 4)[:, None, None, :].float() for i in range(2)]
        held = [at[i] * one_hot(state.held[:, i].long(), 4)[:, None, None, 1:].float() for i in range(2)]
        pots = [pot_norm[..., None], pot_ready[..., None], pot_cooking[..., None], counter]

        def agent_view(me, other):
            return torch.cat(
                [static, at[me], at[other], face[me], face[other], held[me], held[other], *pots], -1
            ).reshape(n_envs, -1)

        return {"agent_0": agent_view(0, 1), "agent_1": agent_view(1, 0)}

    def observation_space(self, agent: str) -> spaces.Box:
        return spaces.Box(0.0, 1.0, (self.obs_dim,))

    def action_space(self, agent: str) -> spaces.Discrete:
        return spaces.Discrete(NUM_ACTIONS)
