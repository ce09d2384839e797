"""Forager: the craftax-class open-world survival and crafting env, batched
over E envs.

Port of purejaxql_tpu/envs/gridworld/forager.py (its docstring describes the
game): procedurally generated five-floor worlds (``worldgen.py``), resources
gated by tool tiers, crafting at stations, hunger, thirst, energy and health,
a day-night cycle with hostile mobs, bosses, a bow, two spells, potions whose
colour-to-effect map is permuted every episode, enchanting, armor and an XP
ladder; 65 achievements (+1 each the first time in an episode) and +-0.1 per
health point gained or lost. Observations (E, 2883) float32: a 9x9 one-hot
view of blocks and mobs, then inventory, needs and mana, facing, time of day,
sleep, floor depth, XP and the potions tried. 34 actions.

Where the JAX step reads the map through one-hot selector matmuls (a TPU
device trick), this one gathers: the values are the same small integers. The
JAX step reads every map cell near the player from a 17x17 patch around the
position the step started at, and a cell farther than 8 from it reads
INVALID there (a zombie spawn up to 9 away after a move): ``_patch_read``
keeps that rule.

Randomness comes in as draws, so the tests can feed in the JAX env's own:
``step_draws`` is the step's one (E, 26 + 3 * 43) uniform block, in the
column layout of forager.py:575-581; ``reset_draws`` holds every draw of a
reset (the worlds', the mobs' candidate cells, the potion permutation).

Divisions by a constant are products with the float32 reciprocal, as the
compiled JAX env computes them (XLA folds them so): the obs's / 9, / MAX_MANA
and / day_length, the chest's / 0.28.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, fields
from types import SimpleNamespace

import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.base import Environment
from purejaxql_torch.envs.gridworld import worldgen as W

ACHIEVEMENTS = [
    "collect_wood", "place_table", "eat_cow", "collect_sapling",
    "collect_drink", "make_wood_pickaxe", "make_wood_sword", "place_plant",
    "defeat_zombie", "collect_stone", "place_stone", "eat_plant",
    "defeat_skeleton", "collect_coal", "make_stone_pickaxe",
    "make_stone_sword", "wake_up", "place_furnace", "collect_iron",
    "make_iron_pickaxe", "make_iron_sword", "collect_diamond", "enter_cave",
    "enter_deep", "collect_ruby", "collect_sapphire",
    "make_diamond_pickaxe", "make_diamond_sword", "make_bow", "make_arrow",
    "fire_bow", "defeat_orc", "defeat_warden", "enter_hell",
    "collect_obsidian", "open_chest", "drink_potion", "learn_spell",
    "cast_spell", "defeat_demon", "defeat_necromancer",
    "make_iron_armor", "make_diamond_armor", "fireball_kill", "marksman",
    "collect_all_gems", "slay_all_bosses", "full_belly",
    "place_torch", "place_enchant_table", "enchant_sword", "enchant_bow",
    "enchant_armor", "enter_ice", "collect_crystal", "defeat_bat",
    "defeat_wraith", "defeat_ice_queen", "learn_ice_spell",
    "cast_ice_spell", "ice_kill", "drink_all_potions", "level_up",
    "veteran", "craft_all_tools",
]
NUM_ACHIEVEMENTS = len(ACHIEVEMENTS)
_ACH = {name: i for i, name in enumerate(ACHIEVEMENTS)}

# ---- the mob table: every species in one (N_MOBS,) table of static slots --
(
    MOB_COW, MOB_ZOMBIE, MOB_SKEL, MOB_ORC, MOB_WARDEN, MOB_DEMON,
    MOB_NECRO, MOB_BAT, MOB_WRAITH, MOB_QUEEN,
) = range(10)
NUM_MOB_TYPES = 10
N_COWS = 8
N_ZOMBIES = 8
N_SKELETONS = 8
N_ORCS = 4
N_DEMONS = 4
N_BATS = 4
N_WRAITHS = 4
COWS = slice(0, 8)
ZOMBIES = slice(8, 16)
SKELS = slice(16, 24)
ORCS = slice(24, 28)
WARDEN = 28
DEMONS = slice(29, 33)
NECRO = 33
BATS = slice(34, 38)
WRAITHS = slice(38, 42)
QUEEN = 42
N_MOBS = 43
MOB_TYPE = (
    [MOB_COW] * N_COWS + [MOB_ZOMBIE] * N_ZOMBIES + [MOB_SKEL] * N_SKELETONS
    + [MOB_ORC] * N_ORCS + [MOB_WARDEN] + [MOB_DEMON] * N_DEMONS
    + [MOB_NECRO] + [MOB_BAT] * N_BATS + [MOB_WRAITH] * N_WRAITHS
    + [MOB_QUEEN]
)
_SPAWN_HEALTH = [3, 5, 3, 8, 20, 10, 30, 1, 8, 30]
_MELEE_DMG = [0, 1, 1, 2, 3, 3, 4, 1, 3, 4]
# chance a step of a chase step toward the player (on the player's floor only)
_CHASE_P = [0.0, 0.7, 0.0, 0.6, 1.0, 0.8, 1.0, 0.3, 0.8, 1.0]
# random-walk chance on the player's floor / elsewhere
_WALK_P_SAME = [0.3, 0.0, 0.2, 0.0, 0.0, 0.0, 0.0, 0.5, 0.0, 0.0]
_WALK_P_AWAY = [0.3, 0.0, 0.2, 0.25, 0.0, 0.25, 0.0, 0.5, 0.25, 0.0]
# first-kill achievement per mob type (a cow kill feeds you)
_MOB_ACH_IDS = [
    _ACH["eat_cow"], _ACH["defeat_zombie"], _ACH["defeat_skeleton"],
    _ACH["defeat_orc"], _ACH["defeat_warden"], _ACH["defeat_demon"],
    _ACH["defeat_necromancer"], _ACH["defeat_bat"],
    _ACH["defeat_wraith"], _ACH["defeat_ice_queen"],
]
_XP_PER_KILL = [0, 1, 1, 2, 5, 2, 5, 1, 2, 5]
XP_PER_LEVEL = 8
MAX_PLAYER_LEVEL = 5

# derived achievements, in the order of the `derived` stack in step_env
_DERIVED_IDS = [
    _ACH["fireball_kill"], _ACH["marksman"], _ACH["collect_all_gems"],
    _ACH["slay_all_bosses"], _ACH["full_belly"], _ACH["ice_kill"],
    _ACH["drink_all_potions"], _ACH["level_up"], _ACH["veteran"],
    _ACH["craft_all_tools"],
]

INV = {
    "wood": 0, "stone": 1, "coal": 2, "iron": 3, "diamond": 4, "sapling": 5,
    "wood_pickaxe": 6, "stone_pickaxe": 7, "iron_pickaxe": 8,
    "wood_sword": 9, "stone_sword": 10, "iron_sword": 11, "ruby": 12,
    "diamond_pickaxe": 13, "diamond_sword": 14, "bow": 15, "arrow": 16,
    "sapphire": 17, "obsidian": 18,
    "potion_red": 19, "potion_green": 20, "potion_blue": 21,
    "spellbook": 22, "iron_armor": 23, "diamond_armor": 24,
    "crystal": 25, "frost_tome": 26,
    "sword_enchant": 27, "bow_enchant": 28, "armor_enchant": 29,
}
NUM_INV = 30

A_NOOP, A_LEFT, A_RIGHT, A_UP, A_DOWN, A_DO, A_SLEEP = range(7)
A_PLACE_STONE, A_PLACE_TABLE, A_PLACE_FURNACE, A_PLACE_PLANT = 7, 8, 9, 10
A_MAKE_WP, A_MAKE_SP, A_MAKE_IP, A_MAKE_WS, A_MAKE_SS, A_MAKE_IS = range(11, 17)
A_MAKE_DP, A_MAKE_DS, A_MAKE_BOW, A_MAKE_ARROW, A_SHOOT = range(17, 22)
A_DRINK_RED, A_DRINK_GREEN, A_DRINK_BLUE, A_CAST = range(22, 26)
A_MAKE_IA, A_MAKE_DA = 26, 27
A_PLACE_TORCH, A_PLACE_ENCHANT = 28, 29
A_ENCH_SWORD, A_ENCH_BOW, A_ENCH_ARMOR, A_CAST_ICE = range(30, 34)
NUM_ACTIONS = 34

ARROW_RANGE = 5
ARROW_DAMAGE = 3
ARROWS_PER_CRAFT = 3
MAX_ARROWS = 9
NUM_POTIONS = 3
POTION_HEAL, POTION_FEAST, POTION_POISON = range(3)
SPELL_COST = 4
SPELL_DAMAGE = 5
ICE_COST = 2
ICE_DAMAGE = 3
MAX_MANA = 9
ENCHANT_COST = 3


def _cost_row(costs):
    row = [0] * NUM_INV
    for item, n in costs:
        row[INV[item]] = n
    return row


# (action, output slot, costs, needs furnace, achievement)
_CRAFT_SPECS = [
    (A_MAKE_WP, "wood_pickaxe", [("wood", 1)], False, "make_wood_pickaxe"),
    (A_MAKE_SP, "stone_pickaxe", [("wood", 1), ("stone", 1)], False, "make_stone_pickaxe"),
    (A_MAKE_IP, "iron_pickaxe", [("wood", 1), ("coal", 1), ("iron", 1)], True, "make_iron_pickaxe"),
    (A_MAKE_WS, "wood_sword", [("wood", 1)], False, "make_wood_sword"),
    (A_MAKE_SS, "stone_sword", [("wood", 1), ("stone", 1)], False, "make_stone_sword"),
    (A_MAKE_IS, "iron_sword", [("wood", 1), ("coal", 1), ("iron", 1)], True, "make_iron_sword"),
    (A_MAKE_DP, "diamond_pickaxe", [("wood", 1), ("diamond", 2)], True, "make_diamond_pickaxe"),
    (A_MAKE_DS, "diamond_sword", [("wood", 1), ("diamond", 1)], True, "make_diamond_sword"),
    (A_MAKE_BOW, "bow", [("wood", 2)], False, "make_bow"),
    (A_MAKE_IA, "iron_armor", [("iron", 3), ("coal", 1)], True, "make_iron_armor"),
    (A_MAKE_DA, "diamond_armor", [("diamond", 2), ("iron", 1)], True, "make_diamond_armor"),
]
# (action, placed block, costs, needs grass, achievement)
_PLACE_SPECS = [
    (A_PLACE_STONE, W.STONE, [("stone", 1)], False, "place_stone"),
    (A_PLACE_TABLE, W.TABLE, [("wood", 2)], False, "place_table"),
    (A_PLACE_FURNACE, W.FURNACE, [("stone", 2)], False, "place_furnace"),
    (A_PLACE_PLANT, W.SAPLING, [("sapling", 1)], True, "place_plant"),
    (A_PLACE_TORCH, W.TORCH, [("wood", 1), ("coal", 1)], False, "place_torch"),
    (A_PLACE_ENCHANT, W.ENCHANT_TABLE, [("stone", 1), ("diamond", 1)], False, "place_enchant_table"),
]
_PLACE_PLANT_ROW = 3
# (action, enchant mark slot, gem slot, achievement)
_ENCH_SPECS = [
    (A_ENCH_SWORD, "sword_enchant", "ruby", "enchant_sword"),
    (A_ENCH_BOW, "bow_enchant", "sapphire", "enchant_bow"),
    (A_ENCH_ARMOR, "armor_enchant", "crystal", "enchant_armor"),
]
# mined resources, in the order of the `collected` stack in step_env
_COLLECT_ITEMS = [
    "wood", "sapling", "stone", "coal", "iron", "diamond", "ruby",
    "sapphire", "obsidian", "crystal",
]
# direction vectors: 0 up, 1 right, 2 down, 3 left (dy, dx)
_DIRS = [[-1, 0], [0, 1], [1, 0], [0, -1]]
_WALKABLE_IDS = [W.GRASS, W.SAND, W.PATH, W.SAPLING, W.PLANT_RIPE, W.ICE]
_PLACEABLE_IDS = [W.GRASS, W.SAND, W.PATH, W.ICE]

VIEW = 9
OBS_DIM = (
    VIEW * VIEW * (W.NUM_BLOCK_TYPES + NUM_MOB_TYPES)
    + NUM_INV + 5 + 4 + 2 + 1 + 1 + 2 + NUM_POTIONS
)
# the 17x17 patch of the JAX step's map reads: +-8 around the start position
_PATCH_RADIUS = 8
# the step's uniform block: 26 scalars, then three per mob
NUM_STEP_DRAWS = 26 + 3 * N_MOBS


def _f32_recip(c: float) -> float:
    """The float32 reciprocal of a float32 constant, as a Python float."""
    return (torch.tensor(1.0) / torch.tensor(c)).item()


_R9 = _f32_recip(9.0)
_R_MANA = _f32_recip(float(MAX_MANA))
_R_CHEST = _f32_recip(0.28)
_TWO_PI = 2 * math.pi


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> SimpleNamespace:
    """The step's constant tables on ``device``."""
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=device)  # noqa: E731
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    eye_inv = torch.eye(NUM_INV, dtype=torch.int32, device=device)
    mob_type = torch.tensor(MOB_TYPE, device=device)
    ench_mark = [INV[s[1]] for s in _ENCH_SPECS]
    ench_gem = [INV[s[2]] for s in _ENCH_SPECS]
    walkable = torch.zeros(W.NUM_BLOCK_TYPES, dtype=torch.bool, device=device)
    walkable[_WALKABLE_IDS] = True
    placeable = torch.zeros(W.NUM_BLOCK_TYPES, dtype=torch.bool, device=device)
    placeable[_PLACEABLE_IDS] = True
    arrow_delta = torch.zeros(NUM_INV, dtype=torch.int32, device=device)
    arrow_delta[[INV["wood"], INV["stone"]]] = -1
    arrow_delta[INV["arrow"]] = ARROWS_PER_CRAFT
    return SimpleNamespace(
        mob_type=mob_type,
        type_onehot=(mob_type[:, None] == torch.arange(NUM_MOB_TYPES, device=device)).float(),
        spawn_health=i32(_SPAWN_HEALTH)[mob_type],
        melee_dmg=i32(_MELEE_DMG)[mob_type],
        chase_p=f32(_CHASE_P)[mob_type],
        walk_same=f32(_WALK_P_SAME)[mob_type],
        walk_away=f32(_WALK_P_AWAY)[mob_type],
        xp_per_kill=i32(_XP_PER_KILL)[mob_type],
        mob_ach=torch.eye(NUM_ACHIEVEMENTS, device=device)[_MOB_ACH_IDS],
        derived_ach=torch.eye(NUM_ACHIEVEMENTS, device=device)[_DERIVED_IDS],
        eye_ach=torch.eye(NUM_ACHIEVEMENTS, device=device),
        craft_act=i32([s[0] for s in _CRAFT_SPECS]),
        craft_out=torch.tensor([INV[s[1]] for s in _CRAFT_SPECS], device=device),
        craft_out_onehot=eye_inv[[INV[s[1]] for s in _CRAFT_SPECS]],
        craft_cost=i32([_cost_row(s[2]) for s in _CRAFT_SPECS]),
        craft_furnace=torch.tensor([s[3] for s in _CRAFT_SPECS], device=device),
        place_act=i32([s[0] for s in _PLACE_SPECS]),
        place_tile=i32([s[1] for s in _PLACE_SPECS]),
        place_cost=i32([_cost_row(s[2]) for s in _PLACE_SPECS]),
        place_grass=torch.tensor([s[3] for s in _PLACE_SPECS], device=device),
        ench_act=i32([s[0] for s in _ENCH_SPECS]),
        ench_mark=torch.tensor(ench_mark, device=device),
        ench_gem=torch.tensor(ench_gem, device=device),
        ench_delta=eye_inv[ench_mark] - eye_inv[ench_gem],
        collect_onehot=i32([_cost_row([(i, 1)]) for i in _COLLECT_ITEMS]),
        arrow_delta=arrow_delta,
        arrow_onehot=eye_inv[INV["arrow"]],
        dirs=i32(_DIRS),
        walkable=walkable,
        placeable=placeable,
    )


@dataclass
class ForagerState:
    blocks: torch.Tensor  # (E, NUM_LEVELS, 56, 56) int8 floor stack
    growth: torch.Tensor  # (E, 56, 56) int8 sapling growth timers (surface only)
    pos: torch.Tensor  # (E, 2) int32 (y, x) in padded coordinates
    level: torch.Tensor  # (E,) int32: 0 surface ... 4 ice realm
    facing: torch.Tensor  # (E,) int32 0..3
    health: torch.Tensor  # (E,) int32
    food: torch.Tensor
    drink: torch.Tensor
    energy: torch.Tensor
    hunger: torch.Tensor  # accumulators
    thirst: torch.Tensor
    fatigue: torch.Tensor
    decay_tick: torch.Tensor
    regen_tick: torch.Tensor
    sleeping: torch.Tensor  # (E,) bool
    mana: torch.Tensor  # (E,) int32
    xp: torch.Tensor
    potion_map: torch.Tensor  # (E, 3) int32 colour -> effect permutation
    potions_tried: torch.Tensor  # (E, 3) bool
    inventory: torch.Tensor  # (E, NUM_INV) int32
    achievements: torch.Tensor  # (E, NUM_ACHIEVEMENTS) bool
    mob_pos: torch.Tensor  # (E, N_MOBS, 2) int32, padded coordinates
    mob_level: torch.Tensor  # (E, N_MOBS) int32
    mob_alive: torch.Tensor  # (E, N_MOBS) bool
    mob_health: torch.Tensor  # (E, N_MOBS) int32
    time: torch.Tensor  # (E,) int32
    terminal: torch.Tensor  # (E,) bool


_STATE_DTYPES = {f.name: torch.int32 for f in fields(ForagerState)}
_STATE_DTYPES.update(
    blocks=torch.int8, growth=torch.int8, sleeping=torch.bool, potions_tried=torch.bool,
    achievements=torch.bool, mob_alive=torch.bool, terminal=torch.bool,
)


@dataclass(frozen=True)
class ForagerParams:
    day_length: int = 300
    growth_time: int = 60
    max_steps_in_episode: int = 10000


@dataclass
class ForagerResetDraws:
    """Every random input of a reset of n envs (forager.py:383-551): the
    worlds', then candidate cells for each mob (in [lo, hi) of padded
    coordinates), and the potion permutation."""

    world: W.WorldDraws
    cow: torch.Tensor  # (n, 8, 2) in [PAD + 4, PAD + 44)
    skel: torch.Tensor  # (n, 8, 2) in [PAD + 2, PAD + 46)
    orc: torch.Tensor  # (n, 4, 8, 2): 8 candidates a mob, [PAD + 2, PAD + 46)
    warden: torch.Tensor  # (n, 8, 2) candidates, [PAD + 4, PAD + 44)
    demon: torch.Tensor  # (n, 4, 8, 2), [PAD + 2, PAD + 46)
    necro: torch.Tensor  # (n, 8, 2), [PAD + 4, PAD + 44)
    potion_map: torch.Tensor  # (n, 3) a permutation of 0, 1, 2
    bat: torch.Tensor  # (n, 4, 2), [PAD + 2, PAD + 46)
    wraith: torch.Tensor  # (n, 4, 8, 2), [PAD + 2, PAD + 46)
    queen: torch.Tensor  # (n, 8, 2), [PAD + 4, PAD + 44)


_INNER = (W.PAD + 2, W.PAD + W.WORLD_SIZE - 2)
_CORE = (W.PAD + 4, W.PAD + W.WORLD_SIZE - 4)


def _first_open(cands: torch.Tensor, is_open: torch.Tensor):
    """The first open candidate cell of each mob (the first candidate if none
    is open) and whether it is open: cands (..., 8, 2), is_open (..., 8)."""
    pick = is_open.to(torch.int32).argmax(-1, keepdim=True)
    pos = cands.gather(-2, pick[..., None].expand(*pick.shape, 2)).squeeze(-2)
    return pos, is_open.gather(-1, pick).squeeze(-1)


class Forager(Environment):
    def __init__(self, log_achievements: bool = False):
        # per-achievement info keys (65 more scalars a step) are opt-in, as
        # the JAX env's LOG_ACHIEVEMENTS
        self.log_achievements = log_achievements

    @property
    def default_params(self) -> ForagerParams:
        return ForagerParams()

    @property
    def name(self) -> str:
        return "Forager-v0"

    def observation_space(self, params):
        return spaces.Box(-1.0, 1.0, (OBS_DIM,), torch.float32)

    def action_space(self, params=None):
        return spaces.Discrete(NUM_ACTIONS)

    # ------------------------------------------------------------------
    def reset_draws(self, generator: torch.Generator, num_envs: int) -> ForagerResetDraws:
        dev = generator.device
        cells = lambda rng, *shape: torch.randint(  # noqa: E731
            *rng, (num_envs, *shape, 2), generator=generator, device=dev, dtype=torch.int32
        )
        world = W.worldgen_draws(generator, num_envs)
        return ForagerResetDraws(
            world=world,
            cow=cells(_CORE, N_COWS), skel=cells(_INNER, N_SKELETONS),
            orc=cells(_INNER, N_ORCS, 8), warden=cells(_CORE, 8),
            demon=cells(_INNER, N_DEMONS, 8), necro=cells(_CORE, 8),
            potion_map=torch.rand(num_envs, NUM_POTIONS, generator=generator, device=dev)
            .argsort(-1).to(torch.int32),
            bat=cells(_INNER, N_BATS), wraith=cells(_INNER, N_WRAITHS, 8), queen=cells(_CORE, 8),
        )

    def reset_env(self, generator, num_envs, params):
        return self.reset_from_draws(self.reset_draws(generator, num_envs), params)

    def reset_from_draws(self, d: ForagerResetDraws, params):
        blocks = W.generate_world(d.world)
        n, dev = blocks.shape[0], blocks.device
        T = _tables(dev)
        rows = torch.arange(n, device=dev)
        i32 = lambda v, *shape: torch.full((n, *shape), v, dtype=torch.int32, device=dev)  # noqa: E731

        def tile(level, cells):
            """blocks[level, y, x] of (n, ..., 2) cells; ``level`` an int or (n, k)."""
            r = rows.view(n, *[1] * (cells.dim() - 2))
            return blocks[r, level, cells[..., 0].long(), cells[..., 1].long()]

        skel_level = torch.tensor([W.CAVE, W.DEEP] * (N_SKELETONS // 2), dtype=torch.int32, device=dev)
        orc_pos, orc_open = _first_open(d.orc, tile(W.DEEP, d.orc) == W.PATH)
        warden_pos, warden_open = _first_open(d.warden, tile(W.DEEP, d.warden) == W.PATH)
        demon_pos, demon_open = _first_open(d.demon, tile(W.HELL, d.demon) == W.PATH)
        necro_pos, necro_open = _first_open(d.necro, tile(W.HELL, d.necro) == W.PATH)
        wraith_pos, wraith_open = _first_open(d.wraith, tile(W.ICE_REALM, d.wraith) == W.ICE)
        queen_pos, queen_open = _first_open(d.queen, tile(W.ICE_REALM, d.queen) == W.ICE)
        mob_pos = torch.cat([
            d.cow, i32(0, N_ZOMBIES, 2), d.skel, orc_pos, warden_pos[:, None], demon_pos,
            necro_pos[:, None], d.bat, wraith_pos, queen_pos[:, None],
        ], 1).to(torch.int32)
        level_of = [W.SURFACE] * N_COWS + [0] * N_ZOMBIES + [0] * N_SKELETONS + [W.DEEP] * (N_ORCS + 1) \
            + [W.HELL] * (N_DEMONS + 1) + [W.CAVE] * N_BATS + [W.ICE_REALM] * (N_WRAITHS + 1)
        mob_level = torch.tensor(level_of, dtype=torch.int32, device=dev).repeat(n, 1)
        mob_level[:, SKELS] = skel_level
        mob_alive = torch.cat([
            tile(W.SURFACE, d.cow) == W.GRASS,
            torch.zeros(n, N_ZOMBIES, dtype=torch.bool, device=dev),
            tile(skel_level.long()[None].expand(n, -1), d.skel) == W.PATH,
            orc_open, warden_open[:, None], demon_open, necro_open[:, None],
            tile(W.CAVE, d.bat) == W.PATH, wraith_open, queen_open[:, None],
        ], 1)
        c = W.PAD + W.WORLD_SIZE // 2
        false = torch.zeros(n, dtype=torch.bool, device=dev)
        state = ForagerState(
            blocks=blocks,
            growth=torch.zeros_like(blocks[:, W.SURFACE]),
            pos=i32(c, 2), level=i32(W.SURFACE), facing=i32(2),
            health=i32(9), food=i32(9), drink=i32(9), energy=i32(9),
            hunger=i32(0), thirst=i32(0), fatigue=i32(0), decay_tick=i32(0), regen_tick=i32(0),
            sleeping=false, mana=i32(0), xp=i32(0),
            potion_map=d.potion_map.to(torch.int32),
            potions_tried=torch.zeros(n, NUM_POTIONS, dtype=torch.bool, device=dev),
            inventory=i32(0, NUM_INV),
            achievements=torch.zeros(n, NUM_ACHIEVEMENTS, dtype=torch.bool, device=dev),
            mob_pos=mob_pos, mob_level=mob_level, mob_alive=mob_alive,
            mob_health=T.spawn_health.repeat(n, 1),
            time=i32(0), terminal=false,
        )
        return self.get_obs(state, params), state

    # ------------------------------------------------------------------
    def step_draws(self, generator, num_envs):
        return torch.rand(num_envs, NUM_STEP_DRAWS, generator=generator, device=generator.device)

    def step_env(self, state: ForagerState, action: torch.Tensor, params, draws: torch.Tensor):
        dev = draws.device
        T = _tables(dev)
        E = action.shape[0]
        rows = torch.arange(E, device=dev)
        action = action.to(torch.int32)
        u_sap, u_chest = draws[:, 0], draws[:, 1]
        u_zoff = draws[:, 2:18].reshape(E, N_ZOMBIES, 2)
        u_zgate = draws[:, 18:26]
        u_dirs = draws[:, 26 : 26 + N_MOBS]
        u_chase = draws[:, 26 + N_MOBS : 26 + 2 * N_MOBS]
        u_walk = draws[:, 26 + 2 * N_MOBS :]
        inv = state.inventory
        ach_ids, ach_conds = [], []

        def grant(name, cond):
            ach_ids.append(_ACH[name])
            ach_conds.append(cond)

        def col(x, *names):
            return [x[:, INV[k]] for k in names]

        def patch_read(ys, xs):
            """state.blocks at the start level for (E, ...) cells near the start
            position; farther than _PATCH_RADIUS reads INVALID, as the JAX
            step's patch does."""
            shape = (E,) + (1,) * (ys.dim() - 1)
            py, px = state.pos[:, 0].view(shape), state.pos[:, 1].view(shape)
            near = ((ys - py).abs() <= _PATCH_RADIUS) & ((xs - px).abs() <= _PATCH_RADIUS)
            last = W.PADDED_SIZE - 1
            vals = state.blocks[
                rows.view(shape), state.level.view(shape).long(),
                ys.clamp(0, last).long(), xs.clamp(0, last).long(),
            ]
            return torch.where(near, vals.to(torch.int32), 0)

        # ---- movement / facing
        sleeping = state.sleeping & (action == A_NOOP)
        is_move = (action >= A_LEFT) & (action <= A_DOWN)
        move_dir = torch.where(
            action == A_UP, 0, torch.where(action == A_RIGHT, 1, torch.where(action == A_DOWN, 2, 3))
        )
        facing = torch.where(is_move, move_dir, state.facing).to(torch.int32)
        step_vec = T.dirs[facing.long()]
        new_pos = state.pos + step_vec
        target_walkable = T.walkable[patch_read(new_pos[:, 0], new_pos[:, 1]).long()]
        pos = torch.where((is_move & target_walkable)[:, None], new_pos, state.pos)
        tgt = pos + step_vec
        ty, tx = tgt[:, 0], tgt[:, 1]
        tblock = patch_read(ty, tx)

        # ---- the mob on the target tile
        lvl = state.level
        here = (
            state.mob_alive & (state.mob_level == lvl[:, None])
            & (state.mob_pos[..., 0] == ty[:, None]) & (state.mob_pos[..., 1] == tx[:, None])
        )
        any_mob = here.any(1)

        # ---- DO: combat first, else the block
        do = (action == A_DO) & ~sleeping
        plevel = 1 + torch.clamp(state.xp // XP_PER_LEVEL, max=MAX_PLAYER_LEVEL - 1)
        ws, ss, is_, ds, se = col(inv, "wood_sword", "stone_sword", "iron_sword", "diamond_sword", "sword_enchant")
        sword = 1 + ws + ss * 2 + is_ * 3 + ds * 4 + (plevel - 1) + 2 * se
        hit = here & do[:, None]
        mob_health = torch.where(hit, state.mob_health - sword[:, None], state.mob_health)
        melee_killed = hit & (mob_health <= 0)
        mob_alive = state.mob_alive & ~melee_killed
        killed_type = (melee_killed.float() @ T.type_onehot) > 0
        food = torch.where(killed_type[:, MOB_COW], torch.clamp(state.food + 6, max=9), state.food)
        mob_kill_types = killed_type

        do_block = do & ~any_mob
        has_wp, has_sp, has_ip, has_dp = (
            c > 0 for c in col(inv, "wood_pickaxe", "stone_pickaxe", "iron_pickaxe", "diamond_pickaxe")
        )
        on = lambda block: do_block & (tblock == block)  # noqa: E731
        got_wood = on(W.TREE)
        got_drink = on(W.WATER)
        got_sapling = on(W.GRASS) & (u_sap < 0.1)
        got_stone = on(W.STONE) & has_wp
        got_coal = on(W.COAL) & has_wp
        got_iron = on(W.IRON) & has_sp
        got_diamond = on(W.DIAMOND) & has_ip
        got_ruby = on(W.RUBY) & has_ip
        got_sapphire = on(W.SAPPHIRE) & has_dp
        got_obsidian = on(W.OBSIDIAN) & has_dp
        got_crystal = on(W.CRYSTAL) & has_dp
        ate_plant = on(W.PLANT_RIPE)
        went_down = on(W.LADDER_DOWN)
        went_up = on(W.LADDER_UP)
        lvl = torch.where(went_down, lvl + 1, torch.where(went_up, lvl - 1, lvl))
        grant("enter_cave", went_down & (state.level == W.SURFACE))
        grant("enter_deep", went_down & (state.level == W.CAVE))
        grant("enter_hell", went_down & (state.level == W.DEEP))
        grant("enter_ice", went_down & (state.level == W.HELL))

        # loot chests: a potion colour (p .28 each) or, else, a book: the
        # spellbook, or the frost tome on the ice floor
        opened_chest = on(W.CHEST)
        loot_color = torch.clamp(torch.floor(u_chest * _R_CHEST).to(torch.int32), max=NUM_POTIONS)
        on_ice_floor = state.level == W.ICE_REALM
        book_slot = torch.where(on_ice_floor, INV["frost_tome"], INV["spellbook"])
        loot_slot = torch.where(loot_color < NUM_POTIONS, INV["potion_red"] + loot_color, book_slot)
        got_book = opened_chest & (loot_color == NUM_POTIONS)
        inv = inv + torch.nn.functional.one_hot(loot_slot.long(), NUM_INV).to(torch.int32) * opened_chest[:, None]
        for book in ("spellbook", "frost_tome"):  # books don't stack
            inv[:, INV[book]] = torch.clamp(inv[:, INV[book]], max=1)
        grant("open_chest", opened_chest)
        grant("learn_spell", got_book & ~on_ice_floor)
        grant("learn_ice_spell", got_book & on_ice_floor)

        collected = torch.stack([
            got_wood, got_sapling, got_stone, got_coal, got_iron,
            got_diamond, got_ruby, got_sapphire, got_obsidian, got_crystal,
        ], 1)
        inv = inv + (T.collect_onehot * collected[:, :, None]).sum(1, dtype=torch.int32)
        drink = torch.where(got_drink, torch.clamp(state.drink + 3, max=9), state.drink)
        food = torch.where(ate_plant, torch.clamp(food + 4, max=9), food)
        mined = (
            got_stone | got_coal | got_iron | got_diamond | got_ruby
            | got_sapphire | got_obsidian | got_crystal | opened_chest
        )
        for cond, name in [
            (got_wood, "collect_wood"), (got_drink, "collect_drink"),
            (got_sapling, "collect_sapling"), (got_stone, "collect_stone"),
            (got_coal, "collect_coal"), (got_iron, "collect_iron"),
            (got_diamond, "collect_diamond"), (got_ruby, "collect_ruby"),
            (got_sapphire, "collect_sapphire"), (ate_plant, "eat_plant"),
            (got_obsidian, "collect_obsidian"), (got_crystal, "collect_crystal"),
        ]:
            grant(name, cond)

        # ---- PLACE: one pass over the place table
        placeable = T.placeable[tblock.long()] & ~any_mob
        place_ok = (
            (action[:, None] == T.place_act)
            & placeable[:, None]
            & (~T.place_grass | (tblock == W.GRASS)[:, None])
            & (inv[:, None, :] >= T.place_cost).all(2)
        )
        inv = inv - (T.place_cost * place_ok[:, :, None]).sum(1, dtype=torch.int32)
        for i, spec in enumerate(_PLACE_SPECS):
            grant(spec[4], place_ok[:, i])
        placed_plant = place_ok[:, _PLACE_PLANT_ROW]
        place_any = place_ok.any(1)
        place_tile = (place_ok * T.place_tile).sum(1, dtype=torch.int32)

        # every tile mutation of the step hits the facing cell, on the level the
        # action happened on
        tile_new = torch.where(mined, W.PATH, tblock)
        tile_new = torch.where(ate_plant, W.SAPLING, tile_new)
        tile_new = torch.where(place_any, place_tile, tile_new).to(torch.int32)
        alvl = state.level.long()
        blocks = state.blocks.clone()
        blocks[rows, alvl, ty.long(), tx.long()] = tile_new.to(torch.int8)
        growth = state.growth.clone()
        growth[rows, ty.long(), tx.long()] = torch.where(
            (ate_plant | placed_plant) & (state.level == W.SURFACE), 0,
            state.growth[rows, ty.long(), tx.long()].to(torch.int32),
        ).to(torch.int8)

        def read_after_write(ys, xs):
            shape = (E,) + (1,) * (ys.dim() - 1)
            written = (ys == ty.view(shape)) & (xs == tx.view(shape))
            return torch.where(written, tile_new.view(shape), patch_read(ys, xs))

        # ---- CRAFT: the 3x3 neighbourhood, after the tile write
        d1 = torch.arange(-1, 2, device=dev)
        around = read_after_write(pos[:, 0, None, None] + d1[:, None], pos[:, 1, None, None] + d1[None, :])
        near = lambda block: (around == block).flatten(1).any(1)  # noqa: E731
        near_table, near_furnace = near(W.TABLE), near(W.FURNACE)
        craft_ok = (
            (action[:, None] == T.craft_act)
            & near_table[:, None]
            & (~T.craft_furnace | near_furnace[:, None])
            & (inv[:, T.craft_out] == 0)
            & (inv[:, None, :] >= T.craft_cost).all(2)
        )
        inv = (
            inv
            - (T.craft_cost * craft_ok[:, :, None]).sum(1, dtype=torch.int32)
            + (T.craft_out_onehot * craft_ok[:, :, None]).sum(1, dtype=torch.int32)
        )
        for i, spec in enumerate(_CRAFT_SPECS):
            grant(spec[4], craft_ok[:, i])
        wood, stone, arrow = col(inv, "wood", "stone", "arrow")
        arrow_ok = (
            (action == A_MAKE_ARROW) & near_table & (wood >= 1) & (stone >= 1)
            & (arrow <= MAX_ARROWS - ARROWS_PER_CRAFT)
        )
        inv = inv + T.arrow_delta * arrow_ok[:, None]
        grant("make_arrow", arrow_ok)

        # ---- ENCHANT at an enchantment table: a gem and mana, once a slot
        near_ench = near(W.ENCHANT_TABLE)
        has_any_sword = sum(col(inv, "wood_sword", "stone_sword", "iron_sword", "diamond_sword")) > 0
        has_any_armor = sum(col(inv, "iron_armor", "diamond_armor")) > 0
        gear_ok = torch.stack([has_any_sword, inv[:, INV["bow"]] > 0, has_any_armor], 1)
        ench_ok = (
            (action[:, None] == T.ench_act)
            & near_ench[:, None]
            & gear_ok
            & (inv[:, T.ench_mark] == 0)
            & (inv[:, T.ench_gem] >= 1)
            & (state.mana >= ENCHANT_COST)[:, None]
        )
        inv = inv + (T.ench_delta * ench_ok[:, :, None]).sum(1, dtype=torch.int32)
        for i, spec in enumerate(_ENCH_SPECS):
            grant(spec[3], ench_ok[:, i])
        enchanted = ench_ok.any(1)

        # ---- SHOOT / CAST down the facing ray: the first mob in line of sight,
        # or, for the ice bolt, every one
        bow, arrow, spellbook, frost, bow_ench = col(inv, "bow", "arrow", "spellbook", "frost_tome", "bow_enchant")
        awake = ~sleeping
        shoot = (action == A_SHOOT) & awake & (bow > 0) & (arrow > 0)
        cast = (action == A_CAST) & awake & (spellbook > 0) & (state.mana >= SPELL_COST)
        cast_ice = (action == A_CAST_ICE) & awake & (frost > 0) & (state.mana >= ICE_COST)
        proj = shoot | cast | cast_ice
        proj_damage = torch.where(
            cast, SPELL_DAMAGE, torch.where(cast_ice, ICE_DAMAGE, ARROW_DAMAGE + 2 * bow_ench)
        )
        ray_d = torch.arange(1, ARROW_RANGE + 1, device=dev)
        ray = pos[:, None, :] + ray_d[None, :, None] * step_vec[:, None, :]  # (E, R, 2)
        ray_free = T.walkable[read_after_write(ray[..., 0], ray[..., 1]).long()]
        # clear[i]: every tile strictly before ray[i] is walkable
        clear = torch.cat([
            torch.ones(E, 1, dtype=torch.bool, device=dev), torch.cumprod(ray_free[:, :-1].int(), 1).bool()
        ], 1)
        on_ray = (
            (mob_alive & (state.mob_level == lvl[:, None]))[:, :, None]
            & (state.mob_pos[..., 0, None] == ray[:, None, :, 0])
            & (state.mob_pos[..., 1, None] == ray[:, None, :, 1])
            & clear[:, None, :]
        )  # (E, N_MOBS, R)
        rd = torch.where(on_ray, ray_d, ARROW_RANGE + 1).min(2).values
        nearest = rd.min(1).values
        proj_lands = proj & (nearest <= ARROW_RANGE)
        struck = torch.where(
            cast_ice[:, None], cast_ice[:, None] & on_ray.any(2), proj_lands[:, None] & (rd == nearest[:, None])
        )
        mob_health = torch.where(struck, mob_health - proj_damage[:, None], mob_health)
        inv = inv - T.arrow_onehot * shoot[:, None]
        grant("fire_bow", shoot)
        grant("cast_spell", cast)
        grant("cast_ice_spell", cast_ice)
        shot = struck & (mob_health <= 0) & mob_alive
        mob_alive = mob_alive & ~shot
        shot_type = (shot.float() @ T.type_onehot) > 0
        food = torch.where(shot_type[:, MOB_COW], torch.clamp(food + 6, max=9), food)
        mob_kill_types = mob_kill_types | shot_type
        xp = state.xp + torch.where(melee_killed | shot, T.xp_per_kill, 0).sum(1, dtype=torch.int32)

        # ---- plant growth (surface only)
        surface = blocks[:, W.SURFACE]
        is_sapling = surface == W.SAPLING
        growth = torch.where(is_sapling, growth + 1, 0).to(torch.int8)
        ripe = is_sapling & (growth >= params.growth_time)
        blocks[:, W.SURFACE] = torch.where(ripe, W.PLANT_RIPE, surface).to(torch.int8)

        # ---- day/night + sleep
        t = state.time + 1
        is_night = (t % params.day_length) >= (params.day_length // 2)
        sleeping = sleeping | ((action == A_SLEEP) & is_night)
        woke = state.sleeping & ~is_night
        sleeping = sleeping & ~woke
        grant("wake_up", woke)

        # ---- needs decay / regen
        hunger = state.hunger + 1
        thirst = state.thirst + 1
        fatigue = torch.where(sleeping, 0, state.fatigue + 1)
        food = torch.where(hunger >= 25, torch.clamp(food - 1, min=0), food)
        hunger = torch.where(hunger >= 25, 0, hunger)
        drink = torch.where(thirst >= 20, torch.clamp(drink - 1, min=0), drink)
        thirst = torch.where(thirst >= 20, 0, thirst)
        energy = torch.where(fatigue >= 30, torch.clamp(state.energy - 1, min=0), state.energy)
        fatigue = torch.where(fatigue >= 30, 0, fatigue)
        energy = torch.where(sleeping & (t % 2 == 0), torch.clamp(energy + 1, max=9), energy)
        any_zero = (food == 0) | (drink == 0) | (energy == 0)
        decay_tick = torch.where(any_zero, state.decay_tick + 1, 0)
        health = torch.where(decay_tick >= 10, torch.clamp(state.health - 1, min=0), state.health)
        decay_tick = torch.where(decay_tick >= 10, 0, decay_tick)
        regen_tick = torch.where(~any_zero, state.regen_tick + 1, 0)
        health = torch.where((regen_tick >= 30) & (health < 9), health + 1, health)
        regen_tick = torch.where(regen_tick >= 30, 0, regen_tick)

        # ---- mana + potions
        mana_spend = cast * SPELL_COST + cast_ice * ICE_COST + enchanted * ENCHANT_COST
        mana = torch.where(
            mana_spend > 0, state.mana - mana_spend, torch.clamp(state.mana + ((t % 4) == 0).int(), max=MAX_MANA)
        )
        quaff_color = torch.clamp(action - A_DRINK_RED, 0, NUM_POTIONS - 1).long()
        quaff_slot = INV["potion_red"] + quaff_color
        quaff = (
            (action >= A_DRINK_RED) & (action <= A_DRINK_BLUE) & ~sleeping
            & (inv.gather(1, quaff_slot[:, None])[:, 0] > 0)
        )
        inv = inv - torch.nn.functional.one_hot(quaff_slot, NUM_INV).to(torch.int32) * quaff[:, None]
        effect = state.potion_map.gather(1, quaff_color[:, None])[:, 0]
        health = torch.where(quaff & (effect == POTION_HEAL), torch.clamp(health + 4, max=9), health)
        food = torch.where(quaff & (effect == POTION_FEAST), torch.clamp(food + 4, max=9), food)
        drink = torch.where(quaff & (effect == POTION_FEAST), torch.clamp(drink + 4, max=9), drink)
        health = torch.where(quaff & (effect == POTION_POISON), torch.clamp(health - 2, min=0), health)
        grant("drink_potion", quaff)
        potions_tried = state.potions_tried | (
            quaff[:, None] & (torch.arange(NUM_POTIONS, device=dev) == quaff_color[:, None])
        )

        # ---- zombies: spawn at night near the player (always in the dungeon),
        # surface ones despawn at dawn
        spawn_offsets = torch.floor(u_zoff * 17.0).to(torch.int32) - 8
        far_enough = spawn_offsets.abs().sum(2) >= 5
        lo, hi = W.PAD, W.PAD + W.WORLD_SIZE - 1
        spawn_pos = torch.clamp(pos[:, None, :] + spawn_offsets, lo, hi)
        z_alive = mob_alive[:, ZOMBIES]
        spawn_vals = read_after_write(spawn_pos[..., 0], spawn_pos[..., 1])
        spawn_ok = (
            (is_night | (lvl != W.SURFACE))[:, None] & ~z_alive & far_enough
            & (u_zgate < 0.05) & T.walkable[spawn_vals.long()]
        )
        mob_pos = state.mob_pos.clone()
        mob_pos[:, ZOMBIES] = torch.where(spawn_ok[..., None], spawn_pos, state.mob_pos[:, ZOMBIES])
        mob_level = state.mob_level.clone()
        mob_level[:, ZOMBIES] = torch.where(spawn_ok, lvl[:, None], state.mob_level[:, ZOMBIES])
        mob_health = mob_health.clone()
        mob_health[:, ZOMBIES] = torch.where(spawn_ok, 5, mob_health[:, ZOMBIES])
        mob_alive = mob_alive.clone()
        mob_alive[:, ZOMBIES] = (z_alive | spawn_ok) & (is_night[:, None] | (mob_level[:, ZOMBIES] != W.SURFACE))

        # ---- one movement pass for every species: a chase step toward the
        # player or a random-walk step, if its cell on its own floor is walkable
        same_lvl = mob_level == lvl[:, None]
        dirs = torch.floor(u_dirs * 4.0).long()
        delta = pos[:, None, :] - mob_pos
        go_y = delta[..., 0].abs() >= delta[..., 1].abs()
        chase = torch.stack([
            torch.where(go_y, torch.sign(delta[..., 0]), 0), torch.where(go_y, 0, torch.sign(delta[..., 1]))
        ], -1)
        wants_chase = same_lvl & (u_chase < T.chase_p)
        wants_walk = u_walk < torch.where(same_lvl, T.walk_same, T.walk_away)
        step = torch.where(wants_chase[..., None], chase, torch.where(wants_walk[..., None], T.dirs[dirs], 0))
        cand = torch.clamp(mob_pos + step, lo, hi)
        # walkability on each mob's own floor from the map before the step's
        # tile write and ripening (saplings and ripe plants are both walkable),
        # the written cell overridden
        cand_vals = state.blocks[rows[:, None], mob_level.long(), cand[..., 0].long(), cand[..., 1].long()]
        cand_vals = torch.where(
            (mob_level == lvl[:, None]) & (cand[..., 0] == ty[:, None]) & (cand[..., 1] == tx[:, None]),
            tile_new[:, None], cand_vals.to(torch.int32),
        )
        move_ok = T.walkable[cand_vals.long()] & mob_alive & (wants_chase | wants_walk)
        mob_pos = torch.where(move_ok[..., None], cand, mob_pos)

        # ---- adjacent mobs hit every other step, harder on a sleeper; armor
        # takes a point a tier (never below 1)
        adj = mob_alive & (mob_level == lvl[:, None]) & ((mob_pos - pos[:, None, :]).abs().sum(2) <= 1)
        base_dmg = torch.where(adj, T.melee_dmg, 0).max(1).values
        ia, da, ae = col(inv, "iron_armor", "diamond_armor", "armor_enchant")
        armor = ia + 2 * da + ae
        base_dmg = torch.where(base_dmg > 0, torch.clamp(base_dmg - armor, min=1), 0)
        dmg = torch.where((base_dmg > 0) & (t % 2 == 0), base_dmg + sleeping.int(), 0)
        health = torch.clamp(health - dmg, min=0)

        # ---- commit the achievement grants, then the derived ones
        conds = torch.stack(ach_conds, 1).float()
        ach = state.achievements | ((conds @ T.eye_ach[ach_ids]) > 0)
        ach = ach | ((mob_kill_types.float() @ T.mob_ach) > 0)
        tools = col(inv, "wood_pickaxe", "stone_pickaxe", "iron_pickaxe", "diamond_pickaxe",
                    "wood_sword", "stone_sword", "iron_sword", "diamond_sword")
        diamond, ruby, sapphire = col(inv, "diamond", "ruby", "sapphire")
        derived = torch.stack([
            cast & struck.any(1),  # fireball_kill
            shoot & struck.any(1) & (nearest >= 4),  # marksman
            (diamond > 0) & (ruby > 0) & (sapphire > 0),  # collect_all_gems
            # health, not alive: a boss whose placement failed was never alive
            (mob_health[:, WARDEN] <= 0) & (mob_health[:, NECRO] <= 0) & (mob_health[:, QUEEN] <= 0),
            # full_belly: a refill, since you spawn full
            (food >= 9) & (drink >= 9) & ~((state.food >= 9) & (state.drink >= 9)),
            cast_ice & shot.any(1),  # ice_kill
            potions_tried.all(1),  # drink_all_potions
            xp >= XP_PER_LEVEL,  # level_up
            xp >= (MAX_PLAYER_LEVEL - 1) * XP_PER_LEVEL,  # veteran
            torch.stack(tools, 1).gt(0).all(1),  # craft_all_tools
        ], 1)
        ach = ach | ((derived.float() @ T.derived_ach) > 0)

        # ---- reward / termination
        new_ach = ach & ~state.achievements
        reward = new_ach.sum(1).float() + 0.1 * (health - state.health).float()
        new_state = ForagerState(
            blocks=blocks, growth=growth, pos=pos, level=lvl, facing=facing,
            health=health, food=food, drink=drink, energy=energy,
            hunger=hunger, thirst=thirst, fatigue=fatigue,
            decay_tick=decay_tick, regen_tick=regen_tick,
            sleeping=sleeping, mana=mana, xp=xp,
            potion_map=state.potion_map, potions_tried=potions_tried,
            inventory=inv, achievements=ach,
            mob_pos=mob_pos, mob_level=mob_level, mob_alive=mob_alive, mob_health=mob_health,
            time=t, terminal=health <= 0,
        )
        new_state = ForagerState(**{
            f.name: getattr(new_state, f.name).to(_STATE_DTYPES[f.name]) for f in fields(ForagerState)
        })
        done = self.is_terminal(new_state, params)
        info = {"achievement_count": ach.sum(1).float()}
        if self.log_achievements:
            info.update({f"achievements/{name}": ach[:, i].float() for i, name in enumerate(ACHIEVEMENTS)})
        return self.get_obs(new_state, params), new_state, reward, done, info

    # ------------------------------------------------------------------
    def get_obs(self, state: ForagerState, params) -> torch.Tensor:
        dev = state.pos.device
        T = _tables(dev)
        E = state.pos.shape[0]
        half = VIEW // 2
        dv = torch.arange(VIEW, device=dev) - half
        wy = (state.pos[:, 0, None] + dv)[:, :, None].long()
        wx = (state.pos[:, 1, None] + dv)[:, None, :].long()
        rows = torch.arange(E, device=dev)[:, None, None]
        window = state.blocks[rows, state.level[:, None, None].long(), wy, wx].long()
        block_onehot = torch.nn.functional.one_hot(window, W.NUM_BLOCK_TYPES).float()

        rel = state.mob_pos - state.pos[:, None, :] + half  # (E, N_MOBS, 2)
        vis = state.mob_alive & (state.mob_level == state.level[:, None])
        ys = torch.arange(VIEW, device=dev)
        hit = (
            vis[:, :, None, None]
            & (rel[..., 0, None, None] == ys[:, None])
            & (rel[..., 1, None, None] == ys[None, :])
        )  # (E, N_MOBS, V, V)
        mobs = (hit.flatten(2).transpose(1, 2).float() @ T.type_onehot) > 0  # (E, V*V, types)
        grid = torch.cat([block_onehot.reshape(E, VIEW * VIEW, -1), mobs.float()], -1).reshape(E, -1)

        day_frac = (state.time % params.day_length).float() * _f32_recip(float(params.day_length))
        r9 = lambda x: x.float() * _R9  # noqa: E731
        extras = torch.cat([
            r9(state.inventory),
            torch.stack([r9(state.health), r9(state.food), r9(state.drink), r9(state.energy),
                         state.mana.float() * _R_MANA], 1),
            torch.nn.functional.one_hot(state.facing.long(), 4).float(),
            torch.stack([torch.sin(_TWO_PI * day_frac), torch.cos(_TWO_PI * day_frac)], 1),
            state.sleeping.float()[:, None],
            state.level.float()[:, None] * (1.0 / (W.NUM_LEVELS - 1)),
            torch.stack([
                torch.clamp(state.xp // XP_PER_LEVEL, max=MAX_PLAYER_LEVEL - 1).float() * (1.0 / (MAX_PLAYER_LEVEL - 1)),
                (state.xp % XP_PER_LEVEL).float() * (1.0 / XP_PER_LEVEL),
            ], 1),
            state.potions_tried.float(),
        ], 1)
        return torch.cat([grid, extras], 1)

    def is_terminal(self, state: ForagerState, params) -> torch.Tensor:
        return state.terminal | (state.time >= params.max_steps_in_episode)
