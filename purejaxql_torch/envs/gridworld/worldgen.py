"""Procedural world generation for Forager (the craftax-class env), batched.

Port of purejaxql_tpu/envs/gridworld/worldgen.py, split in two:

- ``worldgen_draws(generator, n)``: every random input of ``n`` worlds, as
  tensors (``WorldDraws``): the coarse normal grids of the value noise, the
  per-cell feature uniforms and the ladder cells of the four floor seams;
- ``generate_world(draws)``: a deterministic, batched function of them,
  returning (n, NUM_LEVELS, PADDED_SIZE, PADDED_SIZE) int8 block maps.

So the tests can feed in the draws the JAX package makes from its keys and
compare the worlds cell for cell. The arithmetic follows the compiled JAX
function: the sample points of the value noise are ``jnp.linspace``'s as
XLA folds them (``_sample_points``), and the bilinear blend keeps its
operation order.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# block ids
INVALID = 0
WATER = 1
SAND = 2
GRASS = 3
PATH = 4
TREE = 5
STONE = 6
COAL = 7
IRON = 8
DIAMOND = 9
TABLE = 10
FURNACE = 11
SAPLING = 12
PLANT_RIPE = 13
LADDER_DOWN = 14
LADDER_UP = 15
LAVA = 16
RUBY = 17
SAPPHIRE = 18
OBSIDIAN = 19
CHEST = 20
TORCH = 21
ENCHANT_TABLE = 22
ICE = 23
CRYSTAL = 24
NUM_BLOCK_TYPES = 25

# map levels (craftax-style vertical depth)
SURFACE = 0
CAVE = 1
DEEP = 2
HELL = 3
ICE_REALM = 4
NUM_LEVELS = 5

WORLD_SIZE = 48
# The map is stored padded with an INVALID border of PAD cells: the local view
# slices without re-padding, and the border is the world's boundary (INVALID is
# unwalkable). Positions live in padded coordinates [PAD, PAD + WORLD_SIZE).
PAD = 4
PADDED_SIZE = WORLD_SIZE + 2 * PAD

# the coarse grid resolution of each noise field
ELEV_RES, DETAIL_RES, DUNGEON_RES = 6, 12, 8
# four disjoint row bands, one per floor seam; each band ends 2 rows short of
# the next, so one seam's 3x3 pocket never reaches another seam's ladder
_BAND = (WORLD_SIZE - 14) // 4
_HALF = WORLD_SIZE // 2
SEAM_ROWS = (
    (6, 6 + _BAND - 2),
    (6 + _BAND, 6 + 2 * _BAND - 2),
    (6 + 2 * _BAND, 6 + 3 * _BAND - 2),
    (6 + 3 * _BAND, WORLD_SIZE - 8),
)
# a seam's two ladders take their columns from disjoint left and right halves
SEAM_COL_RANGE = _HALF - 8
SEAM_COL_OFFSETS = (6, _HALF + 2)


@dataclass
class WorldDraws:
    """The random inputs of n worlds (worldgen.py:122-250)."""

    elev: torch.Tensor  # (n, 7, 7) float32 standard normals: the elevation grid
    detail: torch.Tensor  # (n, 13, 13): the detail grid
    feat: torch.Tensor  # (n, 48, 48) uniforms: the surface features
    dungeon: torch.Tensor  # (n, 4, 9, 9) normals: the four dungeon floors' grids
    dungeon_feat: torch.Tensor  # (n, 4, 48, 48) uniforms: their features
    ladder_rows: torch.Tensor  # (n, 4, 2) int: each seam's two ladder rows
    ladder_cols: torch.Tensor  # (n, 4, 2) int in [0, SEAM_COL_RANGE): before the offsets


def worldgen_draws(generator: torch.Generator, n: int) -> WorldDraws:
    """The draws of ``n`` worlds from ``generator`` (on its device)."""
    dev = generator.device
    normal = lambda *shape: torch.randn(n, *shape, generator=generator, device=dev)  # noqa: E731
    uniform = lambda *shape: torch.rand(n, *shape, generator=generator, device=dev)  # noqa: E731
    rows = torch.stack(
        [torch.randint(lo, hi, (n, 2), generator=generator, device=dev) for lo, hi in SEAM_ROWS], 1
    )
    return WorldDraws(
        elev=normal(ELEV_RES + 1, ELEV_RES + 1),
        detail=normal(DETAIL_RES + 1, DETAIL_RES + 1),
        feat=uniform(WORLD_SIZE, WORLD_SIZE),
        dungeon=normal(4, DUNGEON_RES + 1, DUNGEON_RES + 1),
        dungeon_feat=uniform(4, WORLD_SIZE, WORLD_SIZE),
        ladder_rows=rows,
        ladder_cols=torch.randint(0, SEAM_COL_RANGE, (n, 4, 2), generator=generator, device=dev),
    )


def _sample_points(res: int, size: int, device) -> torch.Tensor:
    """``jnp.linspace(0, res, size)`` as compiled: iota * (res * (1 / (size - 1)))
    in float32 constants, the last point ``res`` exactly (torch.linspace
    rounds some points differently, which would flip threshold cells)."""
    step = torch.tensor(float(res), dtype=torch.float32) * torch.tensor(1.0 / (size - 1), dtype=torch.float32)
    xs = torch.arange(size, dtype=torch.float32, device=device) * step.to(device)
    xs[-1] = float(res)
    return xs


def value_noise(coarse: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinearly upsampled noise from coarse grids (..., res + 1, res + 1)
    to (..., size, size), times 0.8 (worldgen.py:71-98)."""
    res = coarse.shape[-1] - 1
    xs = _sample_points(res, size, coarse.device)
    x0 = torch.clamp(torch.floor(xs).long(), 0, res - 1)
    frac = xs - x0
    rows0, rows1 = coarse[..., x0, :], coarse[..., x0 + 1, :]
    top, right_top = rows0[..., x0], rows0[..., x0 + 1]
    bottom, right_bottom = rows1[..., x0], rows1[..., x0 + 1]
    fy, fx = frac[:, None], frac[None, :]
    v = (
        top * (1 - fy) * (1 - fx)
        + bottom * fy * (1 - fx)
        + right_top * (1 - fy) * fx
        + right_bottom * fy * fx
    )
    return v * 0.8


def kth_largest(x: torch.Tensor, k: int) -> torch.Tensor:
    """Per leading index, the k-th largest value of the trailing (H, W)
    cells, shaped to broadcast against them (worldgen.py:62-68)."""
    return torch.topk(x.flatten(-2), k, dim=-1).values[..., -1, None, None]


def _carve(floor: torch.Tensor, pos: torch.Tensor, fill: int, ladder: int) -> torch.Tensor:
    """A 3x3 pocket of ``fill`` around both ladder cells ``pos`` (n, 2, 2) of
    each floor (n, H, W), then the two ladder tiles (worldgen.py:259-272)."""
    yy = torch.arange(WORLD_SIZE, device=floor.device)
    near_y = (yy[None, :, None] - pos[:, None, :, 0]).abs() <= 1  # (n, H, 2)
    near_x = (yy[None, :, None] - pos[:, None, :, 1]).abs() <= 1  # (n, W, 2)
    mask = (near_y[:, :, None, :] & near_x[:, None, :, :]).any(-1)
    floor = torch.where(mask, torch.tensor(fill, dtype=floor.dtype, device=floor.device), floor)
    return _set_cells(floor, pos, ladder)


def _set_cells(floor: torch.Tensor, pos: torch.Tensor, value: int) -> torch.Tensor:
    floor = floor.clone()
    n = torch.arange(floor.shape[0], device=floor.device)[:, None]
    floor[n, pos[..., 0], pos[..., 1]] = value
    return floor


def generate_world(draws: WorldDraws) -> torch.Tensor:
    """(n, NUM_LEVELS, PADDED_SIZE, PADDED_SIZE) int8 block maps with an
    INVALID border (worldgen.py:101-287): a surface of water, sand and grass
    plains with forests and a stony highland seamed with ores; a cave of
    stone passages with richer ores and lava; a deep floor of corridors,
    more lava and the only ruby and sapphire; a hell floor of obsidian and
    lava seas; an ice realm of frozen ground, melt pools and crystal. Chests
    lie on every dungeon floor, and two aligned ladder pairs join each seam."""
    dev = draws.feat.device
    i8 = lambda v: torch.tensor(v, dtype=torch.int8, device=dev)  # noqa: E731
    elev = value_noise(draws.elev, WORLD_SIZE) + 0.5 * value_noise(draws.detail, WORLD_SIZE)
    n = elev.shape[0]

    blocks = torch.full((n, WORLD_SIZE, WORLD_SIZE), GRASS, dtype=torch.int8, device=dev)
    blocks = torch.where(elev < -0.55, i8(WATER), blocks)
    blocks = torch.where((elev >= -0.55) & (elev < -0.4), i8(SAND), blocks)
    highland = elev > 0.55
    # one uniform field drives every surface feature: trees only on lowland
    # grass, ores only on highland, by disjoint thresholds
    feat = draws.feat
    blocks = torch.where((blocks == GRASS) & (feat < 0.12) & ~highland, i8(TREE), blocks)
    blocks = torch.where(highland, i8(STONE), blocks)
    blocks = torch.where(highland & (feat < 0.10), i8(COAL), blocks)
    blocks = torch.where(highland & (feat >= 0.10) & (feat < 0.15), i8(IRON), blocks)
    blocks = torch.where(highland & (feat >= 0.15) & (feat < 0.17) & (elev > 0.85), i8(DIAMOND), blocks)
    # a cleared 3x3 spawn point at the center
    c = WORLD_SIZE // 2
    blocks[:, c - 1 : c + 2, c - 1 : c + 2] = GRASS

    # the four dungeon floors from one batched noise field and one feature field
    noise4 = value_noise(draws.dungeon, WORLD_SIZE)
    cnoise, dnoise, hnoise, inoise = noise4.unbind(1)
    cfeat, dfeat, hfeat, ifeat = draws.dungeon_feat.unbind(1)
    # lava or melt water covers a fixed count of cells a floor: the k-th largest
    # noise value is the threshold (cave 5 %, deep 8 %, hell 20 %, ice 6 %)
    cthresh = kth_largest(cnoise, 115)
    dthresh = kth_largest(dnoise, 184)
    hthresh_lava = kth_largest(hnoise, 461)
    ithresh_melt = kth_largest(inoise, 138)

    def floor_of(tile):
        return torch.full((n, WORLD_SIZE, WORLD_SIZE), tile, dtype=torch.int8, device=dev)

    cave = torch.where(cnoise > -0.15, i8(PATH), floor_of(STONE))
    cave = torch.where(cnoise > cthresh, i8(LAVA), cave)
    wall = cave == STONE
    cave = torch.where(wall & (cfeat < 0.15), i8(COAL), cave)
    cave = torch.where(wall & (cfeat >= 0.15) & (cfeat < 0.27), i8(IRON), cave)
    cave = torch.where(wall & (cfeat >= 0.27) & (cfeat < 0.33), i8(DIAMOND), cave)

    deep = torch.where(dnoise > 0.05, i8(PATH), floor_of(STONE))
    deep = torch.where(dnoise > dthresh, i8(LAVA), deep)
    dwall = deep == STONE
    deep = torch.where(dwall & (dfeat < 0.18), i8(IRON), deep)
    deep = torch.where(dwall & (dfeat >= 0.18) & (dfeat < 0.30), i8(DIAMOND), deep)
    deep = torch.where(dwall & (dfeat >= 0.30) & (dfeat < 0.38), i8(RUBY), deep)
    deep = torch.where(dwall & (dfeat >= 0.38) & (dfeat < 0.43), i8(SAPPHIRE), deep)

    hell = torch.where(hnoise > 0.1, i8(PATH), floor_of(OBSIDIAN))
    hell = torch.where(hnoise > hthresh_lava, i8(LAVA), hell)

    ice = torch.where(inoise > -0.05, i8(ICE), floor_of(STONE))
    ice = torch.where(inoise > ithresh_melt, i8(WATER), ice)
    iwall = ice == STONE
    ice = torch.where(iwall & (ifeat < 0.20), i8(CRYSTAL), ice)

    # loot chests on open ground, denser with depth; hell and the ice realm
    # get exactly their top-scoring open cells (12 and 10)
    cave = torch.where((cave == PATH) & (cfeat > 0.995), i8(CHEST), cave)
    deep = torch.where((deep == PATH) & (dfeat > 0.99), i8(CHEST), deep)
    hscore = torch.where(hell == PATH, hfeat, -1.0)
    hell = torch.where((hscore >= kth_largest(hscore, 12)) & (hscore > 0), i8(CHEST), hell)
    iscore = torch.where(ice == ICE, ifeat, -1.0)
    ice = torch.where((iscore >= kth_largest(iscore, 10)) & (iscore > 0), i8(CHEST), ice)

    # aligned ladder pairs: LADDER_DOWN on the upper floor, LADDER_UP in a
    # carved 3x3 pocket on the lower one
    offsets = torch.tensor(SEAM_COL_OFFSETS, device=dev)
    lpos = torch.stack([draws.ladder_rows.long(), draws.ladder_cols.long() + offsets], -1)  # (n, 4, 2, 2)
    blocks = _set_cells(blocks, lpos[:, 0], LADDER_DOWN)
    cave = _carve(cave, lpos[:, 0], PATH, LADDER_UP)
    cave = _carve(cave, lpos[:, 1], PATH, LADDER_DOWN)
    deep = _carve(deep, lpos[:, 1], PATH, LADDER_UP)
    deep = _carve(deep, lpos[:, 2], PATH, LADDER_DOWN)
    hell = _carve(hell, lpos[:, 2], PATH, LADDER_UP)
    hell = _carve(hell, lpos[:, 3], PATH, LADDER_DOWN)
    ice = _carve(ice, lpos[:, 3], ICE, LADDER_UP)

    world = torch.stack([blocks, cave, deep, hell, ice], 1)
    return torch.nn.functional.pad(world, (PAD, PAD, PAD, PAD), value=INVALID)
