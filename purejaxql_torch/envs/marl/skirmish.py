"""Skirmish: a SMAX-class cooperative micro-battle env.

Port of purejaxql_tpu/envs/marl/skirmish.py, batched. N controlled allies
fight M scripted enemies on a continuous 2D field:

- unit types: type 0 "ranged" (long range, low damage, fragile, slow,
  shielded) and type 1 "melee" (short range, high damage, tanky, fast);
- shields absorb damage before health and regenerate after a few unhit
  steps (skirmish.py:164-180); the reward counts shield damage;
- sight ranges: units beyond the observer's sight read as zeros;
- the enemy chases the closest living ally and attacks in range;
- named maps (``MAPS``: "2s3z", "3s5z", "5m", "2s1z_vs_3z");
- legal-action masks (skirmish.py:371-387): attack-enemy-j only while enemy
  j lives and is in the attacker's range; a dead ally has only its no-op.

Actions per ally: [noop, up, right, down, left, attack_0..attack_{M-1}].
Observations per ally: own (pos, health, shield, cooldown, type), then per
other ally and per enemy the relative (pos, health, shield, alive, type), a
unit out of sight or dead all zeros.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.marl.base import MultiAgentEnv
from purejaxql_torch.envs.marl.spread import norm


@dataclass
class SkirmishState:
    ally_pos: torch.Tensor  # (E, N, 2)
    ally_health: torch.Tensor  # (E, N)
    ally_shield: torch.Tensor  # (E, N)
    ally_cd: torch.Tensor  # (E, N) int32 attack cooldown
    ally_unhit: torch.Tensor  # (E, N) int32 steps since last damage taken
    enemy_pos: torch.Tensor  # (E, M, 2)
    enemy_health: torch.Tensor  # (E, M)
    enemy_shield: torch.Tensor  # (E, M)
    enemy_cd: torch.Tensor  # (E, M) int32
    enemy_unhit: torch.Tensor  # (E, M) int32
    time: torch.Tensor  # (E,) int32


@dataclass
class SkirmishDraws:
    """A reset's draws: allies uniform on the left quarter of the arena,
    enemies on the right one (skirmish.py:134-144)."""

    ally_pos: torch.Tensor  # (E, N, 2)
    enemy_pos: torch.Tensor  # (E, M, 2)


_MOVES = ((0.0, 0.0), (0.0, 1.0), (1.0, 0.0), (0.0, -1.0), (-1.0, 0.0))

# SMAX-style unit compositions: (ally types, enemy types)
MAPS = {
    "2s3z": ((0, 0, 1, 1, 1), (0, 0, 1, 1, 1)),
    "3s5z": ((0, 0, 0, 1, 1, 1, 1, 1), (0, 0, 0, 1, 1, 1, 1, 1)),
    "5m": ((0, 0, 0, 0, 0), (0, 0, 0, 0, 0)),
    "2s1z_vs_3z": ((0, 0, 1), (1, 1, 1)),
}


class Skirmish(MultiAgentEnv):
    # per-type attributes: [ranged, melee]
    TYPE_RANGE = (2.5, 0.9)
    TYPE_DAMAGE = (1.0, 2.0)
    TYPE_HEALTH = (4.0, 7.0)
    TYPE_SPEED = (0.45, 0.6)
    TYPE_SHIELD = (3.0, 0.0)
    TYPE_SIGHT = (4.0, 2.5)
    SHIELD_REGEN = 0.5  # per step, after SHIELD_REGEN_DELAY unhit steps
    SHIELD_REGEN_DELAY = 3

    def __init__(
        self,
        num_allies: int = None,
        num_enemies: int = None,
        ally_types=(0, 0, 1),
        enemy_types=(0, 0, 1),
        map_name: str = None,
        max_steps: int = 64,
        arena: float = 8.0,
        attack_cooldown: int = 2,
    ):
        # a map overrides the type lists; num_allies / num_enemies that differ
        # from them give all-ranged teams (skirmish.py:96-103)
        if map_name is not None:
            ally_types, enemy_types = MAPS[map_name]
        if num_allies is not None and num_allies != len(ally_types):
            ally_types = (0,) * num_allies
        if num_enemies is not None and num_enemies != len(enemy_types):
            enemy_types = (0,) * num_enemies
        self.ally_types = tuple(int(t) for t in ally_types)
        self.enemy_types = tuple(int(t) for t in enemy_types)
        self.num_allies = self.num_agents = len(self.ally_types)
        self.num_enemies = len(self.enemy_types)
        self.agents = [f"ally_{i}" for i in range(self.num_allies)]
        self.max_steps = max_steps
        self.arena = arena
        self.attack_cooldown = attack_cooldown
        self.max_health = max(self.TYPE_HEALTH)
        self.max_shield = max(max(self.TYPE_SHIELD), 1e-6)
        self.num_actions = 5 + self.num_enemies
        self.obs_dim = 6 + (self.num_allies - 1) * 6 + self.num_enemies * 6
        # the reward's nominal total: all enemy health and shields, the kill
        # and win bonuses (summed in float32, as skirmish.py:124-131)
        total = (np.float32(self.TYPE_HEALTH) + np.float32(self.TYPE_SHIELD))[list(self.enemy_types)].sum()
        self._max_reward = float(total) + self.num_enemies * 0.5 + 1.0

    # per-unit attribute tables, (N,) or (M,) float32 on the device
    def _table(self, attr: str, side: str, device) -> torch.Tensor:
        types = self.ally_types if side == "ally" else self.enemy_types
        return self.constant(f"{attr}_{side}", [getattr(self, attr)[t] for t in types], device)

    # ------------------------------------------------------------------
    def reset_draws(self, generator: torch.Generator, num_envs: int) -> SkirmishDraws:
        half = self.arena / 2
        dev = generator.device

        def uniform(name, n, lo, hi):
            u = torch.rand(num_envs, n, 2, generator=generator, device=dev)
            return self.constant(f"{name}_lo", lo, dev) + u * self.constant(f"{name}_span", np.subtract(hi, lo), dev)

        return SkirmishDraws(
            ally_pos=uniform("ally", self.num_allies, [-half, -half], [-half / 2, half]),
            enemy_pos=uniform("enemy", self.num_enemies, [half / 2, -half], [half, half]),
        )

    def reset_env(self, draws: SkirmishDraws) -> SkirmishState:
        dev = draws.ally_pos.device
        n_envs = draws.ally_pos.shape[0]

        def per_env(attr, side):
            return self._table(attr, side, dev).expand(n_envs, -1).clone()

        def zeros(n):
            return torch.zeros(n_envs, n, dtype=torch.int32, device=dev)

        return SkirmishState(
            ally_pos=draws.ally_pos,
            ally_health=per_env("TYPE_HEALTH", "ally"),
            ally_shield=per_env("TYPE_SHIELD", "ally"),
            ally_cd=zeros(self.num_allies),
            ally_unhit=zeros(self.num_allies),
            enemy_pos=draws.enemy_pos,
            enemy_health=per_env("TYPE_HEALTH", "enemy"),
            enemy_shield=per_env("TYPE_SHIELD", "enemy"),
            enemy_cd=zeros(self.num_enemies),
            enemy_unhit=zeros(self.num_enemies),
            time=torch.zeros(n_envs, dtype=torch.int32, device=dev),
        )

    # ------------------------------------------------------------------
    @staticmethod
    def _apply_damage(shield, health, dmg):
        """Shields absorb first; returns (shield, health, the damage dealt,
        capped at what remained)."""
        absorbed = torch.minimum(shield, dmg)
        overflow = dmg - absorbed
        new_health = torch.clamp(health - overflow, min=0.0)
        dealt = absorbed + (health - new_health)
        return shield - absorbed, new_health, dealt

    def _regen(self, shield, unhit, alive, cap):
        """Shield regeneration after SHIELD_REGEN_DELAY unhit steps."""
        regen_ok = alive & (unhit >= self.SHIELD_REGEN_DELAY)
        return torch.where(regen_ok, torch.minimum(shield + self.SHIELD_REGEN, cap), shield)

    def step_env(self, state: SkirmishState, actions: Dict):
        acts = torch.stack([actions[a] for a in self.agents], 1)  # (E, N)
        dev = acts.device
        ally_alive = state.ally_health > 0
        enemy_alive = state.enemy_health > 0
        a_range, e_range = self._table("TYPE_RANGE", "ally", dev), self._table("TYPE_RANGE", "enemy", dev)
        a_damage, e_damage = self._table("TYPE_DAMAGE", "ally", dev), self._table("TYPE_DAMAGE", "enemy", dev)
        a_speed, e_speed = self._table("TYPE_SPEED", "ally", dev), self._table("TYPE_SPEED", "enemy", dev)

        # -- ally movement (move actions 0..4; dead units frozen) -----------
        move_idx = torch.clamp(acts, 0, 4) * (acts < 5)
        delta = self.constant("moves", _MOVES, dev)[move_idx] * a_speed[:, None]
        ally_pos = torch.clamp(state.ally_pos + delta * ally_alive[..., None], -self.arena, self.arena)

        # -- ally attacks (action 5 + j attacks enemy j) ---------------------
        dists = norm(ally_pos[:, :, None, :] - state.enemy_pos[:, None, :, :])  # (E, N, M)
        target = torch.clamp(acts - 5, 0, self.num_enemies - 1)
        can_attack = (
            (acts >= 5)
            & ally_alive
            & (state.ally_cd == 0)
            & enemy_alive.gather(1, target)
            & (dists.gather(2, target[..., None])[..., 0] <= a_range)
        )
        dmg_matrix = torch.nn.functional.one_hot(target, self.num_enemies) * (can_attack * a_damage)[..., None]
        enemy_damage = dmg_matrix.sum(1)  # (E, M)
        enemy_shield, enemy_health, dealt = self._apply_damage(state.enemy_shield, state.enemy_health, enemy_damage)
        killed = (state.enemy_health > 0) & (enemy_health <= 0)
        ally_cd = torch.where(can_attack, self.attack_cooldown, torch.clamp(state.ally_cd - 1, min=0)).to(torch.int32)

        # -- enemy heuristic: chase the closest living ally, attack in range -
        e_dists = norm(state.enemy_pos[:, :, None, :] - ally_pos[:, None, :, :])  # (E, M, N)
        e_dists_masked = torch.where(ally_alive[:, None, :], e_dists, 1e9)
        closest = e_dists_masked.argmin(2)  # (E, M)
        closest_dist = e_dists_masked.gather(2, closest[..., None])[..., 0]
        new_enemy_alive = enemy_health > 0

        chase_dir = ally_pos.gather(1, closest[..., None].expand(-1, -1, 2)) - state.enemy_pos
        chase_norm = norm(chase_dir)[..., None] + 1e-8
        enemy_pos = torch.where(
            (new_enemy_alive & (closest_dist > e_range * 0.8))[..., None],
            state.enemy_pos + chase_dir / chase_norm * e_speed[:, None],
            state.enemy_pos,
        )
        enemy_pos = torch.clamp(enemy_pos, -self.arena, self.arena)

        e_attacks = (
            new_enemy_alive
            & (state.enemy_cd == 0)
            & (closest_dist <= e_range)
            & ally_alive.gather(1, closest)
        )
        ally_damage = (
            torch.nn.functional.one_hot(closest, self.num_allies) * (e_attacks * e_damage)[..., None]
        ).sum(1)  # (E, N)
        ally_shield, ally_health, _ = self._apply_damage(state.ally_shield, state.ally_health, ally_damage)
        enemy_cd = torch.where(e_attacks, self.attack_cooldown, torch.clamp(state.enemy_cd - 1, min=0)).to(torch.int32)

        # -- shield regen / unhit counters -----------------------------------
        ally_unhit = torch.where(ally_damage > 0, 0, state.ally_unhit + 1).to(torch.int32)
        enemy_unhit = torch.where(enemy_damage > 0, 0, state.enemy_unhit + 1).to(torch.int32)
        ally_shield = self._regen(ally_shield, ally_unhit, ally_health > 0, self._table("TYPE_SHIELD", "ally", dev))
        enemy_shield = self._regen(
            enemy_shield, enemy_unhit, enemy_health > 0, self._table("TYPE_SHIELD", "enemy", dev)
        )

        # -- reward (SMAC-style shaped; shield damage counts, overkill not) --
        all_enemies_dead = (enemy_health <= 0).all(1)
        reward = (dealt.sum(1) + 0.5 * killed.sum(1) + 1.0 * all_enemies_dead.float()) / self._max_reward

        new_time = state.time + 1
        all_allies_dead = (ally_health <= 0).all(1)
        done = all_enemies_dead | all_allies_dead | (new_time >= self.max_steps)
        stepped = SkirmishState(
            ally_pos=ally_pos, ally_health=ally_health, ally_shield=ally_shield, ally_cd=ally_cd,
            ally_unhit=ally_unhit, enemy_pos=enemy_pos, enemy_health=enemy_health, enemy_shield=enemy_shield,
            enemy_cd=enemy_cd, enemy_unhit=enemy_unhit, time=new_time,
        )
        return stepped, reward, done, {"won_episode": all_enemies_dead.float()}

    # ------------------------------------------------------------------
    def get_obs(self, state: SkirmishState) -> Dict[str, torch.Tensor]:
        """Every agent's observation in one batched (E, N, U, 6) pass:
        own 6 | allies j != i | enemies (skirmish.py:316-369)."""
        dev = state.ally_pos.device
        n_envs = state.ally_pos.shape[0]
        ally_alive = (state.ally_health > 0).float()
        enemy_alive = (state.enemy_health > 0).float()
        a_types = self.constant("ally_types", self.ally_types, dev)
        e_types = self.constant("enemy_types", self.enemy_types, dev)
        a_sight = self._table("TYPE_SIGHT", "ally", dev)

        own = torch.cat(
            [
                state.ally_pos / self.arena,
                (state.ally_health / self.max_health)[..., None],
                (state.ally_shield / self.max_shield)[..., None],
                (state.ally_cd / self.attack_cooldown)[..., None],
                a_types[:, None].expand(n_envs, -1, -1),
            ],
            2,
        )  # (E, N, 6)

        # all units (allies then enemies), seen by every agent at once
        upos = torch.cat([state.ally_pos, state.enemy_pos], 1)
        uhealth = torch.cat([state.ally_health, state.enemy_health], 1)
        ushield = torch.cat([state.ally_shield, state.enemy_shield], 1)
        ualive = torch.cat([ally_alive, enemy_alive], 1)
        utype = torch.cat([a_types, e_types])

        rel = upos[:, None, :, :] - state.ally_pos[:, :, None, :]  # (E, N, U, 2)
        dist = norm(rel)  # (E, N, U)
        # sight gating: units beyond the observer's sight read as zeros
        vis = ualive[:, None, :] * (dist <= a_sight[:, None]).float()
        feats = torch.cat(
            [
                rel / self.arena * vis[..., None],
                (uhealth[:, None, :] / self.max_health * vis)[..., None],
                (ushield[:, None, :] / self.max_shield * vis)[..., None],
                vis[..., None],
                (utype * vis)[..., None],
            ],
            -1,
        )  # (E, N, U, 6)

        # drop unit i from agent i's row (static indices, one gather)
        n, u = self.num_allies, self.num_allies + self.num_enemies
        idx = self.constant("others", [[j for j in range(u) if j != i] for i in range(n)], dev, torch.long)
        sel = feats[:, self.constant("rows", np.arange(n)[:, None], dev, torch.long), idx]  # (E, N, U - 1, 6)
        obs = torch.cat([own, sel.reshape(n_envs, n, -1)], 2)
        return {a: obs[:, i] for i, a in enumerate(self.agents)}

    def get_avail_actions(self, state: SkirmishState) -> Dict[str, torch.Tensor]:
        dev = state.ally_pos.device
        dists = norm(state.ally_pos[:, :, None, :] - state.enemy_pos[:, None, :, :])
        a_range = self._table("TYPE_RANGE", "ally", dev)
        attackable = (state.enemy_health > 0)[:, None, :] & (dists <= a_range[:, None])  # (E, N, M)
        moves = torch.ones(*attackable.shape[:2], 5, device=dev)
        mask = torch.cat([moves, attackable.float()], 2)
        # a dead ally: the no-op only
        noop_only = torch.zeros_like(mask)
        noop_only[..., 0] = 1.0
        mask = torch.where((state.ally_health <= 0)[..., None], noop_only, mask)
        return {a: mask[:, i] for i, a in enumerate(self.agents)}

    def observation_space(self, agent: str) -> spaces.Box:
        return spaces.Box(-2.0, 2.0, (self.obs_dim,))

    def action_space(self, agent: str) -> spaces.Discrete:
        return spaces.Discrete(self.num_actions)
