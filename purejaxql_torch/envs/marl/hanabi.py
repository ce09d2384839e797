"""MiniHanabi: a Hanabi-class imperfect-information cooperative card game.

Port of purejaxql_tpu/envs/marl/hanabi.py, batched. Two players build one
ascending rank stack per color from a shuffled deck. Each sees the
partner's hand but never their own; information flows through paid hints
("all your color-c cards", "all your rank-r cards"), which spend a shared
pool of info tokens (refunded by discards and completed stacks). Playing an
unplayable card costs one of 3 shared lives; the team scores +1 a
successful play. Turn-based inside a simultaneous step: the acting seat
rotates, and the off-turn agent's only legal action is noop (the masks,
hanabi.py:331-363). Default: 2 colors x 5 ranks, counts 3/2/2/2/1, hand
size 3, 13 actions. A bombed-out game keeps its points.

A reset deals from a shuffled deck (hanabi.py:117): the draws are the
shuffled deck, (E, deck_size) card types.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from purejaxql_torch.envs import spaces
from purejaxql_torch.envs.marl.base import MultiAgentEnv


@dataclass
class HanabiState:
    deck: torch.Tensor  # (E, deck_size) int32 card types, play order
    deck_ptr: torch.Tensor  # (E,) int32, next card to draw
    hands: torch.Tensor  # (E, 2, H) int32 card types, -1 an empty slot
    know_color: torch.Tensor  # (E, 2, H, C) bool, colors still possible
    know_rank: torch.Tensor  # (E, 2, H, R) bool, ranks still possible
    fireworks: torch.Tensor  # (E, C) int32, next rank needed (0..R)
    discards: torch.Tensor  # (E, C, R) int32 counts
    info_tokens: torch.Tensor  # (E,) int32
    lives: torch.Tensor  # (E,) int32
    cur_player: torch.Tensor  # (E,) int32
    turns_since_empty: torch.Tensor  # (E,) int32
    last_action: torch.Tensor  # (E,) int32, the previous acting player's action
    time: torch.Tensor  # (E,) int32


class MiniHanabi(MultiAgentEnv):
    """2-player mini Hanabi with hint-mask observations."""

    def __init__(
        self,
        num_colors: int = 2,
        num_ranks: int = 5,
        hand_size: int = 3,
        max_info_tokens: int = 8,
        max_lives: int = 3,
        max_steps: int = 80,
    ):
        assert num_ranks >= 2
        self.num_agents = 2
        self.agents = ["agent_0", "agent_1"]
        self.C, self.R, self.H = num_colors, num_ranks, hand_size
        self.max_info = max_info_tokens
        self.max_lives = max_lives
        self.max_steps = max_steps
        # deck: 3 copies of rank 1, 1 of the top rank, 2 of each other
        self.rank_counts = np.asarray([3] + [2] * (num_ranks - 2) + [1], np.int32)
        self._deck_types = np.repeat(np.arange(num_colors * num_ranks), np.tile(self.rank_counts, num_colors))
        self.deck_size = len(self._deck_types)
        assert self.deck_size > 2 * hand_size, "deck must cover both hands"
        # actions: discard h | play h | hint color c | hint rank r | noop
        self.num_actions = 2 * hand_size + num_colors + num_ranks + 1
        self.A_NOOP = self.num_actions - 1
        self.obs_dim = (
            hand_size * (num_colors * num_ranks + 1)  # partner hand one-hot
            + hand_size  # own slot-present flags
            + 2 * hand_size * (num_colors + num_ranks)  # own and partner's hint knowledge
            + num_colors * (num_ranks + 1)  # fireworks one-hot
            + num_colors * num_ranks  # discards (normalized)
            + 3  # info, lives, deck left
            + 1  # my-turn flag
            + self.num_actions  # last action one-hot
        )

    def _card_color(self, card):
        return torch.where(card >= 0, torch.div(card, self.R, rounding_mode="floor"), 0)

    def _card_rank(self, card):
        return torch.where(card >= 0, torch.remainder(card, self.R), 0)

    # ------------------------------------------------------------------
    def reset_draws(self, generator: torch.Generator, num_envs: int) -> torch.Tensor:
        """A shuffled deck an env: a uniform permutation of the card types."""
        keys = torch.rand(num_envs, self.deck_size, generator=generator, device=generator.device)
        return self.constant("deck_types", self._deck_types, generator.device, torch.int32)[keys.argsort(1)]

    def reset_env(self, deck: torch.Tensor) -> HanabiState:
        n_envs, dev = deck.shape[0], deck.device
        H, C, R = self.H, self.C, self.R

        def full(value):
            return torch.full((n_envs,), value, dtype=torch.int32, device=dev)

        return HanabiState(
            deck=deck,
            deck_ptr=full(2 * H),
            hands=deck[:, : 2 * H].reshape(n_envs, 2, H),
            know_color=torch.ones(n_envs, 2, H, C, dtype=torch.bool, device=dev),
            know_rank=torch.ones(n_envs, 2, H, R, dtype=torch.bool, device=dev),
            fireworks=torch.zeros(n_envs, C, dtype=torch.int32, device=dev),
            discards=torch.zeros(n_envs, C, R, dtype=torch.int32, device=dev),
            info_tokens=full(self.max_info),
            lives=full(self.max_lives),
            cur_player=full(0),
            turns_since_empty=full(0),
            last_action=full(self.A_NOOP),
            time=full(0),
        )

    # ------------------------------------------------------------------
    def step_env(self, state: HanabiState, actions: Dict):
        H, C, R = self.H, self.C, self.R
        n_envs = state.deck.shape[0]
        rows = torch.arange(n_envs, device=state.deck.device)
        cur = state.cur_player.long()
        partner = 1 - cur
        acts = torch.stack([actions[a] for a in self.agents], 1)
        a = acts[rows, cur].to(torch.int32)

        is_discard = a < H
        is_play = (a >= H) & (a < 2 * H)
        is_hint_color = (a >= 2 * H) & (a < 2 * H + C)
        is_hint_rank = (a >= 2 * H + C) & (a < 2 * H + C + R)
        slot = torch.where(is_play, a - H, torch.where(is_discard, a, 0)).long()
        hint_c = torch.clamp(a - 2 * H, 0, C - 1)
        hint_r = torch.clamp(a - 2 * H - C, 0, R - 1)

        card = state.hands[rows, cur, slot]
        color = self._card_color(card).long()
        rank = self._card_rank(card).long()
        valid_pd = (is_play | is_discard) & (card >= 0)
        playable = valid_pd & (state.fireworks[rows, color] == rank)
        success = is_play & playable
        misplay = is_play & valid_pd & ~playable
        discarded = is_discard & valid_pd

        # fireworks, lives, the discard pile
        fireworks = state.fireworks.clone()
        fireworks[rows, color] += success.to(torch.int32)
        completed = success & (rank == R - 1)
        lives = state.lives - misplay.to(torch.int32)
        discards = state.discards.clone()
        discards[rows, color, rank] += (misplay | discarded).to(torch.int32)

        # info tokens: hints pay, discards and completed stacks refund
        used_hint = is_hint_color | is_hint_rank
        info_tokens = torch.clamp(
            state.info_tokens - used_hint.to(torch.int32) + discarded.to(torch.int32) + completed.to(torch.int32),
            0, self.max_info,
        )

        # draw a replacement into the used slot (-1 once the deck is out)
        empty_at_start = state.deck_ptr >= self.deck_size
        in_deck = state.deck[rows, torch.clamp(state.deck_ptr, 0, self.deck_size - 1).long()]
        drawn = torch.where(state.deck_ptr < self.deck_size, in_deck, -1)
        hands = state.hands.clone()
        hands[rows, cur, slot] = torch.where(valid_pd, drawn, card)
        deck_ptr = torch.clamp(state.deck_ptr + valid_pd.to(torch.int32), max=self.deck_size)

        # hint knowledge: positively identify the matching partner cards,
        # eliminate the hinted value elsewhere; a redrawn slot resets
        p_cards = state.hands[rows, partner]  # (E, H)
        p_present = p_cards >= 0
        onehot_c = torch.nn.functional.one_hot(hint_c.long(), C).bool()[:, None, :]  # (E, 1, C)
        match_c = (self._card_color(p_cards) == hint_c[:, None]) & p_present
        hinted_c = is_hint_color[:, None]
        kc_partner = torch.where(
            (hinted_c & match_c)[..., None],
            onehot_c,
            torch.where((hinted_c & ~match_c)[..., None] & onehot_c, False, state.know_color[rows, partner]),
        )
        onehot_r = torch.nn.functional.one_hot(hint_r.long(), R).bool()[:, None, :]
        match_r = (self._card_rank(p_cards) == hint_r[:, None]) & p_present
        hinted_r = is_hint_rank[:, None]
        kr_partner = torch.where(
            (hinted_r & match_r)[..., None],
            onehot_r,
            torch.where((hinted_r & ~match_r)[..., None] & onehot_r, False, state.know_rank[rows, partner]),
        )
        know_color = state.know_color.clone()
        know_rank = state.know_rank.clone()
        know_color[rows, partner] = kc_partner
        know_rank[rows, partner] = kr_partner
        know_color[rows, cur, slot] |= valid_pd[:, None]
        know_rank[rows, cur, slot] |= valid_pd[:, None]

        time = state.time + 1
        turns_since_empty = state.turns_since_empty + empty_at_start.to(torch.int32)
        done = (
            (lives <= 0)
            | (fireworks.sum(1) >= C * R)
            | (turns_since_empty >= self.num_agents)
            | (time >= self.max_steps)
        )
        stepped = HanabiState(
            deck=state.deck, deck_ptr=deck_ptr, hands=hands, know_color=know_color, know_rank=know_rank,
            fireworks=fireworks, discards=discards, info_tokens=info_tokens, lives=lives,
            cur_player=partner.to(torch.int32), turns_since_empty=turns_since_empty, last_action=a, time=time,
        )
        return stepped, success.float(), done, {"score": fireworks.sum(1, dtype=torch.int32)}

    # ------------------------------------------------------------------
    def get_obs(self, state: HanabiState) -> Dict[str, torch.Tensor]:
        C, R = self.C, self.R
        n_envs, dev = state.deck.shape[0], state.deck.device
        one_hot = torch.nn.functional.one_hot
        # what both seats read alike: fireworks, discards, the three scalars
        fw = one_hot(state.fireworks.long(), R + 1).reshape(n_envs, -1).float()
        disc = (state.discards.float() / self.constant("rank_counts", self.rank_counts, dev)).reshape(n_envs, -1)
        scalars = torch.stack(
            [
                state.info_tokens / self.max_info,
                state.lives / self.max_lives,
                (self.deck_size - state.deck_ptr) / self.deck_size,
            ],
            1,
        ).float()
        last_a = one_hot(state.last_action.long(), self.num_actions).float()

        def knowledge(i):
            return torch.cat(
                [state.know_color[:, i].reshape(n_envs, -1), state.know_rank[:, i].reshape(n_envs, -1)], 1
            ).float()

        obs = {}
        for i, a in enumerate(self.agents):
            p_cards = state.hands[:, 1 - i].long()
            p_onehot = one_hot(torch.where(p_cards >= 0, p_cards, C * R), C * R + 1).reshape(n_envs, -1).float()
            own_present = (state.hands[:, i] >= 0).float()
            my_turn = (state.cur_player == i).float()[:, None]
            obs[a] = torch.cat(
                [p_onehot, own_present, knowledge(i), knowledge(1 - i), fw, disc, scalars, my_turn, last_a], 1
            )
        return obs

    def get_avail_actions(self, state: HanabiState) -> Dict[str, torch.Tensor]:
        C, R = self.C, self.R
        has_tokens = (state.info_tokens > 0)[:, None]
        masks = {}
        for i, a in enumerate(self.agents):
            my_turn = state.cur_player == i
            present = state.hands[:, i] >= 0
            can_discard = present & (state.info_tokens < self.max_info)[:, None]
            p_cards = state.hands[:, 1 - i]
            p_present = (p_cards >= 0)[..., None]
            # the colors and ranks the partner holds
            color_exists = (torch.nn.functional.one_hot(self._card_color(p_cards).long(), C).bool() & p_present).any(1)
            rank_exists = (torch.nn.functional.one_hot(self._card_rank(p_cards).long(), R).bool() & p_present).any(1)
            acting = torch.cat([can_discard, present, has_tokens & color_exists, has_tokens & rank_exists], 1)
            # noop: the off-turn action, and the on-turn fallback when nothing
            # else is legal (an empty hand in the endgame)
            noop = ~my_turn | ~acting.any(1)
            masks[a] = torch.cat([acting & my_turn[:, None], noop[:, None]], 1).float()
        return masks

    def observation_space(self, agent: str) -> spaces.Box:
        return spaces.Box(0.0, 1.0, (self.obs_dim,))

    def action_space(self, agent: str) -> spaces.Discrete:
        return spaces.Discrete(self.num_actions)
