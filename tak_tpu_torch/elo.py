"""Elo ladder: round-robin evaluation among checkpoints (counterpart of
`tak_tpu/elo.py`).

The reference only supports head-to-head gating (`train/src/pit.rs`); for
learning-curve tracking (BASELINE.md "Elo curve parity") this module plays
a full round-robin among N checkpoints with the same paired-opening match
machinery as `pit` and fits Bradley-Terry ratings (draws = half a point)
on the pooled results, reported on the Elo scale (400 * log10(gamma)).

Ratings are the maximum-likelihood fit via minorization-maximization
(Hunter 2004), anchored so the first player's rating is 0.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field

import numpy as np

from .pit import PitConfig, pit


@dataclass
class MatchRecord:
    a: str
    b: str
    wins: int     # games won by a
    losses: int   # games won by b
    draws: int


@dataclass
class LadderResult:
    names: list[str]
    ratings: dict[str, float]
    matches: list[MatchRecord] = field(default_factory=list)

    def table(self) -> str:
        lines = [f"{'player':<32} {'elo':>8}  games"]
        games = {n: 0 for n in self.names}
        for m in self.matches:
            g = m.wins + m.losses + m.draws
            games[m.a] += g
            games[m.b] += g
        for name in sorted(self.names, key=lambda n: -self.ratings[n]):
            lines.append(f"{name:<32} {self.ratings[name]:>8.1f}  {games[name]}")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps({
            "ratings": self.ratings,
            "matches": [vars(m) for m in self.matches],
        })


def bradley_terry_elo(
    score: np.ndarray, games: np.ndarray, iters: int = 200, anchor: int = 0
) -> np.ndarray:
    """MLE Bradley-Terry ratings on the Elo scale.

    score[i, j] = points i took off j (wins + draws/2); games[i, j] = games
    between i and j.  MM update: gamma_i <- s_i / sum_j games_ij/(g_i+g_j).
    Players with no games keep rating 0 relative to the anchor.
    """
    P = score.shape[0]
    played = games.sum(axis=1) > 0
    # prior: eps drawn pseudo-games against a virtual gamma=1 opponent —
    # keeps 100%-score players finite (standard BT regularizer)
    eps = 1e-2
    s = score.sum(axis=1) + (eps / 2) * played
    gamma = np.ones(P)
    for _ in range(iters):
        denom = np.zeros(P)
        for i in range(P):
            nz = games[i] > 0
            denom[i] = np.sum(games[i, nz] / (gamma[i] + gamma[nz]))
        denom += eps / (gamma + 1.0) * played
        gamma = np.where(played, s / np.maximum(denom, 1e-30), gamma)
        gamma = gamma / gamma[anchor]
    elo = 400.0 * np.log10(np.maximum(gamma, 1e-30))
    return elo - elo[anchor]


@dataclass
class LadderConfig:
    pit: PitConfig = field(default_factory=PitConfig)
    # pairs to play: "round_robin" (all) or "adjacent" (checkpoint i vs i+1
    # only — cheap generational curve)
    schedule: str = "round_robin"


def elo_ladder(
    engine,
    eval_fn,
    players: list[tuple[str, object]],
    config: LadderConfig | None = None,
    seed: int = 0,
    log=print,
    device=None,
) -> LadderResult:
    """Round-robin (or adjacent-pair) matches among named parameter sets.

    players: list of (name, params) where params feed eval_fn.  The
    matches run on `device` (default: the card).
    """
    cfg = config or LadderConfig()
    names = [n for n, _ in players]
    P = len(players)
    if cfg.schedule == "round_robin":
        pairs = [(i, j) for i in range(P) for j in range(i + 1, P)]
    elif cfg.schedule == "adjacent":
        pairs = [(i, i + 1) for i in range(P - 1)]
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}")

    score = np.zeros((P, P))
    games = np.zeros((P, P))
    matches: list[MatchRecord] = []
    for k, (i, j) in enumerate(pairs):
        log(f"[elo] match {k + 1}/{len(pairs)}: {names[i]} vs {names[j]}")
        r = pit(engine, eval_fn, players[i][1], players[j][1], cfg.pit,
                seed=seed + 7919 * k, log=log, device=device)
        matches.append(MatchRecord(names[i], names[j],
                                   r.wins, r.losses, r.draws))
        g = r.wins + r.losses + r.draws
        score[i, j] += r.wins + 0.5 * r.draws
        score[j, i] += r.losses + 0.5 * r.draws
        games[i, j] += g
        games[j, i] += g
        log(f"[elo]   {names[i]} {r} vs {names[j]}")

    elo = bradley_terry_elo(score, games)
    ratings = {names[i]: float(elo[i]) for i in range(P)}
    return LadderResult(names=names, ratings=ratings, matches=matches)


def expected_score(elo_diff: float) -> float:
    """P(win) + P(draw)/2 for a player `elo_diff` points stronger."""
    return 1.0 / (1.0 + math.pow(10.0, -elo_diff / 400.0))
