"""Gating matches between two networks (counterpart of `tak_tpu/pit.py`,
train/src/pit.rs).

Reference semantics: 128 games from 64 paired openings (each opening
played once with each color assignment), 50 Player-rollouts per move with
leaf batch 16 (pit.rs:5-7) — i.e. 800 virtual-loss descents per move —
exploitation move selection, no noise.  Openings are the forced `a1` +
random far corner + 2 random flat/cap placements (pit.rs:33-64), drawn
from `numpy.random.default_rng(seed)` as the JAX package draws them.

All games run in lockstep, split into two half-batches by which network
is to move (all lockstep games share ply parity), as in the JAX package.
`PitConfig.decide_threshold` is the lockstep form of the reference's early
exit (pit.rs:20-23): the whole batch stops once the unfinished games
cannot move win_rate across the gate threshold.
win_rate = wins / (wins + losses) (pit.rs:98-111).

Tree reuse matches the reference: both players' trees carry the played
subtree across moves (pit.rs:66-92).  Each (net, half-batch) pair keeps a
persistent batched tree, re-rooted after every ply; trees whose carried
subtree would crowd the node pool are blanked.  Moves are the argmax of
the root visits, so the pit is deterministic.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from .game import Game
from .mcts.reuse import blank_trees, reroot
from .mcts.search import MCTS, SearchConfig
from .types import CAP, FLAT, ONGOING, result_winner
from .utils.device import resolve_device


@dataclass
class PitConfig:
    games: int = 128             # PIT_GAMES
    komi: int = 2
    search: SearchConfig = field(
        default_factory=lambda: SearchConfig(num_sims=800, wave_size=16,
                                             max_children=128)
    )
    random_plies: int = 2        # RANDOM_PLIES (pit.rs:9)
    max_plies: int = 400
    tree_reuse: bool = True      # carry subtrees across plies (pit.rs:66-92)
    # search config of the `old` side (defaults to `search`): pits two
    # search configurations against each other
    search_b: SearchConfig | None = None
    # stop as soon as the gate decision is settled against this win-rate
    # threshold (pit.rs:20-23).  None = play all games.
    decide_threshold: float | None = None


@dataclass
class PitResult:
    wins: int = 0
    losses: int = 0
    draws: int = 0
    # games cut by the decide_threshold early exit: NOT draws (they never
    # finished; win_rate and the gate decision ignore them either way)
    unfinished: int = 0

    def win_rate(self) -> float:
        total = self.wins + self.losses
        return self.wins / total if total else 0.0

    def __str__(self) -> str:
        s = (f"PitResult {{ wins: {self.wins}, losses: {self.losses}, "
             f"draws: {self.draws}")
        if self.unfinished:
            s += f", unfinished: {self.unfinished}"
        return s + " }"


def _make_opening(engine, rng: np.random.Generator, komi: int,
                  random_plies: int = 2, device=None):
    """a1 + far corner + `random_plies` random flat/cap placements."""
    n = engine.n
    g = Game(n, half_komi=2 * komi, device=device)
    g.play_action(0, check=False)  # a1 flat
    corner = (n - 1) * n + (0 if rng.random() < 0.5 else n - 1)
    g.play_action(int(corner), check=False)
    actions = [0, int(corner)]
    for _ in range(random_plies):
        legal = g.legal_actions()
        moves = [a for a in legal
                 if engine.tables.action_to_move(int(a)).piece in (FLAT, CAP)
                 and not engine.tables.action_to_move(int(a)).is_spread]
        a = int(moves[rng.integers(0, len(moves))])
        g.play_action(a, check=False)
        actions.append(a)
    return actions


def pit(engine, eval_fn, new_params, old_params,
        config: PitConfig | None = None, seed: int = 0, log=print,
        stats: dict | None = None, device=None) -> PitResult:
    """Play `games` paired-opening games; positive result favors `new`.

    `stats`, when given, receives observability counters (`carried_n0`:
    total root visits carried into searches by tree reuse).  `device`
    defaults to the card."""
    cfg = config or PitConfig()
    dev = resolve_device(device)

    def _fill_budget(sc: SearchConfig) -> SearchConfig:
        if cfg.tree_reuse and sc.node_budget is None and not sc.recycle:
            # carried subtree (< per_move nodes) + one move's simulations;
            # recycling searches evict their own headroom instead
            per_move = sc.num_waves * sc.wave_size
            sc = dataclasses.replace(sc, node_budget=2 * per_move + 2)
        return sc

    search_cfg = _fill_budget(cfg.search)
    search_cfg_b = (
        _fill_budget(cfg.search_b) if cfg.search_b is not None else search_cfg
    )
    rng = np.random.default_rng(seed)
    mcts_a = MCTS(engine, eval_fn, search_cfg)
    mcts_b = (
        mcts_a if cfg.search_b is None else MCTS(engine, eval_fn, search_cfg_b)
    )
    mcts_of = (mcts_a, mcts_b)  # by net_id: new -> a, old -> b
    # unused: every move is the argmax of the visits
    gen = torch.Generator(device=dev).manual_seed(seed)
    if stats is not None:
        stats.setdefault("carried_n0", 0)

    n_openings = cfg.games // 2
    openings = [_make_opening(engine, rng, cfg.komi, cfg.random_plies, dev)
                for _ in range(n_openings)]

    # game i plays opening i % n_openings; new is white for i < n_openings
    B = 2 * n_openings
    states = engine.initial_batch(B, 2 * cfg.komi, dev)
    for p in range(len(openings[0])):
        acts = torch.tensor([openings[i % n_openings][p] for i in range(B)],
                            dtype=torch.int32, device=dev)
        states = engine.step(states, acts)
    new_is_white = np.array([i < n_openings for i in range(B)])

    result = PitResult()
    done = np.zeros(B, bool)
    H = n_openings
    ply = len(openings[0])
    exploit = torch.ones(H, dtype=torch.bool, device=dev)

    # persistent search trees per (net, half-batch): both nets advance
    # their trees every ply, like the reference's paired
    # Player::play_move calls (pit.rs:66-92)
    trees: dict = {}

    def room_of(sc: SearchConfig) -> int:
        return sc.max_nodes - sc.num_waves * sc.wave_size

    def search_half(net_id, params, half, half_states):
        mcts = mcts_of[net_id]
        tree = trees.get((net_id, half))
        if tree is None:
            tree = mcts.init_batch(half_states)
        if stats is not None:
            stats["carried_n0"] += int(tree.n0.sum())
        tree = mcts.prepare_root(params, tree)
        tree = mcts.run_sims(params, tree)
        if cfg.tree_reuse:
            trees[(net_id, half)] = tree
        return mcts.select_moves(gen, tree, exploit)

    def _decided() -> bool:
        """Gate outcome settled: even the extreme outcomes of the
        unfinished games cannot move win_rate across the threshold."""
        if cfg.decide_threshold is None:
            return False
        t = cfg.decide_threshold
        left = int((~done).sum())
        w, l = result.wins, result.losses
        best = (w + left) / max(w + left + l, 1)     # all remaining won
        worst = w / max(w + l + left, 1)             # all remaining lost
        return (worst > t) or (best <= t)

    while not done.all() and ply < cfg.max_plies and not _decided():
        # All lockstep games share ply parity: when white is to move, `new`
        # is the mover in exactly the first half (new_is_white block), so
        # each net searches one contiguous fixed-shape half-batch.
        to_move_white = (ply % 2) == 0
        first_half, second_half = states[:H], states[H:]
        if to_move_white:
            acts_a = search_half(0, new_params, 0, first_half)
            acts_b = search_half(1, old_params, 1, second_half)
        else:
            acts_a = search_half(1, old_params, 0, first_half)
            acts_b = search_half(0, new_params, 1, second_half)
        actions = torch.cat([acts_a, acts_b])
        live = torch.as_tensor(~done, device=dev)
        states = engine.step(states, actions, live)
        ply += 1

        if cfg.tree_reuse:
            halves = (states[:H], states[H:])
            half_actions = (acts_a, acts_b)
            for (net_id, half), tree in list(trees.items()):
                sc = mcts_of[net_id].config
                t = reroot(engine, tree, half_actions[half], halves[half],
                           sc.max_children)
                if not sc.recycle:
                    # recycling searches evict their own headroom
                    stale = t.next_free > room_of(sc)
                    if bool(stale.any()):
                        t = blank_trees(t, halves[half], stale)
                trees[(net_id, half)] = t
        results = states.result.cpu().numpy()
        for i in range(B):
            if done[i] or results[i] == ONGOING:
                continue
            done[i] = True
            winner = int(result_winner(np.int32(results[i])))
            if winner < 0:
                result.draws += 1
            elif (winner == 0) == bool(new_is_white[i]):
                result.wins += 1
            else:
                result.losses += 1
        if ply % 20 == 0:
            log(f"pit ply {ply}: {int(done.sum())}/{B} finished {result}")

    if not done.all() and ply >= cfg.max_plies:
        result.draws += int((~done).sum())  # max-ply stalemates: draws
    else:
        result.unfinished += int((~done).sum())  # decide_threshold cut
    return result
