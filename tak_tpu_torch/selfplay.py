"""Lockstep self-play actor (counterpart of `tak_tpu/selfplay.py`).

`workers` games run in lockstep; every move is one batched MCTS (waves of
virtual-loss descents fused with network evaluation), and finished games
are reset in place until the generation quota is met.  Reference-parity
behaviors (train/src/self_play.rs):

  * komi 2; forced opening `a1`, then a random far-corner reply
  * instant-win scan before searching: if a legal move wins on the spot,
    record a fake policy (1000 visits on winning moves, 1 on every other
    legal move) and finish the game without search
  * Dirichlet noise alpha=0.2 ratio=0.3 at the root while ply < 80
  * sample the move by visit count before ply 40, argmax after
  * one example per searched move, completed at game end with +-1/0 from
    the mover's perspective

Random draws: the openings use `numpy.random.default_rng(seed)` as the
JAX package does; root noise and move sampling use a torch.Generator on
the search device seeded with `seed`.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .examples import Example
from .mcts.reuse import blank_trees, reroot
from .mcts.search import MCTS, SearchConfig
from .mcts.tree import root_visit_counts
from .types import ONGOING, result_winner, where_state
from .utils.device import resolve_device

INSTANT_WIN_VISITS = 1000  # fake visits for winning moves (self_play.rs:131)
# default node pool for recycled searches; eviction serves sim budgets far
# beyond the pool size
RECYCLE_POOL = 1280


@dataclass
class SelfPlayConfig:
    games: int = 1000            # SELF_PLAY_GAMES (self_play.rs:10)
    workers: int = 32            # lockstep games (self_play.rs:94)
    komi: int = 2
    search: SearchConfig = field(default_factory=SearchConfig)
    noise_alpha: float = 0.2
    noise_ratio: float = 0.3
    noise_plies: int = 80
    exploit_plies: int = 40
    instant_win_scan: bool = True
    tree_reuse: bool = True      # keep the played subtree (play.rs:26-43)
    max_plies: int = 400         # safety valve for pathological games


class SelfPlayActor:
    def __init__(self, engine, eval_fn, config: SelfPlayConfig, device=None):
        self.engine = engine
        self.config = config
        self.device = resolve_device(device)
        search = config.search
        if search.node_budget is None:
            per_move = search.num_sims
            if search.recycle:
                budget = min(RECYCLE_POOL, per_move * 2 + 2)
                budget = max(budget, 4 * search.wave_size)
                if search.scan_chunk is None and search.num_sims > 1024:
                    search = dataclasses.replace(search, scan_chunk=512)
            else:
                budget = per_move + 2 + (per_move if config.tree_reuse else 0)
            search = dataclasses.replace(search, node_budget=budget)
        self.search_config = search
        self.mcts = MCTS(engine, eval_fn, search)
        # wall seconds and searched sims of each searched move (last run)
        self.move_times: list[float] = []

    def _opening_actions(self, rng: np.random.Generator, count: int):
        """Forced a1, then a far corner at random (self_play.rs:110-117)."""
        n = self.engine.n
        first = np.full(count, 0, np.int32)
        corners = np.array([(n - 1) * n + 0, (n - 1) * n + (n - 1)], np.int32)
        second = corners[rng.integers(0, 2, size=count)]
        return first, second

    def _reset(self, states, mask):
        fresh = self.engine.initial_batch(mask.shape[0], 2 * self.config.komi,
                                          self.device)
        return where_state(torch.as_tensor(mask, device=self.device), fresh,
                           states)

    def _move_tail(self, tree, states, actions, active):
        """Everything after move selection: root visit counts, the pre-move
        snapshot, the masked env step, the reroot and the next any-win
        flag, read back to the host together."""
        cfg = self.config
        act = torch.as_tensor(active, device=self.device)
        visits = root_visit_counts(tree)
        new_states = self.engine.step(states, actions, act)
        if cfg.tree_reuse:
            new_tree = reroot(self.engine, tree, actions, new_states,
                              self.search_config.max_children,
                              keep=self.search_config.reroot_keep)
        else:
            new_tree = tree
        if cfg.instant_win_scan:
            any_win = self.engine.wins_in_one(new_states).any(-1)
        else:
            any_win = torch.zeros_like(act)
        host = (visits.cpu().numpy(), states.to_numpy(),
                new_states.result.cpu().numpy(), new_states.ply.cpu().numpy(),
                any_win.cpu().numpy())
        return new_tree, new_states, host

    @torch.no_grad()
    def run(self, params, seed: int = 0, log=print, example_sink=None):
        """Produce one generation of examples.  Returns list[Example]."""
        cfg = self.config
        engine = self.engine
        B = cfg.workers
        rng = np.random.default_rng(seed)
        gen = torch.Generator(device=self.device).manual_seed(seed)

        states = engine.initial_batch(B, 2 * cfg.komi, self.device)
        tree = None
        tree_stale = np.ones(B, bool)
        pending: list[list[Example]] = [[] for _ in range(B)]
        active = np.ones(B, bool)
        started = B
        completed = 0
        examples: list[Example] = []
        sims_done = 0
        self.move_times = []
        t_start = time.time()

        def finish_slot(i, white_result):
            nonlocal completed
            for ex in pending[i]:
                to_move = int(ex.state["to_move"])
                ex.result = white_result if to_move == 0 else -white_result
            examples.extend(pending[i])
            if example_sink is not None:
                for ex in pending[i]:
                    example_sink(ex)
            pending[i] = []
            completed += 1

        plies = np.zeros(B, np.int64)
        any_win_host = np.zeros(B, bool)  # fresh boards can't win in one

        def dev(x):
            return torch.as_tensor(x, device=self.device)

        while active.any():
            fresh = (plies == 0) & active
            if fresh.any():
                first, second = self._opening_actions(rng, B)
                states = engine.step(states, dev(first), dev(fresh))
                states = engine.step(states, dev(second), dev(fresh))
                plies[fresh] += 2

            # instant-win scan: the flag rides in the previous move's readback
            reset_mask = np.zeros(B, bool)
            if cfg.instant_win_scan:
                any_win = any_win_host & active
                if any_win.any():
                    wins = engine.wins_in_one(states).cpu().numpy()
                    legal = engine.legal_mask(states).cpu().numpy()
                    host_states = states.to_numpy()
                    for i in np.nonzero(any_win)[0]:
                        acts = np.nonzero(legal[i])[0].astype(np.int32)
                        visits = np.where(wins[i][acts], INSTANT_WIN_VISITS,
                                          1).astype(np.int32)
                        pending[i].append(Example(
                            state={k: v[i].copy()
                                   for k, v in host_states.items()},
                            actions=acts, visits=visits))
                        white = 1.0 if int(host_states["to_move"][i]) == 0 \
                            else -1.0
                        finish_slot(i, white)
                        reset_mask[i] = True
                if reset_mask.any():
                    any_win_host[reset_mask] = False
                    plies[reset_mask] = 0
                    if started < cfg.games:
                        started += int(reset_mask.sum())
                        states = self._reset(states, reset_mask)
                    else:
                        active &= ~reset_mask
                    tree_stale |= reset_mask
                    if not active.any():
                        break
                    continue  # fresh boards get openings next iteration

            # batched search (trees persist across moves when reuse is on)
            t_move = time.perf_counter()
            if tree is None or not cfg.tree_reuse:
                tree = self.mcts.init_batch(states)
                tree_stale[:] = False
            elif tree_stale.any():
                tree = blank_trees(tree, states, dev(tree_stale))
                tree_stale[:] = False
            tree = self.mcts.prepare_root(params, tree)
            noise_mask = dev((plies < cfg.noise_plies) & active)
            tree = self.mcts.add_noise(gen, tree, cfg.noise_alpha,
                                       cfg.noise_ratio, noise_mask)
            tree = self.mcts.run_sims(params, tree)
            actions = self.mcts.select_moves(
                gen, tree, dev(plies >= cfg.exploit_plies))
            move_sims = self.search_config.num_waves * \
                self.search_config.wave_size
            sims_done += cfg.search.num_sims * int(active.sum())

            tree, new_states, host = self._move_tail(tree, states, actions,
                                                     active)
            visits_all, host_states, results, new_plies, any_win_next = host
            self.move_times.append((time.perf_counter() - t_move, move_sims))

            for i in range(B):
                if not active[i]:
                    continue
                nz = np.nonzero(visits_all[i])[0].astype(np.int32)
                pending[i].append(Example(
                    state={k: v[i].copy() for k, v in host_states.items()},
                    actions=nz, visits=visits_all[i][nz].astype(np.int32)))

            states = new_states
            plies = new_plies.astype(np.int64)
            any_win_host = np.array(any_win_next)
            if cfg.tree_reuse and not self.search_config.recycle:
                room = self.search_config.max_nodes - self.search_config.num_sims
                tree_stale |= tree.next_free.cpu().numpy() > room

            reset_mask = np.zeros(B, bool)
            for i in range(B):
                if not active[i]:
                    continue
                if results[i] != ONGOING or new_plies[i] >= cfg.max_plies:
                    winner = int(result_winner(results[i]))
                    white = 1.0 if winner == 0 else (-1.0 if winner == 1
                                                     else 0.0)
                    finish_slot(i, white)
                    reset_mask[i] = True
                    log(f"game {completed}/{cfg.games} done "
                        f"({new_plies[i]} plies, result {int(results[i])})")
            if reset_mask.any():
                tree_stale |= reset_mask
                plies[reset_mask] = 0
                any_win_host[reset_mask] = False
                if started < cfg.games:
                    started += int(reset_mask.sum())
                    states = self._reset(states, reset_mask)
                else:
                    active &= ~reset_mask
            if completed >= cfg.games:
                break

        dt = time.time() - t_start
        if dt > 0:
            log(f"self-play: {completed} games, {len(examples)} examples, "
                f"{sims_done / dt:,.0f} sims/s")
        return examples
