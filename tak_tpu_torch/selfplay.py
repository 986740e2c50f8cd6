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

Gumbel mode (`search.gumbel_m > 0`, `tak_tpu/selfplay.py:118-122`):
sequential halving replaces PUCT at the root, the Gumbel sample replaces
Dirichlet noise, the move is `select_moves_gumbel`'s, and the training
targets are round(gumbel_policy_weights * 65535) instead of visit counts.
`quad_rollout_plies` (workers == 1 only) searches 4x the rollouts while
ply < quad_rollout_plies, as the reference's sequential self-play does.

The move tail always reads the dense root targets; the reference reads a
sparse top-512 and falls back to this dense read on overflow, which gives
the same examples.

Random draws: the openings use `numpy.random.default_rng(seed)` as the
JAX package does; root noise and move sampling use a torch.Generator on
the search device seeded with `seed`.

Sharded (`mesh=`, `parallel/actor.py`): the device work (states, trees,
search, every kernel) runs on this rank's block of the `workers` game
slots, while the host bookkeeping (plies, resets, openings, instant wins,
examples) runs on every rank over all slots from gathered readbacks, and
the random draws are those of one process holding every game: a sharded
generation gives exactly the single-process examples, on every rank.
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
from .parallel.actor import ShardedEnv
from .types import FIELDS, ONGOING, result_winner, where_state
from .utils.device import resolve_device
from .utils.profiling import span

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
    # reference sequential self-play quadruples rollouts while
    # ply < QUAD_ROLLOUT_PLIES (self_play.rs:19,63-67); workers == 1 only
    quad_rollout_plies: int = 0


class SelfPlayActor:
    def __init__(self, engine, eval_fn, config: SelfPlayConfig, device=None,
                 mesh=None):
        """`mesh` (`parallel.mesh.Mesh`): shard the `workers` game slots
        over its ranks (`workers` must divide by the world size, so quad
        rollouts, one game, refuse W > 1); the device is the mesh's."""
        self.engine = engine
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
        if config.quad_rollout_plies > 0 and config.workers != 1:
            raise ValueError(
                "quad_rollout_plies matches the reference's SEQUENTIAL "
                "self-play (self_play.rs:21-92) and requires workers=1")
        self.env = ShardedEnv(engine, mesh, config.workers, self.device)
        quad = 4 if config.quad_rollout_plies > 0 else 1
        search = config.search
        if search.node_budget is None:
            per_move = search.num_sims * quad
            if search.recycle:
                budget = min(RECYCLE_POOL, per_move * 2 + 2)
                budget = max(budget, 4 * search.wave_size)
                if search.scan_chunk is None and search.num_sims > 1024:
                    search = dataclasses.replace(search, scan_chunk=512)
            else:
                budget = per_move + 2 + (per_move if config.tree_reuse else 0)
            search = dataclasses.replace(search, node_budget=budget)
        self._per_move_sims = search.num_sims * quad
        self.search_config = search
        self.mcts = MCTS(engine, eval_fn, search)
        self._gumbel = search.gumbel_m > 0
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
        """Fresh boards in the slots of the host mask [workers]."""
        fresh = self.env.initial_batch(2 * self.config.komi)
        return where_state(self.env.local(mask), fresh, states)

    def _move_tail(self, tree, states, actions, active):
        """Everything after move selection: root visit counts, the pre-move
        snapshot, the masked env step, the reroot and the next any-win
        flag, read back to the host together (every slot's, on every
        rank)."""
        cfg = self.config
        act = self.env.local(active)
        visits = self._root_targets(tree)
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
        gather = self.env.gather
        with span("selfplay.readback", sync=5 + len(FIELDS)):
            host = (gather(visits).cpu().numpy(), gather(states).to_numpy(),
                    gather(new_states.result).cpu().numpy(),
                    gather(new_states.ply).cpu().numpy(),
                    gather(any_win).cpu().numpy(),
                    gather(new_tree.next_free).cpu().numpy())
        return new_tree, new_states, host

    def _root_targets(self, tree):
        """Training targets per root action [B, A] int32: the visit counts,
        or in Gumbel mode round(gumbel_policy_weights * 65535)."""
        if self._gumbel:
            w = self.mcts.gumbel_policy_weights(tree)
            return torch.round(w * 65535.0).to(torch.int32)
        return root_visit_counts(tree)

    @torch.no_grad()
    def run(self, params, seed: int = 0, log=print, example_sink=None):
        """Produce one generation of examples.  Returns list[Example] (the
        same on every rank of a mesh)."""
        cfg = self.config
        engine = self.engine
        env = self.env
        mesh = self.mesh
        B = cfg.workers
        rng = np.random.default_rng(seed)
        gen = torch.Generator(device=self.device).manual_seed(seed)

        states = env.initial_batch(2 * cfg.komi)
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

        while active.any():
            with span("selfplay.move"):
                # openings, then the instant-win scan (its flag rides in
                # the previous move's readback); the boards a win resets
                # get theirs at once, until a search is due
                while True:
                    fresh = (plies == 0) & active
                    if fresh.any():
                        with span("selfplay.openings"):
                            first, second = self._opening_actions(rng, B)
                            states = env.step(states, first, fresh)
                            states = env.step(states, second, fresh)
                            plies[fresh] += 2
                    reset_mask = np.zeros(B, bool)
                    if cfg.instant_win_scan:
                        any_win = any_win_host & active
                        if any_win.any():
                            with span("selfplay.instant_win",
                                      sync=2 + len(FIELDS)):
                                wins = env.gather(
                                    engine.wins_in_one(states)).cpu().numpy()
                                legal = env.gather(
                                    engine.legal_mask(states)).cpu().numpy()
                                host_states = env.gather(states).to_numpy()
                            for i in np.nonzero(any_win)[0]:
                                acts = np.nonzero(legal[i])[0].astype(np.int32)
                                visits = np.where(wins[i][acts],
                                                  INSTANT_WIN_VISITS,
                                                  1).astype(np.int32)
                                pending[i].append(Example(
                                    state={k: v[i].copy()
                                           for k, v in host_states.items()},
                                    actions=acts, visits=visits))
                                white = 1.0 if int(
                                    host_states["to_move"][i]) == 0 else -1.0
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
                    if not reset_mask.any() or not active.any():
                        break
                if not active.any():
                    break

                # batched search (trees persist across moves when reuse is
                # on)
                t_move = time.perf_counter()
                with span("selfplay.tree"):
                    if tree is None or not cfg.tree_reuse:
                        tree = self.mcts.init_batch(states)
                        tree_stale[:] = False
                    elif tree_stale.any():
                        tree = blank_trees(tree, states,
                                           env.local(tree_stale))
                        tree_stale[:] = False
                    tree = self.mcts.prepare_root(params, tree)
                quad = (cfg.quad_rollout_plies > 0
                        and int(plies[0]) < cfg.quad_rollout_plies)
                if self._gumbel:
                    tree, gumbel = self.mcts.run_sims_gumbel(params, tree,
                                                             gen, mesh)
                    with span("selfplay.select"):
                        actions = self.mcts.select_moves_gumbel(tree, gumbel)
                else:
                    with span("selfplay.noise"):
                        noise_mask = env.local((plies < cfg.noise_plies)
                                               & active)
                        tree = self.mcts.add_noise(gen, tree, cfg.noise_alpha,
                                                   cfg.noise_ratio,
                                                   noise_mask, mesh)
                    tree = self.mcts.run_sims(params, tree)
                    if quad:
                        for _ in range(3):  # 4x total (self_play.rs:63-67)
                            tree = self.mcts.run_sims(params, tree)
                    # the whole batch's exploit flags: the choice is made on
                    # every rank's gathered visits
                    with span("selfplay.select"):
                        with span("selfplay.upload", sync=True):
                            exploit = torch.as_tensor(
                                plies >= cfg.exploit_plies,
                                device=self.device)
                        actions = self.mcts.select_moves(gen, tree, exploit,
                                                         mesh)
                factor = 4 if quad else 1
                move_sims = factor * self.search_config.num_waves * \
                    self.search_config.wave_size
                sims_done += factor * cfg.search.num_sims * int(active.sum())

                with span("selfplay.tail"):
                    tree, new_states, host = self._move_tail(
                        tree, states, actions, active)
                (visits_all, host_states, results, new_plies, any_win_next,
                 next_free) = host
                self.move_times.append((time.perf_counter() - t_move,
                                        move_sims))

                with span("selfplay.examples"):
                    for i in range(B):
                        if not active[i]:
                            continue
                        nz = np.nonzero(visits_all[i])[0].astype(np.int32)
                        pending[i].append(Example(
                            state={k: v[i].copy()
                                   for k, v in host_states.items()},
                            actions=nz,
                            visits=visits_all[i][nz].astype(np.int32)))

                    states = new_states
                    plies = new_plies.astype(np.int64)
                    any_win_host = np.array(any_win_next)
                    if cfg.tree_reuse and not self.search_config.recycle:
                        room = self.search_config.max_nodes - \
                            self._per_move_sims
                        tree_stale |= next_free > room

                    reset_mask = np.zeros(B, bool)
                    for i in range(B):
                        if not active[i]:
                            continue
                        if results[i] != ONGOING \
                                or new_plies[i] >= cfg.max_plies:
                            winner = int(result_winner(results[i]))
                            white = 1.0 if winner == 0 else (
                                -1.0 if winner == 1 else 0.0)
                            finish_slot(i, white)
                            reset_mask[i] = True
                            log(f"game {completed}/{cfg.games} done "
                                f"({new_plies[i]} plies, result "
                                f"{int(results[i])})")
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
