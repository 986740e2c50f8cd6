"""Single-game search orchestrator (the reference's `Player`).

Counterpart of `tak_tpu/player.py` (`alpha-tak/src/player.rs`): each
`rollout()` call runs one wave of `wave_size` virtual-loss descents fused
with a batched network evaluation.  The tree persists across `rollout()`
calls (pondering); see `node_budget` for capacity.  With the defaults
(wave 64, K=128, a 131,072-node pool, no recycling) the search runs on
the large-tree tier (`mcts/tree_kernels_hbm.py`).

Tree reuse across moves re-roots ON DEVICE (`mcts/reuse.reroot`): the
played subtree's nodes, edge statistics, and visit counts carry into the
next search (the reference's `Node::play`, search/play.rs:26-43), with
one guard: a carried subtree that nearly fills the node pool is dropped
instead (a full pool would starve the next search; see play_move).
Examples and Analysis capture matches player.rs:136-193.

The player works on the device of `game.state`.  Random draws (root
noise, the sampled move) come from `generator`, a torch.Generator on that
device.
"""

from __future__ import annotations

import numpy as np
import torch

from .analysis import Analysis, NodeDebugInfo, tree_debug_info
from .engine.core import Engine
from .examples import Example, state_to_host
from .game import Game
from .mcts.reuse import reroot
from .mcts.search import MCTS, SearchConfig
from .mcts.tree import root_visit_counts


class Player:
    def __init__(
        self,
        engine: Engine,
        eval_fn,
        params,
        game: Game,
        *,
        wave_size: int = 64,
        max_children: int = 128,
        # default fits the large-tree tier (tree_kernels_hbm.MAX_HBM_NODES)
        # while comfortably covering the 50k-rollout ponder cap
        # (playtak/src/main.rs:32) plus a carried reuse subtree; with
        # `recycle` the default drops to the bounded pool tier instead
        node_budget: int | None = None,
        # recycled pool tier for pondering: a bounded pool with cold-leaf
        # eviction serves any rollout count, at the cost of bounded-pool
        # truncation
        recycle: bool = False,
        save_examples: bool = False,
        create_analysis: bool = False,
        generator: torch.Generator | None = None,
    ):
        self.engine = engine
        self.params = params
        self.game = game.clone()
        self.device = game.state.device
        if node_budget is None:
            node_budget = 1280 if recycle else 131_072
        if recycle:
            max_children = min(max_children, 32)  # pool-tier edge width
        cfg = SearchConfig(
            num_sims=wave_size,
            wave_size=wave_size,
            max_children=max_children,
            node_budget=node_budget,
            recycle=recycle,
        )
        self.mcts = MCTS(engine, eval_fn, cfg)
        self._reroot = lambda t, a, s: reroot(engine, t, a, s, max_children)
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.seed()
        self.generator = generator
        self.save_examples = save_examples
        self.examples: list[Example] = []
        self.analysis = Analysis(
            engine.n, int(game.state.half_komi[0]), game.ply
        ) if create_analysis else None
        self.tree = None
        self._root_prepared = False
        self.sims_done = 0

    # -- search --------------------------------------------------------------

    def _ensure_tree(self):
        if self.tree is None:
            self.tree = self.mcts.init_batch(self.game.state)
            self._root_prepared = False
        if not self._root_prepared:
            # evaluates the root's full-width prior; no-op if expanded
            self.tree = self.mcts.prepare_root(self.params, self.tree)
            self._root_prepared = True
            self.sims_done = 0

    def rollout(self, waves: int = 1) -> int:
        """Run `waves` evaluation waves; returns sims performed."""
        self._ensure_tree()
        for _ in range(waves):
            self.tree = self.mcts.run_sims(self.params, self.tree)
        sims = waves * self.mcts.config.wave_size
        self.sims_done += sims
        return sims

    def add_noise(self, alpha: float, ratio: float) -> None:
        self._ensure_tree()
        self.tree = self.mcts.add_noise(
            self.generator, self.tree, alpha, ratio,
            torch.ones(1, dtype=torch.bool, device=self.device)
        )

    def pick_move(self, exploitation: bool = True) -> int:
        self._ensure_tree()
        acts = self.mcts.select_moves(
            self.generator, self.tree,
            torch.tensor([exploitation], device=self.device)
        )
        return int(acts[0])

    def debug(self, depth: int = 10) -> NodeDebugInfo:
        self._ensure_tree()
        return tree_debug_info(self.engine, self.tree, 0, depth)

    # -- game advancement ----------------------------------------------------

    def play_move(self, move, with_info: bool = True) -> None:
        """Record example/analysis for the current position, then advance."""
        if isinstance(move, str):
            action = self.engine.tables.ptn_to_action(move)
        else:
            action = int(move)
        ptn = self.engine.tables.action_to_ptn(action)

        if with_info and self.tree is not None:
            if self.save_examples:
                visits = root_visit_counts(self.tree)[0].cpu().numpy()
                nz = np.nonzero(visits)[0].astype(np.int32)
                if nz.size:
                    self.examples.append(Example(
                        state=state_to_host(self.game.state),
                        actions=nz,
                        visits=visits[nz].astype(np.int32),
                    ))
            if self.analysis is not None:
                self.analysis.update(self.debug(), ptn)
        elif self.analysis is not None:
            self.analysis.add_move_without_info(ptn)

        self.game.play_action(action, check=False)
        if self.tree is not None:
            # keep the played subtree (search/play.rs:26-43); prepare_root
            # restores the full-width prior on the next rollout
            self.tree = self._reroot(
                self.tree, torch.tensor([action], device=self.device),
                self.game.state
            )
            self._root_prepared = False
            # a carried subtree that nearly fills the node pool would
            # starve subsequent searches (full-pool descents back up into
            # n0 only); drop the tree and restart fresh instead.  A
            # recycling search evicts its own headroom, so it keeps any
            # carried subtree.
            if (not self.mcts.config.recycle
                    and int(self.tree.next_free[0])
                    > self.mcts.config.max_nodes // 2):
                self.tree = None

    # -- results -------------------------------------------------------------

    def get_examples(self, white_result: float) -> list[Example]:
        """Complete pending examples with the game outcome (player.rs:171-193)."""
        out = []
        for ex in self.examples:
            to_move = int(ex.state["to_move"])
            ex.result = white_result if to_move == 0 else -white_result
            out.append(ex)
        self.examples = []
        return out

    def get_analysis(self) -> Analysis:
        analysis = self.analysis
        self.analysis = Analysis(
            self.engine.n,
            int(self.game.state.half_komi[0]),
            self.game.ply,
        )
        return analysis
