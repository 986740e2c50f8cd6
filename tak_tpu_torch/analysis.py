"""Game analysis: annotated PTN output with evals, marks, and branches.

Counterpart of `tak_tpu/analysis.py`, the reference's analysis pipeline
(`alpha-tak/src/analysis.rs` + `alpha-tak/src/search/debug.rs`) on the
tensor tree:

  * `NodeDebugInfo` — root children sorted by visits with expected reward,
    prior, and principal-variation continuation (debug.rs:8-35)
  * visit-weighted root evaluation (debug.rs:43-49)
  * move marks from eval swings: ?? / ? / ! / !! (analysis.rs:64-75)
  * alternative-line branches for children with >= 0.9x the top visits
    (analysis.rs:8-9,84-88), branch lines limited to 10 plies and
    10,000-visit continuations (analysis.rs:7-8,197-234)
  * `{evaluation: +x.xxx}` comments consumed by tools/graph.py
    (analysis.rs:108-115, graph.py:15-20)

The emitted PTN keeps the reference's exact layout, including games that
start as black / mid-position (analysis.rs:122-143; unit test parity with
analysis.rs:260-281).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

MAX_BRANCH_LENGTH = 10
BRANCH_MIN_VISITS = 10_000
CANDIDATE_MOVE_RATIO = 0.9


@dataclass
class MoveInfo:
    mov: str                     # PTN
    visits: int
    reward: float
    policy: float
    continuation: list = field(default_factory=list)  # [(ptn, visits)]

    def ptn_comment(self, flip_reward: bool) -> str:
        ev = -self.reward if flip_reward else self.reward
        return f" {{r: {ev:+.3f}, p: {self.policy:.4f}, v: {self.visits}}}"

    def table_row(self) -> str:
        cont = " ".join(m for m, _v in self.continuation)
        return (f"{self.mov: <8} {self.visits: >8} {self.reward: >+8.4f} "
                f"{self.policy: >8.4f} | {cont}")


@dataclass
class NodeDebugInfo:
    """Children of a searched node, sorted by descending visits."""

    moves: list  # [MoveInfo]

    def eval(self) -> float:
        total = sum(mi.visits for mi in self.moves)
        if total == 0:
            return 0.0
        return sum(mi.reward * mi.visits / total for mi in self.moves)

    def maybe_flip(self, flip: bool) -> "NodeDebugInfo":
        if flip:
            for mi in self.moves:
                mi.reward = -mi.reward
        return self

    def format(self, limit: int = 10) -> str:
        if not self.moves:
            return "Node has no children"
        out = [f"evaluation: {self.eval():+.4f}",
               "turn      visited   reward   policy | continuation"]
        out += [mi.table_row() for mi in self.moves[:limit]]
        return "\n".join(out) + "\n"


def _principal_lines(tree, game_index: int, roots, depth: int):
    """Most-visited lines below the root children `roots` (node ids, a
    tensor [R]), walked on the tree's device for all of them at once, so
    that only the lines themselves cross to the host and not the edge
    tier (three [M, K] arrays, 64 MB each at M=131,072, K=128).
    Returns numpy (actions [R, depth], visits [R, depth]); a line ends at
    the first action of NONE."""
    from .mcts.tree import NONE
    from .mcts.tree_kernels import _last_argmax

    g = game_index
    R = roots.shape[0]
    rows = torch.arange(R, device=roots.device)
    node = roots.long()
    alive = torch.ones(R, dtype=torch.bool, device=roots.device)
    acts, vis = [], []
    for _ in range(depth):
        alive = alive & (node != NONE)
        ci = torch.clamp(node, min=0)
        e_n = tree.edge_n[g, ci]                           # [R, K]
        alive = alive & (e_n.sum(-1) != 0)
        best = _last_argmax(e_n)
        acts.append(torch.where(alive, tree.edge_action[g, ci, best],
                                torch.full_like(best, NONE, dtype=torch.int32)))
        vis.append(e_n[rows, best])
        node = tree.edge_child[g, ci, best].long()
    if not acts:
        empty = np.zeros((R, 0), np.int32)
        return empty, empty
    return (torch.stack(acts, 1).cpu().numpy(),
            torch.stack(vis, 1).cpu().numpy())


def tree_debug_info(engine, tree, game_index: int = 0,
                    depth: int = MAX_BRANCH_LENGTH) -> NodeDebugInfo:
    """Extract root debug info from a batched search tree (debug.rs:7-24)."""
    from .mcts.tree import NONE

    def host(x):
        return x[game_index].cpu().numpy()

    child = host(tree.root_child)
    prior = host(tree.root_prior)
    legal = host(tree.root_legal)
    root_n = host(tree.root_n)
    root_w = host(tree.root_w)

    legal_ids = np.nonzero(legal)[0]
    with_child = legal_ids[child[legal_ids] != NONE]
    line_acts, line_vis = _principal_lines(
        tree, game_index,
        torch.as_tensor(child[with_child], device=tree.root_child.device),
        depth - 1)
    line_of = {int(a): i for i, a in enumerate(with_child)}

    def continuation(a: int):
        if a not in line_of:
            return []
        line = []
        for act, visits in zip(line_acts[line_of[a]], line_vis[line_of[a]]):
            if act == NONE:
                break
            line.append((engine.tables.action_to_ptn(int(act)), int(visits)))
        return line

    moves = []
    for a in legal_ids:
        visits = int(root_n[a])
        reward = float(root_w[a] / root_n[a]) if visits > 0 else 0.0
        moves.append(MoveInfo(
            mov=engine.tables.action_to_ptn(int(a)),
            visits=visits,
            reward=reward,
            policy=float(prior[a]),
            continuation=continuation(int(a)),
        ))
    moves.sort(key=lambda mi: mi.visits, reverse=True)
    return NodeDebugInfo(moves)


class Analysis:
    """Accumulates a game's moves + search info, renders annotated PTN."""

    def __init__(self, board_size: int, half_komi: int, start_ply: int = 0):
        komi = str(half_komi // 2 if half_komi >= 0 else -((-half_komi) // 2))
        if half_komi % 2 != 0:
            komi += ".5"
        self.settings = f'[Size "{board_size}"]\n[Komi "{komi}"]\n'
        self.start_ply = start_ply
        self.played_moves: list[str] = []
        self.move_info: list[MoveInfo | None] = []
        self.branches: list[tuple[int, MoveInfo]] = []
        self.evals: list[float] = []
        self.marks: list[tuple[int, str]] = []

    def add_setting(self, name: str, value) -> None:
        self.settings += f'[{name} "{value}"]\n'

    def add_move_without_info(self, mov: str) -> None:
        self.played_moves.append(mov)
        self.move_info.append(None)

    def add_move(self, mov: str, info: MoveInfo, eval_: float) -> None:
        self.played_moves.append(mov)
        self.move_info.append(info)
        self.evals.append(eval_)

    def update(self, debug_info: NodeDebugInfo, played_move: str) -> None:
        """Record a searched move + candidate branches (analysis.rs:52-89)."""
        ply = self.start_ply + len(self.played_moves)
        top_visits = debug_info.moves[0].visits if debug_info.moves else 0
        ev = debug_info.eval()

        if self.evals:
            eval_diff = -(ev + self.evals[-1])  # perspectives flip per ply
            if eval_diff <= -0.4:
                self.marks.append((ply - 1, "??"))
            elif -0.4 <= eval_diff <= -0.15:
                self.marks.append((ply - 1, "?"))
            elif 0.1 <= eval_diff <= 0.3:
                self.marks.append((ply - 1, "!"))
            elif eval_diff > 0.3:
                self.marks.append((ply - 1, "!!"))

        recorded = False
        for info in debug_info.moves:
            if info.mov == played_move and not recorded:
                self.add_move(played_move, info, ev)
                recorded = True
                continue
            if info.visits > top_visits * CANDIDATE_MOVE_RATIO:
                self.branches.append((ply, info))
        if not recorded:
            self.add_move_without_info(played_move)

    def without_branches(self) -> "Analysis":
        self.branches = []
        return self

    # -- rendering (analysis.rs:97-195) --------------------------------------

    def __str__(self) -> str:
        out = [self.settings]
        moves = iter(self.played_moves)
        infos = iter(self.move_info)
        evals = iter(self.evals)
        marks = list(self.marks)
        ply = self.start_ply

        next(evals, None)  # show the eval *after* each move is played

        def mark_for(p):
            if marks and marks[0][0] == p:
                return marks.pop(0)[1]
            return ""

        def emit(mov, is_white):
            # white flips the eval comment (shown from white's perspective:
            # the stored eval is the *next* position's, i.e. black to move);
            # black flips the r: reward instead (analysis.rs:148-186)
            s = mov + mark_for(ply)
            info = next(infos, None)
            if info is not None:
                ev = next(evals, None)
                if ev is not None:
                    s += f"{{evaluation: {(-ev if is_white else ev):+.3f}}}"
                s += info.ptn_comment(not is_white)
            return s

        if self.start_ply % 2 != 0:
            line = f"{ply // 2 + 1}. -- "
            black = next(moves, None)
            if black is not None:
                line += emit(black, False)
            out.append(line + "\n")
            ply += 1

        while True:
            white = next(moves, None)
            if white is None:
                break
            line = f"{ply // 2 + 1}. " + emit(white, True)
            ply += 1
            line += " "
            black = next(moves, None)
            if black is not None:
                line += emit(black, False)
            out.append(line + "\n")
            ply += 1

        for bply, info in self.branches:
            out.append("\n" + _format_branch(bply, info))

        return "".join(out)


def _format_branch(ply: int, info: MoveInfo) -> str:
    out = f"{{{ply}_{info.mov}}}\n"
    cont = iter(m for m, v in info.continuation if v > BRANCH_MIN_VISITS)
    move_num = 1 + ply // 2
    if ply % 2 == 0:
        # exact reference spacing (analysis.rs:212-219), including the
        # double space produced by ptn_comment's leading space
        out += (f"{move_num}. {info.mov} {info.ptn_comment(False)} "
                f"{next(cont, '')}\n")
    else:
        out += f"{move_num}. -- {info.mov}{info.ptn_comment(True)}\n"
    move_num += 1
    while True:
        white = next(cont, None)
        if white is None:
            break
        out += f"{move_num}. {white} {next(cont, '')}\n"
        move_num += 1
    return out
