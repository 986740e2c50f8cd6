"""The plain reference of the pool tier's tree waves (`reference/tree.py`)
against the program's kernels, through their plain versions on the CPU:
on the program's hand-built trees (`tak_tpu_torch/mcts/tree_cases.py`:
a full pool whose creates evict, the create's own parent as the coldest
node, no node to evict, tied and clamped keys, leaves in flight unpinned
and evicted in one wave, a shared prefix, repeated leaves, a deep chain)
the replay of a descend wave, a merged backup+descend wave and the
expand+backup flush finds nothing wrong; with the kernels broken (the
exploration term negated, the backup's sign flipped, the priors of a new
row reversed, the eviction's parent left attached) it finds launches
wrong."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import tree as ref_tree

V = 8
POOL = ("evict_parent", "no_candidate", "tied_keys", "merged_unpin")
HAND = ("shared_prefix", "dups_twice", "one_leaf", "deep_chain")
SHAPES = {"4x4_k8": (4, 8), "3x3_k32": (3, 32)}
# the hand-built trees of the large tier fill rows of K=8 only
CASES = ([(c, "4x4_k8") for c in POOL + HAND]
         + [(c, "3x3_k32") for c in POOL])


def game_fields(d: dict, g: int) -> dict:
    return {k: np.array(v[g]) for k, v in d.items()}


def launches(case, shape, seed=3):
    """The three kernels in turn on the case's tree: per launch and game,
    (before, after, wave, valid, chosen) as the benchmark keeps them."""
    from tak_tpu_torch.engine.core import Engine
    from tak_tpu_torch.mcts import tree_cases
    from tak_tpu_torch.mcts.search import EXPLORATION_BASE, EXPLORATION_INIT
    from tak_tpu_torch.mcts.tree import init_tree
    from tak_tpu_torch.mcts.tree_kernels import (Pending, backup_descend_wave,
                                                 expand_backup_wave)

    n, K = SHAPES[shape]
    engine = Engine(n)
    A = engine.num_actions
    M = tree_cases.pool_nodes(V)
    fields = tree_cases.hand_tree(case, 2, M, K, A, V, seed)
    in_flight = fields.pop("pending_leaves", None)
    tree = init_tree(engine, engine.initial_batch(2, device="cpu"), M, K)
    for f, a in fields.items():
        getattr(tree, f).copy_(torch.as_tensor(a))
    kw = dict(base=EXPLORATION_BASE, init=EXPLORATION_INIT, recycle=True)

    def snap():
        return {f: getattr(tree, f).clone().numpy() for f in ref_tree.FIELDS}

    def pending(leaves, s):
        p = tree_cases.hand_pending(np.asarray(leaves), K, A, s)
        return Pending(**{f: torch.as_tensor(a) for f, a in p.items()},
                       valid=1)

    out = []

    def run(fn, p, descend):
        before = snap()
        res = fn(tree, p, **(kw if descend else {"recycle": True}))
        after = snap()
        wave = {f: getattr(p, f).numpy() for f in ref_tree.PENDING}
        for g in range(2):
            chosen = None if res is None else {
                "leaves": res[0][g].numpy(), "created": res[1][g].numpy()}
            out.append((game_fields(before, g), game_fields(after, g),
                        game_fields(wave, g), bool(p.valid), chosen))
        return res

    if in_flight is not None and (in_flight != ref_tree.NONE).all():
        first = pending(in_flight, 4)
    else:
        first = Pending.zeros(2, V, K, "cpu")
    leaves, _ = run(backup_descend_wave, first, True)
    leaves, _ = run(backup_descend_wave, pending(leaves, 5), True)
    run(expand_backup_wave, pending(leaves, 6), False)
    return out


def wrong(samples):
    return [ref_tree.replay(*s, recycle=True) for s in samples]


@pytest.mark.parametrize("case,shape", CASES)
def test_replay_agrees(case, shape):
    samples = launches(case, shape)
    assert len(samples) == 6
    assert wrong(samples) == [0] * 6


def negated_exploration(monkeypatch):
    from tak_tpu_torch.mcts import tree_kernels

    real = tree_kernels._c_puct
    monkeypatch.setattr(tree_kernels, "_c_puct",
                        lambda n, base, init: -real(n, base, init))


def flipped_backup(monkeypatch):
    from tak_tpu_torch.mcts import tree_kernels

    real = tree_kernels._backup_plain

    def flipped(tree, pending, recycle):
        real(tree, tree_kernels.Pending(
            pending.leaves, pending.topk_vals, pending.topk_aidx,
            pending.results, -pending.values, pending.to_move,
            pending.valid), recycle)

    monkeypatch.setattr(tree_kernels, "_backup_plain", flipped)


def reversed_priors(monkeypatch):
    from tak_tpu_torch.mcts import tree_kernels

    real = tree_kernels._backup_plain

    def reversed_rows(tree, pending, recycle):
        real(tree, tree_kernels.Pending(
            pending.leaves, pending.topk_vals.flip(-1),
            pending.topk_aidx, pending.results, pending.values,
            pending.to_move, pending.valid), recycle)

    monkeypatch.setattr(tree_kernels, "_backup_plain", reversed_rows)


def attached_victim(monkeypatch):
    from tak_tpu_torch.mcts import tree_kernels

    real = tree_kernels._alloc

    def keep_links(tree, want, nf, cur, pair, recycle):
        saved = (tree.root_child.clone(), tree.edge_child.clone())
        out = real(tree, want, nf, cur, pair, recycle)
        tree.root_child.copy_(torch.where(saved[0] != -1, saved[0],
                                          tree.root_child))
        tree.edge_child.copy_(torch.where(saved[1] != -1, saved[1],
                                          tree.edge_child))
        return out

    monkeypatch.setattr(tree_kernels, "_alloc", keep_links)


FAULTS = [("merged_unpin", negated_exploration),
          ("shared_prefix", negated_exploration),
          ("merged_unpin", flipped_backup),
          ("dups_twice", flipped_backup),
          ("merged_unpin", reversed_priors),
          ("shared_prefix", reversed_priors),
          ("evict_parent", attached_victim),
          ("tied_keys", attached_victim)]


@pytest.mark.parametrize("case,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_replay_finds_a_broken_kernel(monkeypatch, case, fault):
    fault(monkeypatch)
    assert sum(wrong(launches(case, "4x4_k8"))) > 0
