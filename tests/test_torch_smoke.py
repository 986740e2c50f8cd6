"""`chip_smoke.py` on the CPU: its table of phases, and the large tier's
bound that it prints, on a tree that tree reuse carried in.  Importing the
script needs no card."""

import re

import pytest
import torch

import chip_smoke
from tak_tpu_torch.engine.core import get_engine
from tak_tpu_torch.game import Game
from tak_tpu_torch.mcts.tree_kernels_hbm import (
    descend_wave_hbm_plain,
    expand_backup_wave_hbm_plain,
)
from tak_tpu_torch.model.network import Network
from tak_tpu_torch.model.resnet import NetConfig
from tak_tpu_torch.player import Player

LABELS = [label for label, _ in chip_smoke.PHASES]


def test_labels_are_unique_and_in_the_docstrings_order():
    listed = " ".join(re.findall(r"^ {4}((?:\d[a-z]? ?)+)$",
                                 chip_smoke.__doc__, re.M)).split()
    assert len(set(LABELS)) == len(LABELS)
    assert LABELS == listed


@pytest.mark.parametrize("labels, want", [
    ([], LABELS),
    (["6x", "6e"], ["6e", "6x"]),
    (["6w", "3a", "6w"], ["3a", "6w"]),
    (["6e", "7z"], None),
])
def test_select(labels, want):
    if want is None:
        with pytest.raises(ValueError) as raised:
            chip_smoke.select(labels)
        assert "7z" in str(raised.value)
        assert str(raised.value).endswith(" ".join(LABELS))
        return
    chosen = chip_smoke.select(labels)
    assert [label for label, _ in chosen] == want
    assert all(run is dict(chip_smoke.PHASES)[label] for label, run in chosen)


def test_large_tier_bound_on_a_rerooted_tree_is_positive():
    """A 4x4 Player tree grown by the plain large-tier waves, re-rooted by
    three played moves, then one descend and one expand+backup wave: the
    backup's visit counts summed over the tree go down (created nodes
    take slots whose stale counts the reroot left), yet the bounds that
    the smoke prints for #8 and #9 stay positive."""
    n, V = 4, 16
    engine = get_engine(n)
    net = Network(engine, NetConfig(n=n, filters=16, blocks=1,
                                    dtype=torch.float32), device="cpu")
    params = net.init_variables(0)
    player = Player(engine, net.policy_eval_states, params,
                    Game.with_komi(n, 2, "cpu"), wave_size=V,
                    max_children=32, node_budget=4096,
                    generator=torch.Generator().manual_seed(0))
    assert player.mcts.tier == "hbm"
    for _ in range(3):
        player.rollout(20)
        player.play_move(player.pick_move(True))
    player._ensure_tree()
    cfg = player.mcts.config
    before = player.tree.clone()
    descended = before.clone()
    leaves, created = descend_wave_hbm_plain(
        descended, V, base=float(cfg.exploration_base),
        init=float(cfg.exploration_init))
    pending = player.mcts._eval_and_topk(params, descended, leaves, created)
    backed = descended.clone()
    expand_backup_wave_hbm_plain(backed, pending)

    summed = int((backed.edge_n - descended.edge_n).sum()
                 + (backed.root_n - descended.root_n).sum())
    assert summed < 0
    for start, end, descend in ((before, descended, True),
                                (descended, backed, False)):
        ms, by = chip_smoke.hbm_bound(start, end, V, descend)
        assert ms > 0 and by in ("bytes", "operations")
