"""The port's native binding (`tak_tpu_torch.native`) against the port's
engine, mirroring `tests/test_native_parity.py`: seeded playouts agree
move for move on the legal actions (in the reference's possible_moves
order), the result and the reserves, and a deep-stack position agrees on
every stack level.  Exact equality throughout."""

import numpy as np
import pytest

from tak_tpu_torch import native
from tak_tpu_torch.game import Game
from tak_tpu_torch.types import ONGOING

if not native.available():
    pytest.skip("takcore native library unavailable", allow_module_level=True)

SEEDS = [5915587277, 1500450271, 3267000013, 4093082899, 2860486313]


@pytest.mark.parametrize("n", [5, 6])
@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_playout_parity(n, seed):
    game = Game(n, device="cpu")
    nat = native.NativeGame(n)
    ply = 0
    while game.result == ONGOING and ply < 500:
        acts = game.legal_actions()
        assert np.array_equal(acts, nat.legal_actions()), f"ply {ply}"
        a = int(acts[seed % len(acts)])
        game.play_action(a, check=False)
        nat.play_action(a)
        assert game.result == nat.result, f"ply {ply} action {a}"
        s = game.state
        assert (int(s.stones[0, 0]), int(s.caps[0, 0]), int(s.stones[0, 1]),
                int(s.caps[0, 1])) == nat.reserves(), f"ply {ply}"
        ply += 1
    assert nat.result == game.result
    assert nat.ply == game.ply


def test_board_contents_parity():
    """Deep-stack position: every stack color level must agree."""
    moves = ["c4", "c2", "d2", "c3", "b2", "d3", "1d2+", "b3", "d2", "b4",
             "1c2+", "1b3>", "2d3<", "1c4-", "d4", "5c3<23", "c2", "c4"]
    game = Game.from_ptn_moves(5, moves, device="cpu")
    nat = native.NativeGame(5)
    for m in moves:
        nat.play_action(game.engine.tables.ptn_to_action(m))
    heights, tops, colors = nat.board_arrays()
    assert np.array_equal(game.state.heights[0].numpy(), heights)
    assert np.array_equal(game.state.tops[0].numpy(), tops)
    stacks = game.state.stacks[0].numpy()
    for s in range(25):
        for h in range(heights[s]):
            assert (int(stacks[s, h // 32]) >> (h % 32)) & 1 == colors[s][h]


def test_library_in_use_is_committed_or_port_built():
    """The binding runs the committed library, or one it built into the
    port's build directory; it never writes into `native/`."""
    assert native.LIB_PATH in (native.COMMITTED_LIB, native.BUILT_LIB)
    clone = native.NativeGame(6)
    clone.play_action(0)
    assert clone.clone().ply == 1 and clone.to_move == 1
