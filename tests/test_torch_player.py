"""PyTorch port's single-game `Player` against the JAX package's.

Both players search the same game with the same rollouts and a fake
network whose outputs are exact in both frameworks.  On the CPU the JAX
player's "auto" backend is its XLA path, whose trees equal the fused
kernels' only up to node order, so each test swaps the JAX player's
search for one on the large-tree tier ("pallas_hbm", Pallas interpret
mode) before its first rollout; the port runs the plain PyTorch versions
of its CUDA kernels.  Trees, moves, debug tables, analysis text and
examples must then be exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tak_tpu.engine.core import get_engine as jax_engine
from tak_tpu.game import Game as JaxGame
from tak_tpu.mcts.search import MCTS as JaxMCTS
from tak_tpu.player import Player as JaxPlayer
from tak_tpu_torch.engine.core import get_engine
from tak_tpu_torch.game import Game
from tak_tpu_torch.mcts.search import MCTS
from tak_tpu_torch.player import Player
from tak_tpu_torch.types import FIELDS, ONGOING

from tests.test_torch_search import assert_trees_equal, exact_eval_pair


def on_large_tier(player, mcts_cls):
    """Swap a player's search onto the large-tree tier (test code only:
    `auto` picks it for the Player's default budget, not for the small
    pools of these tests, and on the CPU the JAX `auto` is its XLA path)."""
    player.mcts = mcts_cls(
        player.engine, player.mcts.eval_fn,
        dataclasses.replace(player.mcts.config, backend="pallas_hbm"))
    return player


def both_players(n, moves, jax_eval, torch_eval, params=(None, None), **kw):
    jp = on_large_tier(JaxPlayer(jax_engine(n), jax_eval, params[0],
                                 JaxGame.from_ptn_moves(n, moves, 4), **kw),
                       JaxMCTS)
    pp = on_large_tier(Player(get_engine(n), torch_eval, params[1],
                              Game.from_ptn_moves(n, moves, 4, device="cpu"),
                              **kw), MCTS)
    assert (jp.mcts._pallas_kind, pp.mcts.tier) == ("hbm", "hbm")
    return jp, pp


def assert_whole_trees_equal(jt, tt, msg):
    assert_trees_equal(jt, tt, msg)
    got = tt.state.to_numpy()
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jt.state, f)),
                                      err_msg=f"{msg}: state.{f}")


def test_player_matches_jax():
    """Two searched moves with tree reuse on 4x4 (wave 4, K=16, pool 256):
    root visits, the exploiting move, the debug table, the tree before and
    after each reroot, the annotated PTN and the examples."""
    n = 4
    jax_eval, torch_eval = exact_eval_pair(jax_engine(n).num_actions)
    jp, pp = both_players(n, ["a1", "d4", "b2"], jax_eval, torch_eval,
                          wave_size=4, max_children=16, node_budget=256,
                          save_examples=True, create_analysis=True)
    for move_no, waves in enumerate((6, 4)):
        assert pp.rollout(waves) == jp.rollout(waves) == 4 * waves
        assert pp.sims_done == jp.sims_done
        assert_whole_trees_equal(jp.tree, pp.tree, f"move {move_no} searched")
        np.testing.assert_array_equal(pp.tree.root_n.numpy(),
                                      np.asarray(jp.tree.root_n))
        mv = pp.pick_move(True)
        assert mv == jp.pick_move(True)
        assert pp.game.legal_mask()[mv]
        text = pp.debug().format(10)
        assert text == jp.debug().format(10)
        assert text.count("\n") > 5 and "|" in text
        before = int(pp.tree.root_n[0, mv])
        pp.play_move(mv)
        jp.play_move(mv)
        assert pp.game.ply == jp.game.ply and str(pp.game) == str(jp.game)
        assert_whole_trees_equal(jp.tree, pp.tree, f"move {move_no} rerooted")
        assert int(pp.tree.n0[0]) == before       # the carried visits
        assert int(pp.tree.next_free[0]) > 1      # a subtree was carried
    # a move played without search info, then the records
    pp.play_move("a4", with_info=False)
    jp.play_move("a4", with_info=False)
    want = str(jp.get_analysis())
    assert str(pp.get_analysis()) == want
    assert "{evaluation: " in want and "a4" in want
    assert pp.analysis.start_ply == jp.analysis.start_ply == 6
    jex, pex = jp.get_examples(1.0), pp.get_examples(1.0)
    assert len(pex) == len(jex) == 2 and pp.examples == []
    for je, pe in zip(jex, pex):
        assert pe.result == je.result
        np.testing.assert_array_equal(pe.actions, je.actions)
        np.testing.assert_array_equal(pe.visits, je.visits)
        assert sorted(pe.state) == sorted(je.state) == sorted(FIELDS)
        for f in FIELDS:
            np.testing.assert_array_equal(pe.state[f], je.state[f], err_msg=f)
            assert pe.state[f].dtype == je.state[f].dtype, f


def ones_eval_pair(num_actions):
    def jax_eval(params, states):
        b = states.ply.shape[0]
        return jnp.ones((b, num_actions), jnp.float32), jnp.zeros(b, jnp.float32)

    def torch_eval(params, states):
        b = states.ply.shape[0]
        return torch.ones((b, num_actions)), torch.zeros(b)

    return jax_eval, torch_eval


def test_player_reuse_win_in_two():
    """The case of tests/test_reuse.py:67: after c2 black must stop a road
    twice, with tree reuse across the moves (tests.rs:52-72).  The JAX
    player runs the same rollouts on its large-tree tier and must pick the
    same moves from the same visit counts."""
    n = 3
    jp, pp = both_players(n, ["a3", "c3", "c2"], *ones_eval_pair(
        get_engine(n).num_actions), wave_size=8, max_children=32,
        node_budget=4096)
    for _ in range(2):
        pp.rollout(125)
        jp.rollout(125)
        np.testing.assert_array_equal(pp.tree.root_n.numpy(),
                                      np.asarray(jp.tree.root_n))
        mv = pp.pick_move(True)
        assert mv == jp.pick_move(True)
        pp.play_move(mv)
        jp.play_move(mv)
        assert pp.game.result == ONGOING
    assert pp.tree is not None and int(pp.tree.n0[0]) > 0


def test_player_drops_oversized_carried_tree():
    """The case of tests/test_reuse.py:116: a re-rooted tree whose carried
    subtree would starve the next search's node pool is dropped, and the
    player searches on a fresh tree afterwards."""
    n = 3
    _, torch_eval = ones_eval_pair(get_engine(n).num_actions)
    player = Player(get_engine(n), torch_eval, None,
                    Game.with_komi(n, 0, "cpu"), wave_size=8, node_budget=24)
    for mv in ("a1", "c3"):
        player.play_move(mv, with_info=False)
    assert player.tree is None            # nothing searched yet
    player.rollout()
    mv = player.pick_move(True)
    orig = player._reroot
    player._reroot = lambda t, a, s: orig(t, a, s).replace(
        next_free=torch.full_like(t.next_free, 20))
    player.play_move(mv, with_info=False)
    assert player.tree is None            # oversized carry dropped
    player._reroot = orig
    player.rollout()
    assert int(player.tree.n0[0]) == 1 + 8
    # a small carry is kept
    player.play_move(player.pick_move(True), with_info=False)
    assert player.tree is not None
    assert int(player.tree.next_free[0]) <= 12


def test_player_random_draws_use_the_generator():
    """`add_noise` and the sampled move draw from the player's
    torch.Generator: the same seed gives the same noise and move, the
    noise keeps the prior a distribution over the legal moves."""
    n = 4
    _, torch_eval = exact_eval_pair(get_engine(n).num_actions)
    picks, priors = [], []
    for seed in (5, 5, 6):
        player = Player(get_engine(n), torch_eval, None,
                        Game.with_komi(n, 2, "cpu"), wave_size=4,
                        max_children=16, node_budget=64,
                        generator=torch.Generator().manual_seed(seed))
        player.rollout()
        clean = player.tree.root_prior.clone()
        player.add_noise(0.2, 0.3)
        prior = player.tree.root_prior
        legal = player.tree.root_legal
        assert not torch.equal(prior, clean)
        assert torch.equal(prior[~legal], clean[~legal])
        torch.testing.assert_close(
            prior[legal].sum(), 0.3 + 0.7 * clean[legal].sum(),
            rtol=1e-5, atol=1e-6)
        player.rollout(3)
        picks.append(player.pick_move(False))
        priors.append(prior.clone())
        assert player.game.legal_mask()[picks[-1]]
    assert picks[0] == picks[1] and torch.equal(priors[0], priors[1])
    assert not torch.equal(priors[0], priors[2])


def test_weights_file_to_player_move(tmp_path):
    """The slice as a whole: a weights file written by the JAX package's
    `Network.save`, read by the port's `load_variables`, Net at 2 blocks x
    16 filters in float32 on 4x4, one Player move in each package (24
    rollouts, wave 4, both on the large-tree tier).  The root policy agrees
    as log-probabilities to atol 1e-4 (float32 convolutions summed in
    another order; a typical probability is about 1/A, so the bound is
    taken on the logarithm), and the picked move is the same."""
    from tak_tpu.model.network import Network as JaxNetwork
    from tak_tpu.model.resnet import NetConfig as JaxNetConfig
    from tak_tpu_torch.model.network import Network
    from tak_tpu_torch.model.resnet import NetConfig
    from tak_tpu_torch.utils.checkpoint import load_variables

    n = 4
    jnet = JaxNetwork(jax_engine(n), JaxNetConfig(n=n, filters=16, blocks=2,
                                                  dtype=jnp.float32))
    variables = jnet.init_variables(11)
    rng = np.random.default_rng(1)
    variables = {               # non-trivial BatchNorm statistics
        "params": jax.tree.map(
            lambda x: x + rng.normal(0, 0.05, x.shape).astype(np.float32),
            variables["params"]),
        "batch_stats": jax.tree.map(
            lambda x: jnp.abs(x + rng.normal(0.2, 0.1, x.shape)
                              .astype(np.float32)),
            variables["batch_stats"]),
    }
    path = str(tmp_path / "net.model")
    jnet.save(variables, path)

    cfg = NetConfig(n=n, filters=16, blocks=2, dtype=torch.float32)
    net = Network(get_engine(n), cfg, device="cpu")
    loaded = net.load(path)
    assert loaded.keys() == load_variables(path, cfg).keys()
    assert loaded["stem.weight"].shape == (16, loaded["stem.weight"].shape[1],
                                           3, 3)

    jp, pp = both_players(
        n, ["a1", "d4", "c2"],
        lambda p, s: jnet.policy_eval_states(p, s),
        lambda p, s: net.policy_eval_states(p, s),
        params=(variables, loaded), wave_size=4, max_children=16,
        node_budget=128)
    pp.rollout(6)
    jp.rollout(6)
    legal = pp.tree.root_legal[0].numpy()
    np.testing.assert_array_equal(legal, np.asarray(jp.tree.root_legal[0]))
    assert (pp.tree.root_prior[0].numpy()[legal] > 0).all()
    np.testing.assert_allclose(
        np.log(pp.tree.root_prior[0].numpy()[legal]),
        np.log(np.asarray(jp.tree.root_prior[0])[legal]), atol=1e-4, rtol=0)
    assert int(pp.tree.n0[0]) == int(jp.tree.n0[0]) == 25
    assert pp.pick_move(True) == jp.pick_move(True)
