"""The port's self-play modes against `tak_tpu.selfplay`: Gumbel training
targets and sequential quad-rollout self-play, on the CPU.

* Gumbel: on one searched tree (the JAX search's own Gumbel sample fed to
  the port, `exact_eval_pair` on both sides, so the trees are equal), the
  port's targets round(gumbel_policy_weights * 65535) equal those of the
  JAX move bundle (its sparse top-K read) and of its dense overflow read,
  exactly.
* Quad rollouts (`quad_rollout_plies`, workers=1): a whole self-play
  game on the "xla" path of both packages gives the same examples
  exactly, early moves carrying 4x the visits; the mirror of
  `tests/test_selfplay.py::test_quad_rollout_sequential`; the command
  line's `--quad-rollout-plies`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tak_tpu.engine.core import get_engine as jax_engine
from tak_tpu.mcts.search import SearchConfig as JaxSearchConfig
from tak_tpu.selfplay import SelfPlayActor as JaxSelfPlayActor
from tak_tpu.selfplay import SelfPlayConfig as JaxSelfPlayConfig
from tak_tpu_torch.engine.core import Engine
from tak_tpu_torch.mcts.search import SearchConfig
from tak_tpu_torch.selfplay import SelfPlayActor, SelfPlayConfig
from tak_tpu_torch.types import GameState

from tests.test_torch_search import exact_eval_pair, start_states
from tests.test_torch_train import one_torch_thread  # noqa: F401


def test_gumbel_targets_equal_jax_move_bundle():
    n, B = 4, 2
    search = dict(num_sims=48, wave_size=4, max_children=8, gumbel_m=16)
    jax_eval, torch_eval = exact_eval_pair(Engine(n).num_actions)
    jactor = JaxSelfPlayActor(jax_engine(n), jax_eval, JaxSelfPlayConfig(
        games=B, workers=B, search=JaxSearchConfig(**search)))
    states = start_states(n, ["a4", "d4", "b2"], B)
    jm = jactor.mcts
    jt, g = jm.run_sims_gumbel(None, jm.prepare_root(None, jm.init_batch(
        states)), jax.random.PRNGKey(11))
    actions = jm.select_moves_gumbel(jt, g)
    out = jax.device_get(jactor._move_bundle(jt, states, actions,
                                             jnp.ones(B, bool)))
    vals, idx, nnz = out[2], out[3], out[4]
    dense = np.asarray(jactor._dense_visits_i32(jt))

    actor = SelfPlayActor(Engine(n), torch_eval, SelfPlayConfig(
        games=B, workers=B, search=SearchConfig(**search)), device="cpu")
    tm = actor.mcts
    tt = tm.prepare_root(None, tm.init_batch(GameState.from_numpy(states)))
    tt = tm._run_sims_gumbel(None, tt, torch.as_tensor(np.array(g)))
    got = actor._root_targets(tt).numpy()
    np.testing.assert_array_equal(got, dense)
    for i in range(B):
        sparse = np.zeros_like(got[i])
        keep = vals[i] > 0
        sparse[idx[i][keep]] = vals[i][keep]
        np.testing.assert_array_equal(got[i], sparse)
        assert int(nnz[i]) == int((got[i] > 0).sum())
        # targets sum to 65535 within the rounding of each legal entry
        legal = int(tt.root_legal[i].sum())
        assert abs(int(got[i].sum()) - 65535) <= legal / 2 + 1


def test_gumbel_selfplay_runs():
    """A Gumbel self-play generation on the port: legal examples whose
    targets sum to 65535 within rounding, no root noise drawn."""
    n = 3
    engine = Engine(n)
    _, torch_eval = exact_eval_pair(engine.num_actions)
    actor = SelfPlayActor(engine, torch_eval, SelfPlayConfig(
        games=2, workers=2, max_plies=8,
        search=SearchConfig(num_sims=16, wave_size=4, max_children=16,
                            gumbel_m=8)), device="cpu")
    assert actor.mcts.tier == "xla"
    actor.mcts.add_noise = None     # Gumbel mode must not call it
    examples = actor.run(None, seed=2, log=lambda m: None)
    assert examples
    for ex in examples:
        if ex.visits.max() == 1000:     # an instant-win example
            continue
        assert abs(int(ex.visits.sum()) - 65535) <= len(ex.visits) / 2 + 1
        legal = engine.legal_mask(GameState.from_numpy(
            {k: v[None] for k, v in ex.state.items()}))[0].numpy()
        assert legal[ex.actions].all()


def quad_play(n=3, **over):
    search = dict(num_sims=24, wave_size=4, max_children=16, backend="xla")
    play = dict(games=1, workers=1, komi=0, noise_plies=0, exploit_plies=0,
                instant_win_scan=False, quad_rollout_plies=6, max_plies=10)
    play.update(over)
    return search, play


def test_quad_selfplay_equals_jax():
    n = 3
    search, play = quad_play(n)
    jax_eval, torch_eval = exact_eval_pair(Engine(n).num_actions)
    want = JaxSelfPlayActor(jax_engine(n), jax_eval, JaxSelfPlayConfig(
        search=JaxSearchConfig(**search), **play)).run(
        None, seed=3, log=lambda m: None)
    actor = SelfPlayActor(Engine(n), torch_eval, SelfPlayConfig(
        search=SearchConfig(**search), **play), device="cpu")
    assert actor.search_config.node_budget == 4 * 24 * 2 + 2
    got = actor.run(None, seed=3, log=lambda m: None)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.actions, w.actions)
        np.testing.assert_array_equal(g.visits, w.visits)
        assert g.result == w.result
    sims = [s for _, s in actor.move_times]
    plies = [int(ex.state["ply"]) for ex in got]
    assert sims == [96 if p < 6 else 24 for p in plies]


def test_quad_rollout_sequential():
    """Mirror of `tests/test_selfplay.py::test_quad_rollout_sequential` on
    the port (pool tier): early-move examples carry about 4x the visits of
    late ones; workers=2 is refused."""
    engine = Engine(3)
    A = engine.num_actions

    def uniform(params, states):
        b = states.ply.shape[0]
        return torch.ones((b, A)), torch.zeros(b)

    search, play = quad_play(max_plies=400)
    search.pop("backend")
    actor = SelfPlayActor(engine, uniform, SelfPlayConfig(
        search=SearchConfig(**search), **play), device="cpu")
    assert actor.mcts.tier == "pool"
    examples = actor.run(None, seed=3, log=lambda m: None)
    early = [int(ex.visits.sum()) for ex in examples
             if int(ex.state["ply"]) < 6]
    late = [int(ex.visits.sum()) for ex in examples
            if int(ex.state["ply"]) >= 6]
    assert early and late, "game ended before/inside quad window"
    assert min(early) >= 4 * 24 - 8, early
    assert np.mean(early) > 3 * np.mean(late), (early, late)
    with pytest.raises(ValueError):
        SelfPlayActor(engine, uniform, SelfPlayConfig(
            workers=2, quad_rollout_plies=6), device="cpu")


def test_train_cli_quad_rollout_plies(tmp_path, capsys):
    """`cli.train --quad-rollout-plies 4 --workers 1 --cpu` plays a
    generation with quadrupled opening searches."""
    from tak_tpu_torch.cli import train as train_cli

    train_cli.main([
        "random", "--size", "3", "--games", "1", "--workers", "1",
        "--rollouts", "8", "--wave", "4", "--k", "16", "--pit-games", "2",
        "--pit-rollouts", "8", "--filters", "8", "--blocks", "1",
        "--quad-rollout-plies", "4", "--generations", "1", "--cpu",
        "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "self-play: 1 games" in out
    assert len(list((tmp_path / "_examples").iterdir())) == 1
