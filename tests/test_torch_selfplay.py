"""PyTorch port's SelfPlayActor against `tak_tpu.selfplay.SelfPlayActor`.

n=4, 2 lockstep games, 32 sims per move, wave 4, K=8, recycling on a
24-node pool with tree reuse, no root noise and greedy moves, 3 searched
moves per game (max_plies=5 after the 2 forced opening plies).  Both
sides use the same deterministic fake network (exact on both sides, see
`tests/test_torch_search.exact_eval_pair`); the JAX side runs its Pallas
kernels in interpret mode.  Actions and root visit counts must match.
"""

import numpy as np

from tak_tpu.engine.core import get_engine as jax_engine
from tak_tpu.mcts.search import SearchConfig as JaxSearchConfig
from tak_tpu.selfplay import SelfPlayActor as JaxSelfPlayActor
from tak_tpu.selfplay import SelfPlayConfig as JaxSelfPlayConfig
from tak_tpu_torch.engine.core import Engine
from tak_tpu_torch.mcts.search import SearchConfig
from tak_tpu_torch.selfplay import SelfPlayActor, SelfPlayConfig

from tests.test_torch_search import exact_eval_pair


def test_selfplay_matches_jax():
    n = 4
    search = dict(num_sims=32, wave_size=4, max_children=8, node_budget=24,
                  recycle=True)
    play = dict(games=2, workers=2, noise_plies=0, exploit_plies=0,
                max_plies=5)
    jax_eval, torch_eval = exact_eval_pair(Engine(n).num_actions)

    jactor = JaxSelfPlayActor(
        jax_engine(n), jax_eval,
        JaxSelfPlayConfig(search=JaxSearchConfig(backend="pallas", **search),
                          **play))
    want = jactor.run(None, seed=3, log=lambda *_: None)

    actor = SelfPlayActor(Engine(n), torch_eval,
                          SelfPlayConfig(search=SearchConfig(**search), **play),
                          device="cpu")
    got = actor.run(None, seed=3, log=lambda *_: None)

    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.actions, w.actions)
        np.testing.assert_array_equal(g.visits, w.visits)
        assert g.result == w.result
        for k, v in w.state.items():
            np.testing.assert_array_equal(g.state[k], v, err_msg=k)
    # every searched root spent the whole budget on legal children
    assert all(int(g.visits.sum()) >= 32 for g in got)
