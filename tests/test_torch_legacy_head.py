"""The port's dense (legacy Net5) policy head against the JAX package's.

5x5, 1,575 legacy moves; narrow nets (8-16 filters, 1-2 blocks) in
float32 on both sides, weights from a flax init carried over by
`variables_from_numpy`.  Tolerances: the forward's log-probabilities and
value to atol 1e-4 (float32 matrix products summed in another order); a
`Network.train` call against the JAX package's in float64: the loss parts
to rtol 1e-5, every parameter and batch statistic to atol 1e-6 (in
float32, the conv biases a BatchNorm follows within 2 lr a step), as in
`tests/test_torch_train.py`; the symmetry tables and weights files
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tak_tpu.engine.core import Engine as JaxEngine
from tak_tpu.engine.observe import observe as jax_observe
from tak_tpu.examples import Example as JaxExample
from tak_tpu.model.network import LEARNING_RATE
from tak_tpu.model.network import Network as JaxNetwork
from tak_tpu.model.resnet import NetConfig as JaxNetConfig
from tak_tpu_torch.engine.core import Engine
from tak_tpu_torch.examples import Example
from tak_tpu_torch.game import Game
from tak_tpu_torch.mcts.search import MCTS, SearchConfig
from tak_tpu_torch.model.network import (
    Network,
    config_of,
    variables_from_numpy,
    variables_to_numpy,
)
from tak_tpu_torch.model.resnet import NetConfig
from tak_tpu_torch.sizes import legacy_action_space
from tak_tpu_torch.types import GameState

from tests.test_torch_network import playout_states
from tests.test_torch_train import (
    _bn_follows,
    _examples,
    _leaves,
    _start_variables,
    one_torch_thread,  # noqa: F401  (autouse fixture)
)

N = 5


def dense_configs(filters, blocks):
    return (JaxNetConfig(n=N, filters=filters, blocks=blocks,
                         policy_head="dense", dtype=jnp.float32),
            NetConfig(n=N, filters=filters, blocks=blocks,
                      policy_head="dense", dtype=torch.float32))


@pytest.mark.parametrize("n", [4, 5, 6])
def test_legacy_tables_equal(n):
    """The legacy move list and its D4 tables equal the JAX package's."""
    want, got = JaxEngine(n).tables, Engine(n).tables
    assert len(got.legacy_actions) == legacy_action_space(n)
    for f in ("legacy_actions", "legacy_index", "legacy_sym_action",
              "legacy_sym_action_inv"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def test_dense_forward_matches_flax():
    """2 blocks x 16 filters in float32, BatchNorm statistics perturbed:
    the scattered softmax (as log-probabilities on the legacy moves, 0
    exactly elsewhere) and the value within atol 1e-4 of flax's."""
    jcfg, tcfg = dense_configs(16, 2)
    jnet = JaxNetwork(JaxEngine(N), jcfg)
    v = _start_variables(jnet)
    je, js = playout_states(N, 8, 20, seed=4)
    planes = np.asarray(jax.vmap(lambda s: jax_observe(je, s))(js))
    want_p, want_v = jax.device_get(jnet.policy_eval(
        jax.tree.map(jnp.asarray, v), jnp.asarray(planes)))

    net = Network(Engine(N), tcfg, device="cpu")
    sd = variables_from_numpy(v["params"], v["batch_stats"], tcfg)
    assert config_of(sd) == NetConfig(n=N, filters=16, blocks=2,
                                      policy_head="dense")
    got_p, got_v = net.policy_eval(sd, torch.as_tensor(planes.copy()))
    got_p = got_p.numpy()
    legacy = np.asarray(je.tables.legacy_actions)
    off = np.ones(je.num_actions, bool)
    off[legacy] = False
    assert (got_p[:, off] == 0).all() and (want_p[:, off] == 0).all()
    np.testing.assert_allclose(np.log(got_p[:, legacy]),
                               np.log(want_p[:, legacy]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_v.numpy(), want_v, atol=1e-4, rtol=0)


def test_dense_head_scatters_to_channel_space():
    """Mirror of `tests/test_legacy_head.py`: mass only on the legacy
    moves, summing to 1, at the channel scheme's width."""
    engine = Engine(N)
    net = Network(engine, NetConfig(n=N, filters=8, blocks=1,
                                    policy_head="dense"), device="cpu")
    v = net.init_variables(0)
    g = Game.from_ptn_moves(N, ["a1", "e5"], device="cpu")
    probs, value = net.policy_eval_states(v, g.state)
    assert probs.shape == (1, engine.num_actions) and value.shape == (1,)
    mask = np.zeros(engine.num_actions, bool)
    mask[engine.tables.legacy_actions] = True
    p = probs[0].numpy()
    assert abs(p.sum() - 1.0) < 1e-5
    assert p[~mask].sum() == 0.0


def test_dense_train_matches_jax():
    """One `Network.train` call (48 examples, chunks of 16, 2 a step: a
    step and the trailing flush) with the dense head, same examples,
    weights and shuffle, against the JAX package's run in float64 (x64):
    the port's float64 and float32 runs, with the tolerances of
    `tests/test_torch_train.py`: the loss parts of every chunk to rtol
    1e-5, every parameter and batch statistic to atol 1e-6, every entry
    of the legacy policy head included.  Only in float32 do the conv
    biases that a BatchNorm follows (`_bn_follows`, a gradient of zero up
    to rounding) get 2 lr a step, and the running mean after one 1% of
    that difference a chunk after the first step.

    The reference is the float64 run because on these weights the JAX
    package's own float32 run strays from it: its first step's summed
    trunk gradients differ from its float64 ones far beyond rounding
    (some 1e-3), and Adam turns that into steps that differ by up to a
    fifth of lr, while the port's float32 run stays within float32
    rounding of the float64 one (held here)."""
    exs = _examples()
    jparts = []
    with jax.enable_x64():
        jcfg = JaxNetConfig(n=N, filters=8, blocks=1, policy_head="dense",
                            dtype=jnp.float64)
        jnet = JaxNetwork(JaxEngine(N), jcfg)
        v0 = _start_variables(jnet)
        orig = jnet._accum_chunk

        def jrec(*a):
            out = orig(*a)
            jparts.append(tuple(float(x) for x in out[2:4]))
            return out

        jnet._accum_chunk = jrec
        want = jax.device_get(jnet.train(
            jax.tree.map(jnp.asarray, v0), [JaxExample(**e) for e in exs],
            rng=np.random.default_rng(5), chunk_size=16, chunks_in_step=2,
            log=lambda m: None))
    steps, late_chunks = 2, 1
    w, s = _leaves(want["params"]), _leaves(v0["params"])
    ws = _leaves(want["batch_stats"])
    assert "['Dense_1']['kernel']" in w and len(jparts) == 3

    for dtype in (torch.float64, torch.float32):
        tcfg = NetConfig(n=N, filters=8, blocks=1, policy_head="dense",
                         dtype=dtype)
        net = Network(Engine(N), tcfg, device="cpu")
        tparts = []
        torig = net._accum_chunk

        def trec(*a, torig=torig, tparts=tparts):
            out = torig(*a)
            tparts.append(tuple(float(x) for x in out))
            return out

        net._accum_chunk = trec
        got = variables_to_numpy(net.train(
            variables_from_numpy(v0["params"], v0["batch_stats"], tcfg),
            [Example(**e) for e in exs], rng=np.random.default_rng(5),
            chunk_size=16, chunks_in_step=2, log=lambda m: None))
        np.testing.assert_allclose(tparts, jparts, rtol=1e-5,
                                   err_msg=str(dtype))
        g = _leaves(got["params"])
        assert w.keys() == g.keys()
        noisy = dtype == torch.float32
        for k in w:
            tol = 2 * LEARNING_RATE * steps if noisy and _bn_follows(k) \
                else 1e-6
            np.testing.assert_allclose(g[k], w[k], atol=tol, rtol=0,
                                       err_msg=f"{dtype} {k}")
            assert np.abs(g[k] - s[k]).max() > 0, f"{k} did not move"
        bias_diff = {k: np.abs(g[k] - w[k]) for k in w if _bn_follows(k)}
        gs = _leaves(got["batch_stats"])
        for k in ws:
            tol = 1e-6
            if noisy and k.endswith("['mean']"):
                bias = k.replace("BatchNorm", "Conv").replace("['mean']",
                                                              "['bias']")
                tol = tol + 0.01 * late_chunks * bias_diff[bias]
            assert (np.abs(gs[k] - ws[k]) <= tol).all(), (dtype, k)


def test_dense_weights_files_read_both_ways(tmp_path):
    """A dense net's weights file written by the JAX package loads in the
    port, and the port's file loads in the JAX package, exactly."""
    from tak_tpu_torch.utils.checkpoint import load_variables, save_variables

    jcfg, tcfg = dense_configs(8, 1)
    jnet = JaxNetwork(JaxEngine(N), jcfg)
    v = _start_variables(jnet)
    path = tmp_path / "jax.model"
    jnet.save(jax.tree.map(jnp.asarray, v), str(path))
    got = load_variables(str(path), tcfg)
    want = variables_from_numpy(v["params"], v["batch_stats"], tcfg)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k

    back = tmp_path / "port.model"
    save_variables(str(back), got)
    assert back.read_bytes() == path.read_bytes()
    loaded = jax.device_get(jnet.load(str(back)))
    for k, x in _leaves(v).items():
        np.testing.assert_array_equal(_leaves(loaded)[k], x, err_msg=k)


def test_dense_head_search_and_train():
    """Mirror of `tests/test_legacy_head.py::test_dense_head_search_and_train`
    on the port: a pool-tier search through the dense head counts its
    rollouts, and a train call moves every parameter."""
    engine = Engine(N)
    net = Network(engine, NetConfig(n=N, filters=8, blocks=1,
                                    policy_head="dense"), device="cpu")
    v = net.init_variables(0)
    mcts = MCTS(engine, net.policy_eval_states,
                SearchConfig(num_sims=16, wave_size=4, max_children=32))
    assert mcts.tier == "pool"
    g = Game.from_ptn_moves(N, ["a1", "e5"], device="cpu")
    tree = mcts.init_batch(g.state)
    tree = mcts.run_sims(v, mcts.prepare_root(v, tree))
    assert int(tree.n0[0]) == 17

    rng = np.random.default_rng(0)
    state = {f: x[0] for f, x in GameState.to_numpy(g.state).items()}
    exs = [Example(state=state,
                   actions=np.sort(rng.choice(engine.tables.legacy_actions,
                                              4, replace=False)).astype(np.int32),
                   visits=rng.integers(1, 9, 4).astype(np.int32), result=1.0)
           for _ in range(20)]
    v2 = net.train(v, exs, rng=np.random.default_rng(1), chunk_size=10,
                   chunks_in_step=1, log=lambda m: None)
    moved = [k for k in v if v[k].is_floating_point()
             and not torch.equal(v[k], v2[k])]
    assert "policy.weight" in moved and "value.weight" in moved
